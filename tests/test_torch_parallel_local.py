"""Port parity: a sharded batch's pointwise stages stay on each rank's
region (Noise, BiasField, Gamma, Clamp, Flip, RescaleIntensity,
ZNormalization, Mask, and the "mean"/"otsu" fills), on 4 gloo ranks
against the JAX package on 4 virtual CPU devices in the same (2, 2)
layout (see ``tests/test_torch_parallel.py`` for the pool and the
collective spy).

Each recipe runs fused and unfused, on the whole batch and on the batch
sharded over B and over B and J, with per-instance gating where the
transform has it. Each port result is held against the JAX package's
unsharded and sharded results at the JAX tests' 1e-5, its history and
the next host draw against the JAX package's, and against the port's own
unsharded call: the draws, Flip, the rescales and the masks bit for bit,
the statistics within 1e-5. The spy holds the collectives to the JAX
package's partitioned programs: no gather for Noise, BiasField, Gamma,
Clamp, Flip, ZNormalization and Mask (the statistics take ``all_reduce``
and ``broadcast``, Flip along J one ``batch_isend_irecv``), and for
RescaleIntensity's percentiles over J one gather of one element, on the
ranks that hold element 0.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax
import jax.numpy as jnp

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import RankPool, local_recipe
from test_torch_zoo_spatial import history, history_close

WORLD = 4
ATOL = RTOL = 1e-5
#: (B, C, I, J, K): J = 14 over 2 ranks gives a run of 7 K = 35 counters,
#: not a multiple of the kernel's vectors of 4
SHAPE = (4, 2, 6, 14, 5)
ELEMENT = math.prod(SHAPE[1:])
#: rank r of the (2, 2) mesh holds element 0 where its data coordinate is 0
HOLDERS = (0, 1)
#: recipes whose sharded run equals the unsharded one bit for bit
EXACT = ("noise", "rician", "bias", "bias-shared", "bias-noise", "gamma", "clamp", "flip",
         "flip-shared", "mask", "rescale", "rescale-pct", "rescale-seg")
#: recipes with no collective at all, sharded either way
NO_COLLECTIVE = ("noise", "rician", "bias", "bias-shared", "bias-noise", "gamma", "clamp")


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(WORLD)
    yield ranks
    ranks.close()


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    t1 = (rng.random(SHAPE, np.float32) * 2.0 - 0.5).astype(np.float32)
    seg = rng.integers(0, 4, (SHAPE[0], 1, *SHAPE[2:])).astype(np.int32)
    return {"t1": t1, "seg": seg}, {"seg": "label"}


def jax_batch(images, classes):
    from torchio_tpu.data.batch import SubjectsBatch

    subjects = []
    for e in range(next(iter(images.values())).shape[0]):
        subjects.append(tj.Subject(**{
            name: (tj.LabelMap if classes.get(name) == "label" else tj.ScalarImage)(arr[e])
            for name, arr in images.items()
        }))
    batch = SubjectsBatch.from_subjects(subjects)
    for ib in batch.images.values():
        ib.data = jnp.asarray(ib.data)
    return batch


def run_jax(recipe, images, classes, seed, fuse, layout):
    from torchio_tpu.parallel.mesh import make_mesh

    batch = jax_batch(images, classes)
    if layout is not None:
        batch.shard_(make_mesh(jax.devices()[:WORLD]), spatial=layout == "BJ")
    tj.seed(seed)
    out = tj.Compose(local_recipe(tj, recipe), fuse=fuse)(batch)
    return {
        "images": {n: np.asarray(ib.data) for n, ib in out.images.items()},
        "history": history(out),
        "draw": float(tj.random.random()),
    }


def face_elements() -> int:
    """The elements of the fills' one gather over J on a (2, 2) mesh: each
    of the 2 ranks of a row's J columns sends its rows' pieces of the I
    and K faces and one J face (its end), padded to the same size."""
    b, c, si, sj, sk = SHAPE
    jl = sj // 2
    return 2 * (b // 2) * c * (2 * jl * sk + si * sk + 2 * si * jl)


def assert_spy(recipe, layout, rank, spy):
    """The collectives of one rank's sharded call, as the JAX package's
    partitioned program has them."""
    if recipe in NO_COLLECTIVE:
        assert spy == {"gathers": [], "gather_elements": [], "all_reduce": [], "broadcast": [],
                       "p2p": []}, (recipe, layout, rank, spy)
        return
    if recipe in ("flip", "flip-shared"):
        assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == []
        # along J, for each of t1 and seg: the mirror rank's columns, one
        # send and one receive, where an element of the rank's rows flips J
        # (every element of the shared Flip does)
        if layout == "B":
            assert spy["p2p"] == []
        elif recipe == "flip-shared":
            assert spy["p2p"] == [2, 2], (recipe, layout, rank, spy)
        else:
            assert spy["p2p"] in ([], [2, 2]), (recipe, layout, rank, spy)
        return
    if recipe in ("fill-mean", "fill-otsu"):
        if layout == "BJ":  # only the faces' pieces of the rank's rows
            assert spy["gathers"] == ["all_gather"], spy
            assert spy["gather_elements"] == [face_elements()], spy
        return
    assert spy["p2p"] == []
    if recipe in ("rescale-pct", "rescale-seg") and layout == "BJ" and rank in HOLDERS:
        # element 0's J columns, once, on the ranks that hold it
        assert spy["gathers"] == ["all_gather"], spy
        assert spy["gather_elements"] == [ELEMENT], spy
    else:
        assert spy["gathers"] == [], (recipe, layout, rank, spy)
    # the statistic's pair or triple (and a mask's columns) reach the
    # other rows by one broadcast
    assert len(spy["broadcast"]) >= 1 and len(spy["all_reduce"]) <= 3, spy


def check_runs(recipe, images, results, jax_runs, exact=EXACT):
    """Each rank's runs of ``recipe`` against the JAX package's runs of the
    same fuse and layout (the unsharded one where the JAX package has no
    such layout) and against the port's own unsharded run, bit for bit
    for the recipes of ``exact``."""
    for rank, result in enumerate(results):
        for (fuse, layout), run in result.items():
            whole = result[(fuse, None)]
            refs = [jax_runs[(fuse, None)]]
            if (fuse, layout) in jax_runs:
                refs.append(jax_runs[(fuse, layout)])
            for ref in refs:
                assert run["draw"] == ref["draw"]
                assert history_close(run["history"], ref["history"])
                for name, want in ref["images"].items():
                    np.testing.assert_allclose(run["images"][name], want, rtol=RTOL, atol=ATOL,
                                               err_msg=f"{recipe} {fuse} {layout} {name}")
            assert recipe.startswith("znorm") or run["history"] == whole["history"]
            assert history_close(run["history"], whole["history"])
            assert run["warnings"] == whole["warnings"]
            for name, got in run["images"].items():
                if recipe in exact:
                    np.testing.assert_array_equal(got, whole["images"][name])
                else:
                    np.testing.assert_allclose(got, whole["images"][name], rtol=RTOL, atol=ATOL)
            if layout is not None:
                assert all(run["sharded"].values())
                assert_spy(recipe, layout, rank, run["spy"])
            # gated-out elements keep their input, bit for bit
            for _, params, _, _ in run["history"]:
                keep = params.get("_keep") if isinstance(params, dict) else None
                if keep is not None and recipe not in ("bias-noise", "rescale"):
                    for e in np.flatnonzero(~np.asarray(keep, bool)):
                        np.testing.assert_array_equal(run["images"]["t1"][e], images["t1"][e])


@pytest.mark.parametrize(
    "recipe",
    ["noise", "rician", "bias", "bias-shared", "bias-noise", "gamma", "clamp", "flip",
     "flip-shared", "znorm", "znorm-seg", "mask", "rescale", "rescale-pct", "rescale-seg",
     "fill-mean", "fill-otsu"],
)
def test_stage_stays_on_its_region(pool, recipe):
    images, classes = inputs()
    seed = 11
    results = pool.run("local", recipe, images, classes, seed)
    jax_runs = {
        (fuse, layout): run_jax(recipe, images, classes, seed, fuse, layout)
        for fuse in (False, True)
        for layout in (None, "B", "BJ")
    }
    check_runs(recipe, images, results, jax_runs)


@pytest.mark.parametrize("recipe", ["znorm", "znorm-seg", "noise", "bias", "gamma", "flip",
                                    "rescale-pct"])
def test_uneven_batch_stays_on_its_region(pool, recipe):
    """B = 3 on a data axis of 2: the ranks hold rows [0:2] and [2:3].
    Per-element values are cut to each rank's rows and batch-wide
    statistics reach every rank whole. The JAX package refuses a B that
    its data axis does not divide, so its unsharded runs are the
    reference.

    Gamma is held to 1e-5 here: torch's CPU ``pow`` rounds its vector and
    scalar loops differently, so where a rank's block starts off the
    whole tensor's vector grid one element may differ by one ulp."""
    images, classes = inputs()
    images = {name: arr[:3] for name, arr in images.items()}
    seed = 11
    results = pool.run("local", recipe, images, classes, seed)
    jax_runs = {
        (fuse, None): run_jax(recipe, images, classes, seed, fuse, None) for fuse in (False, True)
    }
    for result in results:
        for (_, layout), run in result.items():
            if layout is not None:
                assert run["images"]["t1"].shape[0] == 3
    check_runs(recipe, images, results, jax_runs, tuple(r for r in EXACT if r != "gamma"))


@pytest.mark.parametrize("kind", ["mean", "otsu"])
@pytest.mark.parametrize("spatial", [False, True], ids=["B", "BJ"])
def test_border_fills_gather_only_faces(pool, kind, spatial):
    """The statistical fills of a sharded batch equal the whole batch's
    exactly, from the faces' pieces alone, edges counted once per face
    in the JAX package's order."""
    images = {"t1": inputs(3)[0]["t1"]}
    for r in pool.run("fills", images, kind, spatial):
        np.testing.assert_array_equal(r["got"], r["want"])
        assert r["local"].shape == (SHAPE[0] // 2, SHAPE[1])
        spy = r["spy"]
        assert spy["p2p"] == [] and spy["all_reduce"] == []
        if spatial:
            assert spy["gathers"] == ["all_gather"]
            assert spy["gather_elements"] == [face_elements()]
        else:
            assert spy["gathers"] == []


@pytest.mark.parametrize("spatial", [False, True], ids=["B", "BJ"])
@pytest.mark.parametrize("seed", [0, 2**31 - 2])
def test_region_draws_are_the_whole_draws_elements(pool, spatial, seed):
    """Each rank's region of a draw (one strided segment over J) equals
    the same elements of the whole draw bit for bit, with no collective."""
    key = tt.random.draw_key(seed, 1)
    for rank, r in enumerate(pool.run("region_draws", key, SHAPE, spatial)):
        assert r["equal"], (rank, r["starts"])
        assert r["spy"]["gathers"] == [] and r["spy"]["p2p"] == []


@pytest.mark.parametrize("base", [0, 2**32 - 40, 2**32 + 3], ids=["0", "2^32-40", "2^32+3"])
@pytest.mark.parametrize("j0, jl", [(0, 5), (3, 7), (5, 5), (0, 10)])
def test_strided_normals_plain_is_a_slab(base, j0, jl):
    """``normals_plain`` of a strided segment (runs of ``jl K`` counters,
    here 15 or 21: not a multiple of 4) equals the slab of the whole draw
    bit for bit, from a counter base past 2^32 too; its words at base 0
    are ``jax.random.bits``' slab."""
    shape = (3, 2, 3, 10, 3)
    n = math.prod(shape)
    key = tt.random.draw_key(2024, 3)
    whole = tt.random.normals_plain([key], [n], None, "cpu", starts=[base]).reshape(shape)
    jax_bits = np.asarray(jax.random.bits(jax.random.wrap_key_data(
        jnp.asarray(key, jnp.uint32)), shape))
    for b0, bl in ((0, 3), (1, 2)):
        start, count, run, pitch = tt.random.slab_span(shape, b0, bl, j0, jl)
        assert (run, pitch) == ((count, count) if jl == shape[3] else (jl * 3, 30))
        got = tt.random.normals([key, key], [(count,), (count,)], [1.0, -0.5], "cpu",
                                starts=[base + start] * 2, runs=[run] * 2, pitches=[pitch] * 2)
        slab = whole[b0:b0 + bl, :, :, j0:j0 + jl]
        assert torch.equal(got[:count].reshape(slab.shape), slab)
        assert torch.equal(got[count:].reshape(slab.shape), slab * torch.tensor(-0.5))
        if base == 0:
            words = tt.random.as_uint32(tt.random.bits_plain(key, start, count, "cpu", run, pitch))
            np.testing.assert_array_equal(words.numpy().reshape(slab.shape),
                                          jax_bits[b0:b0 + bl, :, :, j0:j0 + jl])
