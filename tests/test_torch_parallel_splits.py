"""Port parity: a batch sharded along C, I or K over a mesh axis of more
than one rank runs each stage on the whole tensors and keeps each rank's
region after it, with the unsharded call's results, on the 4 gloo ranks
of ``tests/_torch_dist.py`` at the layouts of ``SPLIT_LAYOUTS``: (data,
space) = (1, 4) split along C (a 4-channel image), I or K, and (2, 2)
split along B and I or along B and K. A one-channel label map beside a
C-split image is placed whole (the JAX package places only dims that
divide over their mesh axis).

The recipes of ``split_recipe`` hold every class that sets
``takes_sharded`` (the recorded inverses through an inverse replay),
Affine, Motion, KeepLargestComponent and the "mean"/"otsu" fills on
each layout, unfused (each stage in one recipe) and, every fusable
stage, fused, and the stages
that gave wrong results or raised before (``f1-*``: ZNormalization,
RescaleIntensity, Contour, Noise, Resize). Each case is held three ways:

- against the port's whole run: images bit for bit, the same history,
  next host draw and warnings, each rank's block its region of the whole
  result, every image left on the mesh;
- against the JAX package run sharded on the same spec over 4 host
  devices: label maps and casts bit for bit, float images within the
  port tests' tolerance of the recipe's ops (1e-5; the threefry tissue
  and the histogram map 1e-6), the history (its statistics within 1e-5)
  and the next host draw (where the JAX package's sharded Ghosting fails
  in XLA:CPU's FFT, against its unsharded call);
- with the collective spy: each stage that enters ``gathered`` gathers
  each image on the mesh once (``DTensor.full_tensor``), a fused run
  once for the run, and nothing else moves between the ranks.

A mesh axis of one rank named on C, I or K leaves its dim whole: on one
gloo rank every recipe keeps to the region paths, never enters
``gathered``, makes no collective and equals the whole run bit for bit.
The region code, reached with a C, I or K split anyway, raises through
``Region.check_rows`` where it has no path, and the entries that take a
caller's placement (the fused step, the sharded grid inference, the
halo resample) give the whole input's result or the JAX package's
``HaloUnsupported``.
"""

from __future__ import annotations

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax
from jax.sharding import NamedSharding, PartitionSpec

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import SPLIT_LAYOUTS, RankPool, split_recipe, split_spec
from test_torch_parallel_labels import jax_batch
from test_torch_zoo_spatial import history, history_close

WORLD = 4
#: (B, C, I, J, K) of ``t1``: C, I and K divide over 4 ranks
SHAPE = (4, 4, 16, 12, 16)
SEED = 3
#: the labels of the block map
LABELS = (0, 1, 2, 4, 6)
#: the port tests' tolerance of the float images of each recipe against
#: the JAX package (atol and rtol); label maps and casts bit for bit
JAX_TOL = {"synth": {"tissue": 1e-6, "t1": 1e-5}}
DEFAULT_TOL = 1e-5
#: recipes whose sharded run equals the whole run within 1e-5 (PCA)
CLOSE = {"synth": 1e-5}
#: (recipe, fuse, inverse)
CASES = [
    ("f1-znorm", False, False),
    ("f1-rescale", False, False),
    ("f1-contour", False, False),
    ("f1-noise", False, False),
    ("f1-resize", False, False),
    ("pointwise", False, False),
    ("pointwise-all", True, False),
    ("spatial", False, False),
    ("labels", False, False),
    ("index", False, False),
    ("synth", False, False),
    ("kspace", False, False),
    ("metadata", False, False),
    ("inverses", False, True),
]
IDS = [f"{r}{'-fused' if f else ''}{'-inverse' if i else ''}" for r, f, i in CASES]
#: a one-rank axis named on C, I or K (and B with I): no dim is split
ONE_RANK = {
    "C": (1, (None, "space", None, None, None)),
    "I": (1, (None, None, "space", None, None)),
    "K": (1, (None, None, None, None, "space")),
    "B+I": (1, ("data", None, "space", None, None)),
}
GATHERS = {"DTensor.full_tensor", "DTensor.redistribute"}
#: recipes whose JAX package call may fail when sharded: its Ghosting's
#: FFT fails XLA:CPU's layout check (``fft_thunk.cc``: the operand must be
#: row-major) on a C, I, B + I or B + K split (ROADMAP, known faults in
#: the reference); the port is then held against its unsharded call
FFT_FAULT = ("kspace",)


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(WORLD)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def one_rank():
    ranks = RankPool(1)
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


def inputs():
    """``t1``: 4 correlated channels in about [0, 2) (PCA's gram then has
    well-separated eigenvalues), and ``seg``, an int32 map of 4^3-voxel
    blocks of LABELS."""
    rng = np.random.default_rng(SEED)
    b, c, si, sj, sk = SHAPE
    t1 = rng.random(SHAPE, np.float32)
    for channel in range(1, c):
        t1[:, channel] += np.float32(0.5 / channel) * t1[:, channel - 1]
    coarse = rng.choice(np.asarray(LABELS, np.int32), (b, 1, si // 4, sj // 4, sk // 4))
    seg = np.kron(coarse, np.ones((1, 1, 4, 4, 4), np.int32)).astype(np.int32)
    return {"t1": t1, "seg": seg}, {"seg": "label"}


def run_jax(recipe, images, classes, layout, fuse, inverse):
    """The JAX package's call with each image placed by ``split_spec`` of
    ``layout`` on 4 host devices (``layout`` None: unsharded). Where the
    recipe's sharded call fails in XLA:CPU's FFT (FFT_FAULT), the
    unsharded call, with the failure named under ``fault``."""
    from torchio_tpu.parallel.mesh import make_mesh

    batch = jax_batch(images, classes)
    if layout is not None:
        space, spec = SPLIT_LAYOUTS[layout]
        mesh = make_mesh(jax.devices()[:WORLD], space=space)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        for ib in batch.images.values():
            ib.shard_(NamedSharding(mesh, PartitionSpec(*split_spec(spec, ib.data.shape, sizes))))
        if recipe in FFT_FAULT:
            try:
                return run_jax_batch(recipe, batch, fuse, inverse)
            except jax.errors.JaxRuntimeError as error:
                assert "fft_thunk" in str(error), error
                return {**run_jax(recipe, images, classes, None, fuse, inverse),
                        "fault": str(error).splitlines()[0]}
    return run_jax_batch(recipe, batch, fuse, inverse)


def run_jax_batch(recipe, batch, fuse, inverse):
    tj.seed(SEED)
    out = tj.Compose(split_recipe(tj, recipe), fuse=fuse)(batch)
    recorded = history(out)
    if inverse:
        out = out.apply_inverse_transform()
    return {
        "images": {n: np.asarray(ib.data) for n, ib in out.images.items()},
        "history": recorded,
        "draw": float(tj.random.random()),
    }


def assert_gathers(run, fused: bool, images: int, where):
    """Each gather a ``full_tensor`` of an image on the mesh (with the
    ``redistribute`` it makes): one for each image on the mesh each time
    a stage (a fused run: the run) entered ``gathered`` (none for a stage
    nested in another's call, such as CropOrPad's Pad and Crop); no other
    collective."""
    spy = run["spy"]
    assert set(spy["gathers"]) <= GATHERS, where
    assert spy["gathers"].count("DTensor.full_tensor") == sum(run["gathered"]), where
    assert spy["all_reduce"] == spy["broadcast"] == spy["p2p"] == [], where
    assert run["gathered"] and run["gathered"][0] == images, where
    if fused:
        assert run["gathered"] == [images], where


def check_case(recipe, fuse, inverse, results, jax_runs):
    tol = JAX_TOL.get(recipe, {})
    for rank, result in enumerate(results):
        whole = result[None]
        for layout in SPLIT_LAYOUTS:
            run, want = result[layout], jax_runs[layout]
            where = (recipe, layout, rank)
            # the port's whole run
            assert run["history"] == whole["history"], where
            assert run["draw"] == whole["draw"], where
            assert run["warnings"] == whole["warnings"], where
            assert sorted(run["images"]) == sorted(whole["images"]), where
            for name, got in run["images"].items():
                ref = whole["images"][name]
                assert got.dtype == ref.dtype and got.shape == ref.shape, (*where, name)
                if recipe in CLOSE:
                    np.testing.assert_allclose(got, ref, rtol=0, atol=CLOSE[recipe])
                else:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{where} {name}")
            assert run["blocks"] and all(run["blocks"].values()), (where, run["blocks"])
            assert all(p is not None for p in run["placements"].values()), where
            # the JAX package on the same spec
            assert history_close(run["history"], want["history"]), where
            assert run["draw"] == want["draw"], where
            for name, ref in want["images"].items():
                got = run["images"][name]
                assert got.dtype == ref.dtype and got.shape == ref.shape, (*where, name)
                if np.issubdtype(ref.dtype, np.floating) and ref.dtype != np.float16:
                    atol = tol.get(name, DEFAULT_TOL)
                    np.testing.assert_allclose(got, ref, rtol=atol, atol=atol,
                                               err_msg=f"{where} {name}")
                else:
                    np.testing.assert_array_equal(got, ref, err_msg=f"{where} {name}")
            # the collectives
            assert_gathers(run, fuse, len(results[0][None]["images"]) - (recipe == "synth"),
                           where)


@pytest.mark.parametrize("recipe, fuse, inverse", CASES, ids=IDS)
def test_split_stage_takes_the_whole_batch(pool, recipe, fuse, inverse):
    images, classes = inputs()
    results = pool.run("splits", recipe, images, classes, SEED, SPLIT_LAYOUTS, fuse, inverse)
    jax_runs = {layout: run_jax(recipe, images, classes, layout, fuse, inverse)
                for layout in SPLIT_LAYOUTS}
    check_case(recipe, fuse, inverse, results, jax_runs)


@pytest.mark.parametrize("recipe", ["pointwise-all", "spatial", "labels", "index", "synth",
                                    "kspace", "inverses"])
def test_one_rank_axis_keeps_the_region_paths(one_rank, recipe):
    """On one rank a spec naming C, I or K splits nothing: every stage
    takes its region path (never ``gathered``), with no collective, equal
    to the whole run bit for bit."""
    images, classes = inputs()
    inverse = recipe == "inverses"
    (result,) = one_rank.run("splits", recipe, images, classes, SEED, ONE_RANK, False, inverse)
    whole = result[None]
    for layout in ONE_RANK:
        run = result[layout]
        assert run["gathered"] == [], (recipe, layout)
        assert run["spy"]["gathers"] == run["spy"]["all_reduce"] == [], (recipe, layout)
        assert run["spy"]["broadcast"] == run["spy"]["p2p"] == [], (recipe, layout)
        assert run["history"] == whole["history"] and run["draw"] == whole["draw"]
        assert run["warnings"] == whole["warnings"]
        for name, got in run["images"].items():
            np.testing.assert_array_equal(got, whole["images"][name], err_msg=f"{layout} {name}")


@pytest.mark.parametrize("layout", list(SPLIT_LAYOUTS))
def test_region_code_reached_with_a_split(pool, layout):
    """Reached with a C, I or K split anyway: ``Region.check_rows`` raises
    naming the predicate, the sharded "mean" fill refuses, the region's
    draws and reductions equal the whole tensor's, ``_batch_fill_value``
    takes the whole tensor, the fused step and the sharded grid inference
    on a caller's placement equal their whole input's result, and the
    halo resample raises the JAX package's ``HaloUnsupported``."""
    from torchio_tpu.parallel.halo import HaloUnsupported, halo_resample_spec
    from torchio_tpu.parallel.mesh import make_mesh

    images, _ = inputs()
    space, spec = SPLIT_LAYOUTS[layout]
    mesh = make_mesh(jax.devices()[:WORLD], space=space)
    x = np.zeros((4, 4, 16, 12, 16), np.float32)
    with pytest.raises(HaloUnsupported) as jax_error:
        halo_resample_spec(jax.numpy.asarray(x), [np.eye(4)] * 4, [None] * 4,
                           sharding=NamedSharding(mesh, PartitionSpec(*spec)))
    for r in pool.run("split_guards", images["t1"], space, spec):
        assert r["splits"] and "splits_c_i_or_k" in r["check_rows"], r
        assert "splits_c_i_or_k" in r["border_fill"], r
        assert r["draws"] and r["reduce_sum"] and r["reduce_max"], r
        assert r["fill"] and r["step"] and r["inference"], r
        assert r["halo"] == f"HaloUnsupported: {jax_error.value}", r
