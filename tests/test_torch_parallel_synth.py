"""Port parity: a sharded batch's synthesis, label-set, host and metadata
stages stay on each rank's region (LabelsToImage,
HistogramStandardization, KeepLargestComponent, a Reorient that moves a
split J, a Resample to a new space, CopyAffine, ToReferenceSpace and a
dtype-only To), on the 4
gloo ranks of ``tests/_torch_dist.py`` at the layouts (data, space) =
(4, 1) (B split), (2, 2) and (1, 4) (B and J split).

Each recipe runs on the rank's whole batch and sharded at each layout.
The whole run is held against the JAX package's unsharded call on the
same numpy inputs and seed: labels, indices and casts bit for bit,
LabelsToImage's threefry tissue and HistogramStandardization's output
within 1e-6 (the zoo tests' tolerances), with the history and the next
host draw. Every sharded run equals the whole run bit for bit, with the
same history, draw and warnings, never enters ``gathered`` and leaves
each image (the new ScalarImage of LabelsToImage too) on the mesh.

The collective spy holds each run to the JAX package's partitioned
programs (``probes/jax_collectives.py``): the label
set of LabelsToImage two ``all_reduce`` over each split axis (its range,
then its histogram: 2 where the JAX package makes 3 on a B split, 4
where it makes 5 and a gather over B and J); HistogramStandardization
and KeepLargestComponent one gather of their rows' J columns over
``space`` an image (never over ``data``; the JAX package all-reduces
and gathers elements, or pulls the whole batch); a Reorient that moves
a split J one ``batch_isend_irecv`` an image (the JAX package: one
collective-permute an image); a Resample to a new space its "minimum"
fill's ``all_reduce`` and one ``batch_isend_irecv`` an image at most
(the columns its output reads); the metadata stages none. Nothing on a
B split.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import LABEL_LAYOUTS, RankPool, label_recipe
from test_torch_parallel_labels import jax_batch
from test_torch_zoo_spatial import history, history_close

WORLD = 4
#: (B, C, I, J, K) of the recipes
SHAPE = (4, 1, 16, 32, 16)
ELEMENT = math.prod(SHAPE[1:])
SEED = 3
#: the labels of the block map (element 1 alone holds 7)
LABELS = (0, 1, 2, 4, 6)
#: the zoo tests' tolerances: the threefry tissue and the histogram map
NORMAL_ATOL = HISTOGRAM_ATOL = 1e-6
#: the JAX tests' tolerance of a linear resample to a new space (the JAX
#: package's separable matmuls against the port's gather)
RESAMPLE_ATOL = 1e-5
#: recipe -> {image: tolerance against the JAX package} (others bit for bit)
JAX_ATOL = {
    "labels-to-image": {"image_from_labels": NORMAL_ATOL},
    "labels-to-image-shared": {"image_from_labels": NORMAL_ATOL},
    "histstd": {"t1": HISTOGRAM_ATOL},
    "resample-space": {"t1": RESAMPLE_ATOL},
}
RECIPES = ("labels-to-image", "labels-to-image-shared", "histstd", "keep-largest",
           "reorient-back", "resample-space", "metadata")
EMPTY = {"gathers": [], "gather_elements": [], "all_reduce": [], "broadcast": [], "p2p": []}
#: the JAX package's collectives of LabelsToImage (all-reduces and
#: all-gathers: B split, B and J split)
JAX_LABELS_TO_IMAGE = {False: 3, True: 6}


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


def inputs(seed=SEED):
    """``t1`` (float32 in [0, 1)) and ``seg``, an int32 map of 4^3-voxel
    blocks of LABELS (element 1 alone holds label 7): each label in many
    components, so KeepLargestComponent removes some."""
    rng = np.random.default_rng(seed)
    b, _, si, sj, sk = SHAPE
    t1 = rng.random((b, 1, si, sj, sk), np.float32)
    coarse = rng.choice(np.asarray(LABELS, np.int32), (b, 1, si // 4, sj // 4, sk // 4))
    seg = np.kron(coarse, np.ones((1, 1, 4, 4, 4), np.int32)).astype(np.int32)
    seg[1, 0, :4, 4:8, :4] = 7
    return {"t1": t1, "seg": seg}, {"seg": "label"}


def run_jax(recipe, images, classes, seed, inverse=False):
    """The JAX package's unsharded call of a recipe (then its inverse)."""
    tj.seed(seed)
    out = tj.Compose(label_recipe(tj, recipe), fuse=False)(jax_batch(images, classes))
    recorded = history(out)
    if inverse:
        out = out.apply_inverse_transform()
    draw = float(tj.random.random())
    return {
        "images": {n: np.asarray(ib.data) for n, ib in out.images.items()},
        "affines": {n: np.stack([np.asarray(a.data) for a in ib.affines])
                    for n, ib in out.images.items()},
        "history": recorded,
        "draw": draw,
    }


def parts(layout: str) -> tuple[int, int]:
    data, space = (int(n) for n in layout.strip("()").split(","))
    return data, space


def row_gathers(spy, layout, count, where):
    """``count`` gathers at most (exactly ``count`` where given as an
    int), each of this rank's rows' J columns over ``space`` (one element
    a row: never a gather over ``data``), and no other collective."""
    data_parts, _ = parts(layout)
    rows = SHAPE[0] // data_parts
    exact = isinstance(count, int)
    limit = count if exact else count[0]
    assert set(spy["gathers"]) <= {"all_gather"}, where
    assert (len(spy["gathers"]) == limit) if exact else len(spy["gathers"]) <= limit, where
    assert spy["gather_elements"] == [rows * ELEMENT] * len(spy["gathers"]), where
    assert spy["all_reduce"] == spy["broadcast"] == spy["p2p"] == [], where


def assert_spy(recipe, layout, run, images):
    """One rank's collectives at ``layout``, within the JAX package's."""
    spy = run["spy"]
    data_parts, space_parts = parts(layout)
    split_j = LABEL_LAYOUTS[layout][1]
    where = (recipe, layout, run["coordinate"], spy)
    if recipe == "metadata" or not split_j and not recipe.startswith("labels-to-image"):
        # the metadata stages, and every stage on a B split, make none
        assert spy == EMPTY, where
        return
    if recipe.startswith("labels-to-image"):
        axes = (data_parts > 1) + split_j
        span = max(LABELS + (7,)) - min(LABELS) + 1
        # the label set: (max, -min, fractional) then the histogram, each
        # reduced over every split axis
        assert spy["all_reduce"] == [3] * axes + [span] * axes, where
        assert len(spy["all_reduce"]) <= JAX_LABELS_TO_IMAGE[split_j], where
        assert spy["gathers"] == spy["broadcast"] == spy["p2p"] == [], where
        return
    if recipe == "histstd":
        row_gathers(spy, layout, 1, where)  # t1's rows, for their quantiles
        return
    if recipe == "keep-largest":
        row_gathers(spy, layout, 1, where)  # seg's rows, to the host
        return
    if recipe == "resample-space":
        # t1's "minimum" fill reduced over space, and each image's output
        # columns from the input columns they read: one exchange at most
        rows = SHAPE[0] // data_parts
        assert spy["all_reduce"] == [rows], where
        assert len(spy["p2p"]) <= len(images), where
        assert spy["gathers"] == spy["broadcast"] == [], where
        return
    if recipe in ("reorient-back", "reorient-move"):
        # an all-to-all over space: a part to and from every other rank,
        # one exchange an image and a Reorient
        reorients = 2 if recipe == "reorient-back" else 1
        assert spy["p2p"] == [2 * (space_parts - 1)] * (reorients * len(images)), where
        assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where
        return
    raise AssertionError(recipe)


def check_recipe(recipe, images, results, want, jax_atol, spy_check, inverse=False,
                 rtol=0.0, close=False):
    """Every rank's whole run against the JAX package's (``jax_atol``:
    image -> tolerance, ``rtol`` beside it; bit for bit elsewhere), every
    sharded run against the whole run bit for bit (``close``: within
    ``jax_atol`` and ``rtol``, the history's statistics within 1e-5: a
    statistic reduced over the mesh sums in another order), with its
    history, draw, warnings, placement and ``spy_check``'s collectives;
    gated-out elements keep their input (not after an inverse)."""
    for result in results:
        whole = result[None]
        assert whole["draw"] == want["draw"]
        assert history_close(whole["history"], want["history"])
        assert set(whole["images"]) == set(want["images"]), recipe
        for name, ref in want["images"].items():
            got = whole["images"][name]
            assert got.dtype == ref.dtype and got.shape == ref.shape, (recipe, name)
            if name in jax_atol:
                np.testing.assert_allclose(got, ref, rtol=rtol, atol=jax_atol[name],
                                           err_msg=f"{recipe} {name}")
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{recipe} {name}")
            np.testing.assert_allclose(whole["affines"][name], want["affines"][name],
                                       rtol=0, atol=1e-9)
        for layout in LABEL_LAYOUTS:
            run = result[layout]
            assert run["draw"] == whole["draw"]
            if close:
                assert history_close(run["history"], whole["history"]), (recipe, layout)
            else:
                assert run["history"] == whole["history"]
            assert run["warnings"] == whole["warnings"], (recipe, layout)
            assert run["gathered"] == 0, (recipe, layout)
            assert run["sharded"] and all(run["sharded"].values()), (recipe, layout)
            for name, got in run["images"].items():
                if close and name in jax_atol:
                    np.testing.assert_allclose(got, whole["images"][name], rtol=rtol,
                                               atol=jax_atol[name],
                                               err_msg=f"{recipe} {layout} {name}")
                else:
                    np.testing.assert_array_equal(got, whole["images"][name],
                                                  err_msg=f"{recipe} {layout} {name}")
                np.testing.assert_array_equal(run["affines"][name], whole["affines"][name])
            spy_check(recipe, layout, run, list(images))
            if inverse:
                continue
            # an element every stage gated out keeps its input, bit for bit
            touched = np.zeros(len(next(iter(images.values()))), bool)
            for _, params, _, _ in run["history"]:
                keep = params.get("_keep") if isinstance(params, dict) else None
                touched |= True if keep is None else np.asarray(keep, bool)
            for e in np.flatnonzero(~touched):
                for name, arr in images.items():
                    np.testing.assert_array_equal(run["images"][name][e], arr[e])


@pytest.mark.parametrize("recipe", RECIPES)
def test_stage_stays_on_its_region(pool, recipe):
    images, classes = inputs()
    results = pool.run("labels", recipe, images, classes, SEED)
    check_recipe(recipe, images, results, run_jax(recipe, images, classes, SEED),
                 JAX_ATOL.get(recipe, {}), assert_spy)
    if recipe == "resample-space":
        # some rank's output columns read another rank's input columns
        moved = [bool(r[layout]["spy"]["p2p"]) for r in results
                 for layout, (_, split_j) in LABEL_LAYOUTS.items() if split_j]
        assert any(moved), moved

