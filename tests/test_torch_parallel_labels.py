"""Port parity: a sharded batch's label and index stages stay on each rank's
region (RemapLabels, RemoveLabels, OneHot, Contour, SequentialLabels,
Swap, PCA, Resize, Anisotropy, Crop, Pad, CropOrPad, Reorient,
Transpose), on the 4 gloo ranks of ``tests/_torch_dist.py`` at the
layouts (data, space) = (4, 1) (B split), (2, 2) and (1, 4) (B and J
split).

Each recipe runs on the rank's whole batch and sharded at each layout.
The whole run is held against the JAX package's unsharded call on the
same numpy inputs and seed (labels and indices bit for bit; the linear
Resize and Anisotropy and PCA within 1e-5, the JAX tests' tolerance),
with the history and the next host draw; every sharded run equals the
whole run bit for bit (PCA within 1e-5), with the same history, draw
and warnings, never enters ``gathered`` and leaves each image on the
mesh. Gated-out elements keep their input bit for bit.

The collective spy holds each run to the JAX package's partitioned
programs (``probes/jax_collectives.py``): no collective where they have
none; OneHot's largest label one ``all_reduce`` over each split axis;
Contour one plane from each neighbour; Swap one ``all_reduce`` a step
over ``space``; PCA and SequentialLabels one gather of their rows' (of
element 0's) J columns over ``space``, never over ``data``. One
exception, named where it is checked: where a stage's output columns
read input columns another rank holds (a crop, a pad or an index
resample along a split J), those columns move between the ranks of the
``space`` group point to point, one ``batch_isend_irecv`` an image at
most, where the JAX package all-reduces or all-gathers whole elements
(or, for a constant pad, leaves GSPMD's uneven split).
"""

from __future__ import annotations

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax.numpy as jnp

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import LABEL_LAYOUTS, RankPool, label_recipe
from test_torch_zoo_spatial import history, history_close

WORLD = 4
#: the JAX tests' tolerance of the linear Resize and Anisotropy and PCA
ATOL = 1e-5
#: (B, C, I, J, K) of the label and index recipes; PCA's image has 4 channels
SHAPE = (4, 1, 16, 32, 16)
PCA_CHANNELS = 4
SEED = 3
#: the labels of the block map (SequentialLabels compacts them)
LABELS = (0, 1, 2, 4, 6)
#: recipes compared with the JAX package within ATOL (float images)
FLOAT_RECIPES = ("pca", "resize", "resize-up", "anisotropy", "anisotropy-j")
#: recipes whose sharded run equals the whole run within ATOL, not bit for bit
CLOSE_RECIPES = ("pca",)
#: recipes with no collective at any layout
NO_COLLECTIVE = ("remap", "remove", "onehot3", "transpose", "croporpad-ik")
#: recipes whose J-split runs may move columns between the ranks of
#: ``space`` (the exception of the module's docstring), one exchange an
#: image at most
COLUMN_MOVES = ("resize", "resize-up", "crop", "pad", "pad-reflect", "pad-reflect-wide",
                "pad-replicate", "pad-circular", "croporpad", "anisotropy-j")
RECIPES = ("remap", "remove", "onehot", "onehot3", "contour", "sequential", "swap", "pca",
           "resize", "resize-up", "anisotropy", "anisotropy-j", "crop", "pad", "pad-reflect",
           "pad-reflect-wide", "pad-replicate", "pad-circular", "pad-median", "croporpad",
           "croporpad-ik", "transpose", "reorient", "labels-chain")
EMPTY = {"gathers": [], "gather_elements": [], "all_reduce": [], "broadcast": [], "p2p": []}


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


def inputs(recipe):
    """``t1`` (float32 in [0, 1), the scale of the JAX tests' tolerance)
    and ``seg``, an int32 map of 4^3-voxel blocks of
    LABELS (element 1 alone holds label 7, which SequentialLabels
    collapses to 0). PCA's ``t1`` has 4 correlated channels, as the zoo's
    PCA tests have: independent channels of one law give a gram with
    near-equal eigenvalues, whose eigenvectors no float32 sum order
    pins down (the port's and the JAX package's differ there by 1e-4)."""
    rng = np.random.default_rng(SEED)
    b, _, si, sj, sk = SHAPE
    if recipe == "pca":
        t1 = rng.standard_normal((b, PCA_CHANNELS, si, sj, sk)).astype(np.float32)
        for c in range(1, PCA_CHANNELS):
            t1[:, c] += np.float32(0.5 / c) * t1[:, c - 1]
    else:
        t1 = rng.random((b, 1, si, sj, sk), np.float32)
    coarse = rng.choice(np.asarray(LABELS, np.int32), (b, 1, si // 4, sj // 4, sk // 4))
    seg = np.kron(coarse, np.ones((1, 1, 4, 4, 4), np.int32)).astype(np.int32)
    seg[1, 0, :4, 4:8, :4] = 7
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


def run_jax(recipe, images, classes, seed):
    tj.seed(seed)
    out = tj.Compose(label_recipe(tj, recipe), fuse=False)(jax_batch(images, classes))
    return {
        "images": {n: np.asarray(ib.data) for n, ib in out.images.items()},
        "affines": {n: np.stack([np.asarray(a.data) for a in ib.affines])
                    for n, ib in out.images.items()},
        "history": history(out),
        "draw": float(tj.random.random()),
    }


def _parts(layout: str) -> tuple[int, int]:
    data, space = (int(n) for n in layout.strip("()").split(","))
    return data, space


def _neighbours(layout: str, coordinate) -> int:
    """The ranks beside this one on its ``space`` group."""
    _, space = _parts(layout)
    s = coordinate[1]
    return (s > 0) + (s < space - 1)


def assert_spy(recipe, layout, run, images):
    """One rank's collectives at ``layout``, as the JAX package's
    partitioned program has them (or the named exception)."""
    spy = run["spy"]
    data_parts, space_parts = _parts(layout)
    split_j = LABEL_LAYOUTS[layout][1] and space_parts > 1
    where = (recipe, layout, run["coordinate"], spy)
    if recipe in NO_COLLECTIVE or (not split_j and recipe not in ("onehot", "sequential",
                                                                   "labels-chain")):
        # B only: every stage the JAX table marks "none" makes none; Swap,
        # Anisotropy and PCA (an all-reduce of one element there) too
        assert spy == EMPTY, where
        return
    if recipe == "onehot":
        # the largest label: one all_reduce(MAX) of one int over each split axis
        assert spy["all_reduce"] == [1] * ((data_parts > 1) + split_j), where
        assert spy["gathers"] == spy["broadcast"] == spy["p2p"] == [], where
        return
    if recipe == "contour":
        # one J plane from each neighbour: a send and a receive apiece
        assert spy["p2p"] == [2 * _neighbours(layout, run["coordinate"])], where
        assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where
        return
    if recipe == "sequential":
        holds_first = run["coordinate"][0] == 0
        element = int(np.prod(SHAPE[1:]))
        # element 0's J columns over space, on the ranks that hold it
        assert spy["gathers"] == (["all_gather"] if holds_first and split_j else []), where
        assert spy["gather_elements"] == ([element] if holds_first and split_j else []), where
        # its label list (length, then labels) over data, from the rows that hold it
        assert len(spy["broadcast"]) == (2 if data_parts > 1 else 0), where
        assert spy["all_reduce"] == spy["p2p"] == [], where
        return
    if recipe == "swap":
        # one all_reduce a step (4) over space of both patches' parts
        rows = SHAPE[0] // data_parts
        assert spy["all_reduce"] == [2 * rows * 4 ** 3] * 4, where
        assert spy["gathers"] == spy["broadcast"] == spy["p2p"] == [], where
        return
    if recipe == "pca":
        # the rows' J columns over space (never over data), once
        rows = SHAPE[0] // data_parts
        assert spy["gathers"] == ["all_gather"], where
        assert spy["gather_elements"] == [rows * PCA_CHANNELS * int(np.prod(SHAPE[2:]))], where
        assert spy["all_reduce"] == spy["broadcast"] == spy["p2p"] == [], where
        return
    if recipe == "reorient":
        # the J flip: the mirror ranks' columns, one exchange an image
        assert spy["p2p"] == [2] * len(images), where
        assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where
        return
    if recipe == "pad-median":
        # the median reads whole elements: the rows' J columns over space
        assert spy["gathers"] == ["all_gather"] * len(images), where
        assert spy["all_reduce"] == spy["broadcast"] == spy["p2p"] == [], where
        return
    if recipe == "anisotropy":
        # the exception: the rows degraded along J move their columns, one
        # exchange an image at most; no gather, no reduction
        assert len(spy["p2p"]) <= len(images), where
        assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where
        return
    if recipe == "labels-chain":
        assert not any(g.startswith("DTensor") for g in spy["gathers"]), where
        return
    assert recipe in COLUMN_MOVES, recipe
    # the exception: columns moved between the ranks of space, point to
    # point, one exchange an image at most
    assert len(spy["p2p"]) <= len(images), where
    assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where


def check_recipe(recipe, images, results, want):
    float_images = recipe in FLOAT_RECIPES
    for result in results:
        whole = result[None]
        assert whole["draw"] == want["draw"]
        assert history_close(whole["history"], want["history"])
        for name, ref in want["images"].items():
            got = whole["images"][name]
            assert got.dtype == ref.dtype and got.shape == ref.shape, (recipe, name)
            if float_images and np.issubdtype(ref.dtype, np.floating) and name == "t1":
                np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{recipe} {name}")
            np.testing.assert_allclose(whole["affines"][name], want["affines"][name],
                                       rtol=0, atol=1e-9)
        for layout in LABEL_LAYOUTS:
            run = result[layout]
            assert run["draw"] == whole["draw"]
            assert run["history"] == whole["history"]
            assert run["warnings"] == whole["warnings"], (recipe, layout)
            assert run["gathered"] == 0, (recipe, layout)
            assert all(run["sharded"].values()), (recipe, layout)
            for name, got in run["images"].items():
                if recipe in CLOSE_RECIPES:
                    np.testing.assert_allclose(got, whole["images"][name], rtol=0, atol=ATOL)
                else:
                    np.testing.assert_array_equal(got, whole["images"][name],
                                                  err_msg=f"{recipe} {layout} {name}")
                np.testing.assert_array_equal(run["affines"][name], whole["affines"][name])
            assert_spy(recipe, layout, run, [n for n in images if n in run["images"]]
                       if recipe not in ("contour", "onehot", "sequential") else ["seg"])
            # gated-out elements keep their input, bit for bit
            for _, params, _, _ in run["history"]:
                keep = params.get("_keep") if isinstance(params, dict) else None
                for e in np.flatnonzero(~np.asarray(keep, bool)) if keep is not None else ():
                    for name, arr in images.items():
                        np.testing.assert_array_equal(run["images"][name][e], arr[e])


@pytest.mark.parametrize("recipe", RECIPES)
def test_label_stage_stays_on_its_region(pool, recipe):
    images, classes = inputs(recipe)
    results = pool.run("labels", recipe, images, classes, SEED)
    check_recipe(recipe, images, results, run_jax(recipe, images, classes, SEED))
    if recipe in COLUMN_MOVES:
        # the shapes make some rank's output read another rank's columns at
        # a J-split layout (a symmetric crop or pad of an even J over 2
        # ranks stays on each rank; Resize's 32 -> 24 does at both layouts)
        moved = {layout: [bool(r[layout]["spy"]["p2p"]) for r in results]
                 for layout in LABEL_LAYOUTS}
        split = [any(m) for layout, m in moved.items() if LABEL_LAYOUTS[layout][1]]
        assert any(split) == (recipe != "resize"), moved


@pytest.mark.parametrize("recipe", ["swap", "anisotropy"])
def test_gating_keeps_some_elements(pool, recipe):
    """The gated recipes' seed keeps some elements and gates others out,
    so the bit-exact check of the gated-out elements runs."""
    images, classes = inputs(recipe)
    keep = run_jax(recipe, images, classes, SEED)["history"][0][1]["_keep"]
    assert any(keep) and not all(keep), keep


def test_reorient_moving_j_gathers_with_a_warning(pool):
    """A Reorient whose permutation moves J: B only, on each rank's rows
    with no collective; on a J split an all-to-all over ``space`` (each
    rank's new J columns, whole along the old J, from every other rank:
    one ``batch_isend_irecv`` an image, as the JAX package's one
    collective-permute an image), with no gather and no warning, equal
    to the whole call bit for bit and left on the mesh."""
    images, classes = inputs("reorient-move")
    want = run_jax("reorient-move", images, classes, SEED)
    for result in pool.run("labels", "reorient-move", images, classes, SEED):
        for name, ref in want["images"].items():
            np.testing.assert_array_equal(result[None]["images"][name], ref)
        for layout, (space, split_j) in LABEL_LAYOUTS.items():
            run = result[layout]
            for name, got in run["images"].items():
                np.testing.assert_array_equal(got, result[None]["images"][name])
            assert run["warnings"] == [] and run["gathered"] == 0, (layout, run["warnings"])
            assert all(run["sharded"].values()), layout
            if split_j:
                assert run["spy"]["p2p"] == [2 * (space - 1)] * len(images), run["spy"]
                assert run["spy"]["gathers"] == run["spy"]["all_reduce"] == [], run["spy"]
            else:
                assert run["spy"] == EMPTY, (layout, run["spy"])
