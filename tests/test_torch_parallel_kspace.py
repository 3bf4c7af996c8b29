"""Port parity: a sharded batch's k-space stages (Motion, Ghosting, Spike)
and the recorded inverses of its pointwise stages (Flip's per element,
Rescale's, Standardize's, BiasField's, Gamma's, OneHot's) stay on each
rank's region, on the 4 gloo ranks of ``tests/_torch_dist.py`` at the
layouts (data, space) = (4, 1) (B split), (2, 2) and (1, 4) (B and J
split); and a per-instance OneOf or SomeOf on a sharded batch leaves it
placed as the JAX package leaves its own.

Each recipe runs on the rank's whole batch and sharded at each layout
(an inverse recipe: its forward stages, then ``apply_inverse_transform()``
on the result). The whole run is held against the JAX package's
unsharded call on the same numpy inputs and seed: the k-space stages
within 1e-5 (``tests/test_torch_kspace.py``'s tolerance; Ghosting over B
and J raises in the JAX package on XLA:CPU, so its unsharded call is the
reference), the inverses within 1e-5 of either scale (the pointwise
tests' ATOL and RTOL), with the history and the next host draw. Every
sharded run equals the whole run bit for bit, with the same history,
draw and warnings (the recipe whose forward standardises: within 1e-5,
its statistic summed over the mesh in another order, as in
``tests/test_torch_parallel_local.py``), never enters ``gathered`` and
leaves each image on the mesh; gated-out elements keep their input bit
for bit.

The collective spy holds each run to the JAX package's programs
(``probes/jax_collectives.py``): on a B split the
k-space stages make none (the JAX package all-gathers the batch's
spectra twice and all-reduces once); on a J split one gather of the
rows' J columns over ``space`` an image and stage (never over ``data``;
the JAX package all-gathers spectra 4-5 times). The inverses make no
gather and no reduction: only Flip's inverse along a split J takes its
mirror columns, one ``batch_isend_irecv`` an image.
"""

from __future__ import annotations

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import LABEL_LAYOUTS, RankPool, composer_recipe
from test_torch_parallel_labels import jax_batch
from test_torch_parallel_synth import (EMPTY, SEED, check_recipe, inputs, parts, row_gathers,
                                       run_jax)

WORLD = 4
#: ``tests/test_torch_kspace.py``'s tolerance, and the pointwise tests'
KSPACE_ATOL = 1e-5
INVERSE_ATOL = INVERSE_RTOL = 1e-5
#: recipe -> the k-space stages in it
KSPACE = {"motion": 1, "ghosting": 1, "ghosting-shared": 1, "spike": 1, "kspace": 2}
INVERSES = ("pointwise-inverses", "shared-inverses")
#: inverse recipes whose forward takes a statistic reduced over the mesh
#: (ZNormalization's mean and std: another sum order, within 1e-5), so
#: their sharded runs equal the whole run within 1e-5, not bit for bit
STATISTICS = ("pointwise-inverses",)


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


def kspace_spy(recipe, layout, run, images):
    """No collective on a B split; on a J split one gather of the rows' J
    columns over ``space`` for each k-space stage that runs on ``t1`` (a
    stage whose every element is gated out runs none)."""
    where = (recipe, layout, run["coordinate"], run["spy"])
    if not LABEL_LAYOUTS[layout][1]:
        assert run["spy"] == EMPTY, where
        return
    stages = KSPACE[recipe]
    row_gathers(run["spy"], layout, 1 if stages == 1 else (stages,), where)


def inverse_spy(recipe, layout, run, images):
    """No gather, reduction or broadcast; along a split J at most one
    mirror exchange an image (Flip's inverse)."""
    spy = run["spy"]
    where = (recipe, layout, run["coordinate"], spy)
    assert spy["gathers"] == spy["all_reduce"] == spy["broadcast"] == [], where
    if not LABEL_LAYOUTS[layout][1]:
        assert spy["p2p"] == [], where
        return
    _, space = parts(layout)
    assert len(spy["p2p"]) <= len(images), where
    # a mirror exchange: one column block to and from at most one rank
    assert all(n in (1, 2) for n in spy["p2p"]) or space == 1, where


@pytest.mark.parametrize("recipe", list(KSPACE))
def test_kspace_stage_stays_on_its_region(pool, recipe):
    images, classes = inputs()
    results = pool.run("labels", recipe, images, classes, SEED)
    check_recipe(recipe, images, results, run_jax(recipe, images, classes, SEED),
                 {"t1": KSPACE_ATOL}, kspace_spy)


@pytest.mark.parametrize("recipe", INVERSES)
def test_recorded_inverses_stay_on_their_region(pool, recipe):
    images, classes = inputs()
    results = pool.run("labels", recipe, images, classes, SEED, True)
    want = run_jax(recipe, images, classes, SEED, inverse=True)
    check_recipe(recipe, images, results, want, {"t1": INVERSE_ATOL}, inverse_spy,
                 inverse=True, rtol=INVERSE_RTOL, close=recipe in STATISTICS)


def test_gating_keeps_some_elements():
    """The gated recipes' seed keeps some elements and gates others out,
    so the bit-exact check of the gated-out elements runs."""
    images, classes = inputs()
    for recipe in ("motion", "ghosting", "spike"):
        keep = run_jax(recipe, images, classes, SEED)["history"][0][1]["_keep"]
        assert any(keep) and not all(keep), (recipe, keep)


def test_composers_drop_the_placement_as_the_jax_package(pool):
    """A per-instance OneOf or SomeOf unbatches its elements (the port
    gathers each image once), runs each alone and re-stacks them: the
    result is a new batch on no mesh in both packages
    (``ImagesBatch.sharding`` None; the port's data a plain tensor),
    equal to the unsharded call."""
    from torchio_tpu.parallel.mesh import make_mesh

    images, classes = inputs()
    results = pool.run("composer_placement", images, classes, SEED)
    for name in ("OneOf", "SomeOf"):
        batch = jax_batch(images, classes)
        batch.shard_(make_mesh(jax.devices()[:WORLD], space=2), spatial=True)
        tj.seed(SEED)
        out = composer_recipe(tj, name)(batch)
        jax_placed = {n: ib.sharding is not None for n, ib in out.images.items()}
        tj.seed(SEED)
        whole = composer_recipe(tj, name)(jax_batch(images, classes))
        for result in results:
            got = result[name]
            assert got["sharding"] == jax_placed == {n: False for n in images}, name
            assert not any(got["dtensor"].values()), name
            for n, ib in whole.images.items():
                np.testing.assert_allclose(got["images"][n], np.asarray(ib.data), rtol=0,
                                           atol=KSPACE_ATOL, err_msg=f"{name} {n}")


@pytest.mark.parametrize("recipe", ["kspace", "spike", "labels-to-image", "histstd"])
def test_uneven_batch_leaves_a_rank_no_rows(pool, recipe):
    """B = 3 over 4 ``data`` ranks at (4, 1) leaves one rank no rows (and
    over 2 at (2, 2) one row fewer): the stages skip the empty block, and
    every sharded run equals the whole run bit for bit, which equals the
    JAX package's unsharded call."""
    images, classes = inputs()
    images = {name: arr[:3] for name, arr in images.items()}
    want = run_jax(recipe, images, classes, SEED)
    atol = {"kspace": KSPACE_ATOL, "spike": KSPACE_ATOL, "labels-to-image": 1e-6,
            "histstd": 1e-6}[recipe]
    for result in pool.run("labels", recipe, images, classes, SEED):
        for name, ref in want["images"].items():
            np.testing.assert_allclose(result[None]["images"][name], ref, rtol=0, atol=atol,
                                       err_msg=f"{recipe} {name}")
        for layout in LABEL_LAYOUTS:
            run = result[layout]
            assert run["gathered"] == 0 and all(run["sharded"].values()), (recipe, layout)
            assert run["history"] == result[None]["history"], (recipe, layout)
            for name, got in run["images"].items():
                np.testing.assert_array_equal(got, result[None]["images"][name],
                                              err_msg=f"{recipe} {layout} {name}")
