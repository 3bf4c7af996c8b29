"""Port parity: ``torchio_tpu_torch.parallel`` on 4 gloo ranks against
``torchio_tpu.parallel`` on 4 of the 8 virtual CPU devices, in the same
(data, space) layout.

The port runs in a module-scoped pool of 4 spawned ranks
(``tests/_torch_dist.py``: gloo over a ``file://`` store, one thread a
rank, a timeout on every job); the JAX package runs in this process on a
``make_mesh(jax.devices()[:4], space=...)``. Both take the same numpy
inputs made from a seed, and each comparison keeps the JAX test's own
tolerance (``tests/test_parallel.py``). This file holds the mesh, the
fused step, the halo stencils and their guards, the halo route of the
public Spatial and Blur, and the collective spy that stands for the JAX
tests' "no all-gather in the HLO" checks: no all-gather, ``full_tensor``
or ``redistribute`` runs inside a halo program, and each exchange posts
exactly the P2P ops its rank's neighbours need (two a neighbour).
``tests/test_torch_parallel_public.py`` holds the batch API, the sampler,
patch inference and the file-to-file pipeline.

Not ported (JAX-only entries): ``test_graft_entry_single``,
``test_graft_entry_multichip`` (``__graft_entry__.py``) and
``test_bench_mesh_smoke`` (``bench.py --mesh``); ``test_dryrun_private_api_pin``
becomes a pin of the torch.distributed API the port uses.
"""

from __future__ import annotations

import inspect
import re

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax
import jax.numpy as jnp

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import RankPool

WORLD = 4


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


def jax_mesh(space=None):
    from torchio_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:WORLD], space=space)


def jax_put(x, mesh, spec=("data", None, None, "space", None)):
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec(*spec)))


def p2p_expected(space: int) -> list[list[int]]:
    """Per rank of the (WORLD // space, space) mesh, the P2P ops of one
    exchange: two (a send and a receive) for each neighbour."""
    return [2 * ((s > 0) + (s < space - 1)) for r in range(WORLD) for s in [r % space]]


def assert_no_gather(results, exchanges: int, space: int):
    expected = p2p_expected(space)
    for rank, result in enumerate(results):
        spy = result["spy"]
        assert spy["gathers"] == [], (rank, spy)
        ops = [n for n in spy["p2p"]]
        assert ops == [expected[rank]] * exchanges if expected[rank] else ops == [], (rank, spy)


def rotation_matrix(degrees: float, shift=(1.5, -2.0, 0.5)) -> np.ndarray:
    theta = np.deg2rad(degrees)
    m = np.eye(4)
    m[0, 0] = m[1, 1] = np.cos(theta)
    m[0, 1], m[1, 0] = -np.sin(theta), np.sin(theta)
    m[:3, 3] = shift
    return m


# --------------------------------------------------------------------------
# The mesh
# --------------------------------------------------------------------------


def test_mesh_shape(pool):
    results = pool.run("mesh", None)
    assert [r["rank"] for r in results] == list(range(WORLD))
    for r in results:
        assert r["shape"] == (2, 2)
        assert r["names"] == ("data", "space")
        assert r["device_type"] == "cpu"
    assert [r["coordinate"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert jax_mesh().devices.shape == (2, 2)
    # the same layouts as the JAX function, the same error on an indivisible world
    assert pool.run("mesh", 4)[0]["shape"] == (1, 4) == jax_mesh(4).devices.shape
    with pytest.raises(ValueError) as jax_error:
        jax_mesh(3)
    assert pool.run("mesh_indivisible", 3) == [str(jax_error.value)] * WORLD


def test_make_mesh_needs_a_process_group():
    from torchio_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        make_mesh("cpu")


def test_distributed_api_pin():
    """The torch.distributed API the port uses exists in this torch (and
    in the card's 2.11): a change fails here, not in a rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    assert dist.is_available()
    params = inspect.signature(DTensor.from_local).parameters
    assert {"run_check", "shape", "stride"} <= set(params)
    for name in ("to_local", "full_tensor", "redistribute", "placements", "device_mesh"):
        assert hasattr(DTensor, name)
    for name in ("get_group", "get_coordinate", "size", "mesh_dim_names"):
        assert hasattr(DeviceMesh, name)
    for name in ("batch_isend_irecv", "P2POp", "isend", "irecv", "get_global_rank", "barrier"):
        assert hasattr(dist, name)
    assert "mesh_dim_names" in inspect.signature(init_device_mesh).parameters
    assert Shard(3).is_shard() and Replicate().is_replicate()


# --------------------------------------------------------------------------
# The fused step
# --------------------------------------------------------------------------


def test_sharded_step_matches_single_device(pool):
    from torchio_tpu.parallel.mesh import batch_sharding
    from torchio_tpu.parallel.step import augment_step, make_augment_step, sample_step_params
    from torchio_tpu_torch.parallel import sample_step_params as port_params

    tj.seed(0)
    b = 8
    spatial = (8, 16, 16)
    data = np.random.default_rng(0).random((b, 1, *spatial), np.float32)
    rotations, shifts = sample_step_params(b, degrees=10.0, translation=1.0)
    tt.seed(0)
    port_rot, port_shift = port_params(b, degrees=10.0, translation=1.0)
    np.testing.assert_array_equal(port_rot, rotations)
    np.testing.assert_array_equal(port_shift, shifts)

    ref = np.asarray(
        augment_step(jnp.asarray(data), jnp.asarray(rotations), jnp.asarray(shifts),
                     jnp.int32(7), bias_std=0.3, noise_std=0.05)
    )
    mesh = jax_mesh()
    jax_out = make_augment_step(mesh)(
        jax.device_put(jnp.asarray(data), batch_sharding(mesh)), jnp.asarray(rotations),
        jnp.asarray(shifts), jnp.int32(7),
    )
    results = pool.run("step", data, rotations, shifts, 7, None)
    for r in results:
        np.testing.assert_allclose(r["out"], ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"], np.asarray(jax_out), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["unsharded"], ref, rtol=1e-5, atol=1e-6)
        # the output really is sharded: B over data, J over space
        assert r["placements"] == ["Shard(dim=0)", "Shard(dim=3)"]
        assert r["local_shape"] == (4, 1, 8, 8, 16)
        # one halo exchange, one all_reduce for each statistic, no gather
        assert r["spy"]["gathers"] == []
    assert [len(r["spy"]["p2p"]) for r in results] == [1] * WORLD


# --------------------------------------------------------------------------
# Halo blur
# --------------------------------------------------------------------------


def test_halo_blur_matches_local(pool):
    from torchio_tpu.ops.gaussian import gaussian_kernel_1d, radius_for_sigma
    from torchio_tpu.parallel.halo import halo_blur

    data = np.random.default_rng(1).random((4, 1, 8, 16, 16)).astype(np.float32)
    radius = radius_for_sigma(1.5)
    k = gaussian_kernel_1d(1.5, radius)
    padded = np.pad(data, [(0, 0), (0, 0), (0, 0), (radius, radius), (0, 0)], mode="edge")
    expected = np.zeros_like(data)
    for tap in range(2 * radius + 1):
        expected += k[tap] * padded[:, :, :, tap : tap + data.shape[3], :]
    mesh = jax_mesh(2)
    jax_out = np.asarray(halo_blur(jax_put(data, mesh), sigma=1.5, mesh=mesh))
    results = pool.run("halo_blur", data, 1.5, 2)
    for r in results:
        np.testing.assert_allclose(r["out"], expected, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["out"], jax_out, rtol=1e-5, atol=1e-6)
        assert r["placements"] == ["Shard(dim=0)", "Shard(dim=3)"]
    assert_no_gather(results, exchanges=1, space=2)
    # four slabs of 4 rows: the middle ranks take halos from both sides
    data = np.random.default_rng(1).random((2, 2, 6, 16, 5)).astype(np.float32)
    mesh = jax_mesh(4)
    jax_out = np.asarray(halo_blur(jax_put(data, mesh), sigma=1.0, mesh=mesh))
    results = pool.run("halo_blur", data, 1.0, 4)
    for r in results:
        np.testing.assert_allclose(r["out"], jax_out, rtol=1e-5, atol=1e-6)
    assert_no_gather(results, exchanges=1, space=4)


# --------------------------------------------------------------------------
# Halo resample
# --------------------------------------------------------------------------


def test_halo_resample_affine_matches_unsharded(pool):
    from torchio_tpu.ops.resample import build_coords, resample
    from torchio_tpu.parallel.halo import halo_resample_affine

    b, c, si, sj, sk = 4, 1, 16, 32, 16
    x = np.random.default_rng(5).random((b, c, si, sj, sk), np.float32)
    m = rotation_matrix(7.0)
    expected = np.asarray(
        resample(jnp.asarray(x), build_coords((si, sj, sk), m), mode="linear", fill=0.0)
    )
    mesh = jax_mesh(2)
    jax_out = np.asarray(halo_resample_affine(jax_put(x, mesh), m, mesh))
    results = pool.run("halo_affine", x, m, 2)
    for r in results:
        np.testing.assert_allclose(r["out"], expected, atol=1e-5)
        np.testing.assert_allclose(r["out"], jax_out, atol=1e-5)
    assert_no_gather(results, exchanges=1, space=2)


def test_halo_resample_affine_nearest(pool):
    from torchio_tpu.parallel.halo import halo_resample_affine

    x = np.random.default_rng(6).random((2, 2, 8, 32, 8), np.float32)
    m = rotation_matrix(5.0, shift=(0.25, 1.0, -0.5))
    mesh = jax_mesh(4)
    jax_out = np.asarray(halo_resample_affine(jax_put(x, mesh), m, mesh, mode="nearest"))
    results = pool.run("halo_affine", x, m, 4, "nearest")
    for r in results:
        np.testing.assert_allclose(r["out"], jax_out, atol=1e-5)
    assert_no_gather(results, exchanges=1, space=4)


@pytest.mark.parametrize(
    "shape, matrix_shift, match",
    [
        ((4, 1, 8, 16, 8), 50.0, "[Hh]alo"),  # J displacement far beyond the shard
        ((2, 1, 8, 9, 8), 0.0, "not divisible"),  # J = 9 over 2 shards
    ],
    ids=["oversized-halo", "indivisible-j"],
)
def test_halo_resample_affine_guards(pool, shape, matrix_shift, match):
    from torchio_tpu.parallel.halo import halo_resample_affine

    m = np.eye(4)
    m[1, 3] = matrix_shift
    x = np.zeros(shape, np.float32)
    mesh = jax_mesh(2)
    with pytest.raises(ValueError, match=match) as jax_error:
        halo_resample_affine(jnp.asarray(x), m, mesh)
    for r in pool.run("halo_affine", x, m, 2):
        assert r["error"].endswith(str(jax_error.value)), r


def _jax_spec_sharding(spec, mesh):
    from jax.sharding import NamedSharding, PartitionSpec

    return "cpu" if spec == "cpu" else NamedSharding(mesh, PartitionSpec(*spec))


@pytest.mark.parametrize(
    "shape, n_mats, cps, spec, match",
    [
        ((4, 1, 4, 16, 4), 4, None, "cpu", "NamedSharding"),
        ((4, 1, 4, 16, 4), 4, None, ("data",), "not spatially sharded"),
        ((4, 1, 4, 16, 4), 4, None, (None, "data", None, "space", None), "unsupported partition"),
        ((4, 1, 4, 15, 4), 4, None, ("data", None, None, "space", None), "J=15"),
        ((3, 1, 4, 16, 4), 3, None, ("data", None, None, "space", None), "B=3"),
        ((4, 1, 4, 16, 4), 2, None, ("data", None, None, "space", None), "4x4 matrices"),
        ((4, 1, 4, 16, 4), 4, "differ", ("data", None, None, "space", None),
         "control-point fields differ"),
    ],
    ids=["not-named", "batch-only", "weird-spec", "j15", "b3", "matrix-count", "cp-shapes"],
)
def test_halo_resample_spec_guards(pool, shape, n_mats, cps, spec, match):
    """Every guard raises HaloUnsupported with the JAX package's message."""
    from torchio_tpu.parallel.halo import HaloUnsupported, halo_resample_spec

    x = np.zeros(shape, np.float32)
    mats = [np.eye(4)] * n_mats
    if cps == "differ":
        cps = [np.zeros((2, 2, 2, 3), np.float32), np.zeros((3, 3, 3, 3), np.float32), None, None]
    else:
        cps = [None] * n_mats
    with pytest.raises(HaloUnsupported, match=match) as jax_error:
        halo_resample_spec(jnp.asarray(x), mats, cps, sharding=_jax_spec_sharding(spec, jax_mesh()))
    for r in pool.run("halo_spec", x, mats, cps, spec, 0.0, None):
        assert r["error"].startswith("HaloUnsupported: ") and re.search(match, r["error"])
        if "partition" not in match:  # the spec prints as a tuple, not a PartitionSpec
            assert r["error"] == f"HaloUnsupported: {jax_error.value}"


@pytest.mark.parametrize("fill", [7.5, 0.0], ids=["host-fill", "no-fill"])
def test_halo_resample_spec_fill(pool, fill):
    """A non-zero host fill broadcasts to (B, C) rows and masks in the
    global frame."""
    from torchio_tpu.ops.resample import resample_fused
    from torchio_tpu.parallel.halo import halo_resample_spec

    x = np.random.default_rng(0).random((4, 1, 4, 16, 4)).astype(np.float32)
    m = np.eye(4)
    m[1, 3] = 2.5
    ref = np.asarray(resample_fused(jnp.asarray(x), [m] * 4, [None] * 4, fill=fill, use_f16=False))
    spec = ("data", None, None, "space", None)
    mesh = jax_mesh()
    sharding = _jax_spec_sharding(spec, mesh)
    jax_out = np.asarray(
        halo_resample_spec(jax.device_put(jnp.asarray(x), sharding), [m] * 4, [None] * 4,
                           sharding=sharding, fill=fill)
    )
    results = pool.run("halo_spec", x, [m] * 4, [None] * 4, spec, fill, None)
    for r in results:
        np.testing.assert_allclose(r["out"], ref, atol=1e-5)
        np.testing.assert_allclose(r["out"], jax_out, atol=1e-5)
    assert_no_gather(results, exchanges=1, space=2)


def test_halo_resample_spec_elastic(pool):
    """Per-element maps and coarse fields: the slab rows of each field,
    the halo from the maps and the fields, equal to the JAX program."""
    from torchio_tpu.ops.resample import resample_fused
    from torchio_tpu.parallel.halo import halo_resample_spec

    rng = np.random.default_rng(8)
    x = rng.random((4, 2, 10, 32, 12)).astype(np.float32)
    mats = [rotation_matrix(d, shift=(0.5, 0.25 * d, -1.0)) for d in (-6.0, -2.0, 3.0, 5.0)]
    cps = [rng.uniform(-1.5, 1.5, (5, 5, 5, 3)).astype(np.float32) for _ in range(3)] + [None]
    ref = np.asarray(resample_fused(jnp.asarray(x), mats, cps, fill=0.0, use_f16=False))
    spec = ("data", None, None, "space", None)
    mesh = jax_mesh()
    sharding = _jax_spec_sharding(spec, mesh)
    jax_out = np.asarray(
        halo_resample_spec(jax.device_put(jnp.asarray(x), sharding), mats, cps,
                           sharding=sharding, fill=-1.0)
    )
    results = pool.run("halo_spec", x, mats, cps, spec, -1.0, None)
    for r in results:
        np.testing.assert_allclose(r["out"], jax_out, atol=1e-5)
    assert_no_gather(results, exchanges=1, space=2)
    for r in pool.run("halo_spec", x, mats, cps, spec, 0.0, None):
        np.testing.assert_allclose(r["out"], ref, atol=1e-5)


def test_upsample_field_slab_matches_global():
    """Rows of the slab upsample equal the same rows of the global
    upsample (and the JAX package's slab), size-1 axes included."""
    from torchio_tpu.ops.resample import upsample_field
    from torchio_tpu.parallel.halo import _upsample_field_slab as jax_slab
    from torchio_tpu_torch.ops.resample import upsample_field as port_upsample
    from torchio_tpu_torch.parallel.halo import _upsample_field_slab

    rng = np.random.default_rng(42)
    cp = rng.uniform(-2.0, 2.0, (3, 3, 3, 3)).astype(np.float32)
    for out_shape in [(1, 4, 1), (4, 1, 4)]:
        full = np.asarray(upsample_field(jnp.asarray(cp), out_shape))
        slab = _upsample_field_slab(cp, out_shape, 0, out_shape[1]).numpy()
        np.testing.assert_allclose(slab, full, atol=1e-5)
    cp = rng.uniform(-2.0, 2.0, (5, 4, 6, 3)).astype(np.float32)
    whole = port_upsample(torch.as_tensor(cp), (9, 24, 7)).numpy()
    for j0, jl in ((0, 6), (6, 6), (12, 12), (18, 6)):
        slab = _upsample_field_slab(torch.as_tensor(cp), (9, 24, 7), j0, jl).numpy()
        np.testing.assert_array_equal(slab, whole[:, j0:j0 + jl])
        np.testing.assert_allclose(slab, np.asarray(jax_slab(cp, (9, 24, 7), j0, jl)), atol=1e-6)


def test_spatial_shard_axis():
    from torchio_tpu_torch.parallel.mesh import NamedSharding
    from torchio_tpu_torch.transforms.spatial.spatial import _spatial_shard_axis

    sharding = NamedSharding(object(), (None, None, None, "space", None))
    assert _spatial_shard_axis(sharding) == "space"
    assert _spatial_shard_axis(NamedSharding(object(), ("data",))) is None
    assert _spatial_shard_axis(object()) is None


# --------------------------------------------------------------------------
# The public Spatial and Blur on a J-sharded batch
# --------------------------------------------------------------------------


def jax_batch(images: dict, classes: dict | None = None):
    from torchio_tpu.data.batch import SubjectsBatch

    classes = classes or {}
    b = next(iter(images.values())).shape[0]
    subjects = []
    for e in range(b):
        kwargs = {
            name: (tj.LabelMap if classes.get(name) == "label" else tj.ScalarImage)(arr[e])
            for name, arr in images.items()
        }
        subjects.append(tj.Subject(**kwargs))
    batch = SubjectsBatch.from_subjects(subjects)
    for ib in batch.images.values():
        ib.data = jnp.asarray(ib.data)
    return batch


def jax_pipeline(recipe: str):
    if recipe == "spatial":
        return tj.Spatial(degrees=(-10.0, 10.0), max_displacement=2.0, num_control_points=5)
    if recipe == "spatial-wide":
        return tj.Spatial(degrees=(25.0, 25.0), translation=(20.0, 20.0))
    if recipe == "label-affine":
        return tj.Affine(degrees=(-8.0, 8.0), label_interpolation="label")
    if recipe == "headline-blur":
        return tj.Compose([
            tj.Spatial(degrees=(-10.0, 10.0), max_displacement=2.0, num_control_points=5),
            tj.BiasField(std=0.4),
            tj.Noise(std=0.05),
            tj.Blur(std=(0.5, 1.5)),
        ], fuse=True)
    if recipe == "blur-shared":
        return tj.Blur(std=(1.0, 1.5), per_instance=False)
    raise KeyError(recipe)


def run_jax(recipe, images, classes, seed, mesh=None, spatial=False):
    batch = jax_batch(images, classes)
    if mesh is not None:
        batch.shard_(mesh, spatial=spatial)
    tj.seed(seed)
    return jax_pipeline(recipe)(batch)


def test_public_spatial_uses_halo_kernel(pool):
    images = {"t1": np.random.default_rng(11).random((4, 1, 8, 32, 12)).astype(np.float32)}
    ref = np.asarray(run_jax("spatial", images, {}, 3).images["t1"].data)
    jax_sharded = run_jax("spatial", images, {}, 3, jax_mesh(), spatial=True)
    results = pool.run("public", "spatial", images, {}, 3, True, None)
    for r in results:
        assert r["halo_calls"] == ["linear"], "sharded Spatial did not route to the halo program"
        assert r["warnings"] == []
        np.testing.assert_allclose(r["images"]["t1"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            r["images"]["t1"], np.asarray(jax_sharded.images["t1"].data), rtol=1e-5, atol=1e-5
        )
        # the output is still on the mesh
        assert r["sharded"]["t1"]
        assert r["placements"]["t1"] == ["Shard(dim=0)", "Shard(dim=3)"]
        assert r["history"] == ["Spatial"]
    # the "minimum" fill's all_reduce aside, the Spatial moved only halos
    assert_no_gather(results, exchanges=1, space=2)


def test_label_map_partial_volume_sharded(pool):
    """Label maps take the gather path (as the JAX package's vote does)
    and equal the unsharded result."""
    seg = np.random.default_rng(12).integers(0, 4, (4, 1, 8, 32, 8)).astype(np.int32)
    images, classes = {"seg": seg}, {"seg": "label"}
    ref = np.asarray(run_jax("label-affine", images, classes, 9).images["seg"].data)
    for r in pool.run("public", "label-affine", images, classes, 9, True, None):
        np.testing.assert_array_equal(r["images"]["seg"], ref)
        assert r["halo_calls"] == []
        assert r["sharded"]["seg"]


def test_fallback_when_halo_too_wide(pool):
    """A translation larger than the shard width falls back to the
    all-gather path with the JAX package's warning: never a wrong answer."""
    images = {"t1": np.random.default_rng(11).random((4, 1, 8, 32, 12)).astype(np.float32)}
    ref = np.asarray(run_jax("spatial-wide", images, {}, 5).images["t1"].data)
    with pytest.warns(RuntimeWarning, match="fell back") as jax_warnings:
        run_jax("spatial-wide", images, {}, 5, jax_mesh(), spatial=True)
    jax_message = next(str(w.message) for w in jax_warnings if "fell back" in str(w.message))
    for r in pool.run("public", "spatial-wide", images, {}, 5, True, None):
        assert r["warnings"] == [jax_message]
        np.testing.assert_allclose(r["images"]["t1"], ref, rtol=1e-5, atol=1e-5)
        assert r["sharded"]["t1"]


@pytest.mark.parametrize("recipe", ["headline-blur", "blur-shared"])
def test_blur_on_sharded_axis_takes_halo_taps(pool, recipe):
    """Blur (per element inside a fused chain, and batch-shared) on a
    J-sharded batch: taps over the exchanged halo along J, no gather in
    any stage (the BiasField + Noise run draws and multiplies each rank's
    region), equal to the JAX package's sharded and unsharded results."""
    images = {"t1": np.random.default_rng(13).random((4, 1, 10, 32, 12)).astype(np.float32)}
    ref = np.asarray(run_jax(recipe, images, {}, 21).images["t1"].data)
    jax_sharded = run_jax(recipe, images, {}, 21, jax_mesh(), spatial=True)
    results = pool.run("public", recipe, images, {}, 21, True, None)
    for r in results:
        np.testing.assert_allclose(r["images"]["t1"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            r["images"]["t1"], np.asarray(jax_sharded.images["t1"].data), rtol=1e-5, atol=1e-5
        )
        assert r["sharded"]["t1"]
        gathers = r["spy"]["gathers"]
        assert gathers == []
        if recipe == "blur-shared":
            assert r["spy"]["p2p"] == [p2p_expected(2)[0]]
        else:
            # Spatial: one exchange; BiasField + Noise: none; Blur: one exchange
            assert len(r["spy"]["p2p"]) == 2


def test_sharded_blur_axes_and_no_gather(pool):
    """``sharded_spatial_axes`` reads the DTensor's placements, and
    ``gaussian_blur`` on a J-sharded DTensor takes halo taps along J
    (band products along I and K), with no gather."""
    from torchio_tpu.ops.gaussian import gaussian_blur

    data = np.random.default_rng(2).random((4, 1, 8, 32, 8)).astype(np.float32)
    ref = np.asarray(gaussian_blur(jnp.asarray(data), (1.5, 1.5, 1.5)))
    results = pool.run("blur_axes", data, (1.5, 1.5, 1.5), None)
    for r in results:
        assert r["axes"] == (False, True, False)
        assert r["plain_axes"] == (False, False, False)
        np.testing.assert_allclose(r["out"], ref, rtol=1e-5, atol=1e-6)
    assert_no_gather(results, exchanges=1, space=2)


def test_collective_spy_sees_a_gather(pool):
    """The spy itself: a public stage without a sharded path (Lambda: the
    user's function sees whole tensors) gathers, and the spy counts it
    with the batch's elements (so an empty count above means no
    gather)."""
    images = {"t1": np.random.default_rng(3).random((4, 1, 6, 8, 6)).astype(np.float32)}
    for r in pool.run("public", "lambda", images, {}, 1, True, None):
        assert "DTensor.full_tensor" in r["spy"]["gathers"]
        assert 4 * 6 * 8 * 6 in r["spy"]["gather_elements"]
