"""Port parity: the batch API on a mesh, the subject sampler, sharded
patch inference and the file-to-file pipeline, on 4 gloo ranks against
the JAX package on 4 virtual CPU devices in the same layout (see
``tests/test_torch_parallel.py`` for the pool and the collective spy).

Also: the public names of ``torchio_tpu_torch.parallel`` are the JAX
package's, and every module of the JAX package but its three Pallas
files has a twin in the port.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import jax
import jax.numpy as jnp

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from _torch_dist import RankPool

WORLD = 4
ROOT = Path(__file__).resolve().parent.parent


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


def jax_put(x, mesh, spec):
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, PartitionSpec(*spec)))


def jax_batch(images: dict, affines=None):
    from torchio_tpu.data.batch import SubjectsBatch

    b = next(iter(images.values())).shape[0]
    subjects = []
    for e in range(b):
        kwargs = {}
        for name, arr in images.items():
            if affines is None:
                kwargs[name] = tj.ScalarImage(arr[e])
            else:
                kwargs[name] = tj.ScalarImage(arr[e], affine=affines[e])
        subjects.append(tj.Subject(**kwargs))
    batch = SubjectsBatch.from_subjects(subjects)
    for ib in batch.images.values():
        ib.data = jnp.asarray(ib.data)
    return batch


def jax_public():
    return tj.Compose([
        tj.Affine(degrees=(-10.0, 10.0), scales=(0.95, 1.05)),
        tj.BiasField(std=0.4),
        tj.Noise(std=0.05),
        tj.RescaleIntensity(out_min=0.0, out_max=1.0),
    ])


def p2p_ops(space: int, rank: int) -> int:
    s = rank % space
    return 2 * ((s > 0) + (s < space - 1))


# --------------------------------------------------------------------------
# The public pipeline on a sharded batch
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b, shape, spatial, seed",
    [(8, (10, 12, 14), False, 42), (4, (8, 16, 12), True, 7)],
    ids=["batch-axis", "spatial-axis"],
)
def test_sharded_compose_matches_single_device(pool, b, shape, spatial, seed):
    """``batch.shard_(mesh[, spatial=True])`` then ``Compose([...])(batch)``
    equals the unsharded result (and the JAX package's sharded one), with
    the output still on the mesh."""
    images = {"t1": np.random.default_rng(3).random((b, 1, *shape)).astype(np.float32)}
    tj.seed(seed)
    ref = np.asarray(jax_public()(jax_batch(images)).images["t1"].data)
    tj.seed(seed)
    jax_sharded = jax_public()(jax_batch(images).shard_(jax_mesh(), spatial=spatial))
    results = pool.run("public", "public", images, {}, seed, spatial, None)
    for r in results:
        np.testing.assert_allclose(r["images"]["t1"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            r["images"]["t1"], np.asarray(jax_sharded.images["t1"].data), rtol=1e-5, atol=1e-5
        )
        assert r["sharded"]["t1"]
        space = "Shard(dim=3)" if spatial else "Replicate()"
        assert r["placements"]["t1"] == ["Shard(dim=0)", space]
        assert r["history"] == [t.name for t in jax_sharded.applied_transforms]
        assert len(r["history"]) == 4
        assert r["halo_calls"] == (["linear"] if spatial else [])


def test_sharding_survives_deepcopy_and_copying_transform(pool):
    images = {"t1": np.random.default_rng(3).random((8, 1, 6, 8, 6)).astype(np.float32)}
    for r in pool.run("copy_unshard", images, None):
        assert r["dup_sharded"]
        assert r["out_sharded"]
        assert r["out_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert r["unbatched_equal"]
        # unshard_ stops enforcing the placement and leaves whole tensors
        assert r["unsharded"] and r["plain_after"]


def test_shard_with_named_sharding_and_drop(pool):
    """An explicit NamedSharding on a 1-D mesh; a batch-size change drops
    the sharding (tests/test_batch.py's shard/drop)."""
    data = np.random.default_rng(0).random((4, 1, 4, 4, 4)).astype(np.float32)
    for r in pool.run("shard_drop", data):
        assert r["placed"] == (["Shard(dim=0)"], (1, 1, 4, 4, 4))
        assert r["dropped"]
        assert r["shape"] == (3, 1, 4, 4, 4)


def test_sharded_resample_matches_single_device(pool):
    """An axis-aligned new space (Resample to 1 mm) runs on the whole
    tensor and comes back placed, equal to the unsharded result."""
    from torchio_tpu.core.affine import AffineMatrix as JaxAffine

    rng = np.random.default_rng(9)
    images = {"t1": rng.random((8, 1, 10, 12, 6)).astype(np.float32)}
    affines = [np.diag([1.0, 1.0, 2.0, 1.0])] * 8
    tj.seed(1)
    jax_affines = [JaxAffine.from_spacing((1.0, 1.0, 2.0))] * 8
    ref = np.asarray(tj.Resample(target=1.0)(jax_batch(images, jax_affines)).images["t1"].data)
    for r in pool.run("public", "resample", images, {}, 1, False, None, affines):
        assert r["images"]["t1"].shape == ref.shape == (8, 1, 10, 12, 12)
        np.testing.assert_allclose(r["images"]["t1"], ref, rtol=1e-5, atol=1e-6)
        assert r["sharded"]["t1"]
        assert r["halo_calls"] == []


# --------------------------------------------------------------------------
# DistributedSubjectSampler
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n, world, kwargs",
    [
        (10, 4, {"shuffle": False}),
        (10, 4, {"shuffle": False, "drop_last": True}),
        (12, 3, {"seed": 5}),
        (13, 4, {"seed": 2}),
        (7, 2, {"seed": 11, "drop_last": True}),
    ],
    ids=["wrap", "drop-last", "shuffle", "shuffle-wrap", "shuffle-drop"],
)
def test_sampler_orders_bit_equal(n, world, kwargs):
    from torchio_tpu.parallel import DistributedSubjectSampler as JaxSampler
    from torchio_tpu_torch.parallel import DistributedSubjectSampler

    for epoch in range(3):
        for rank in range(world):
            ours = DistributedSubjectSampler(n, rank=rank, world_size=world, **kwargs)
            theirs = JaxSampler(n, rank=rank, world_size=world, **kwargs)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)
            assert len(ours) == len(theirs)


def test_sampler_coverage_and_epochs():
    from torchio_tpu_torch.parallel import DistributedSubjectSampler

    shards = [list(DistributedSubjectSampler(10, rank=r, world_size=4, shuffle=False))
              for r in range(4)]
    assert all(len(s) == 3 for s in shards)
    assert set().union(*map(set, shards)) == set(range(10))
    dropped = [list(DistributedSubjectSampler(10, rank=r, world_size=4, shuffle=False,
                                              drop_last=True)) for r in range(4)]
    assert all(len(s) == 2 for s in dropped)
    assert len(set().union(*map(set, dropped))) == 8

    def shard(rank, epoch):
        s = DistributedSubjectSampler(12, rank=rank, world_size=3, seed=5)
        s.set_epoch(epoch)
        return list(s)

    assert len(set().union(*(set(shard(r, 0)) for r in range(3)))) == 12
    assert shard(0, 0) == shard(0, 0)
    assert shard(0, 0) != shard(0, 1)
    with pytest.raises(ValueError, match="outside world"):
        DistributedSubjectSampler(4, rank=4, world_size=4)


def test_sampler_defaults_read_the_process_group(pool):
    from torchio_tpu_torch.parallel import DistributedSubjectSampler

    # without a process group: rank 0 of 1, as jax.process_index() alone
    plain = DistributedSubjectSampler(5, shuffle=False)
    assert (plain.rank, plain.world_size, list(plain)) == (0, 1, [0, 1, 2, 3, 4])
    results = pool.run("sampler_defaults", 10)
    assert [(r["rank"], r["world"]) for r in results] == [(r, WORLD) for r in range(WORLD)]
    assert [r["order"] for r in results] == [
        list(DistributedSubjectSampler(10, rank=r, world_size=WORLD, shuffle=False))
        for r in range(WORLD)
    ]


def test_sampler_queue_integration():
    """Each rank's Queue sees its own disjoint subjects, as in the JAX
    package."""
    from torchio_tpu_torch.parallel import DistributedSubjectSampler

    rng = np.random.default_rng(42)
    subjects = []
    for i in range(6):
        s = tt.Subject(t1=tt.ScalarImage(rng.random((1, 6, 6, 6)).astype(np.float32)))
        s["sid"] = i
        subjects.append(s)
    seen = []
    for r in range(2):
        sampler = DistributedSubjectSampler(6, rank=r, world_size=2, shuffle=False)
        queue = tt.Queue(
            subjects,
            patch_sampler=tt.UniformSampler(patch_size=4),
            patches_per_volume=1,
            shuffle_subjects=False,
            subject_sampler=sampler,
        )
        seen.append({p.metadata["sid"] for p in queue})
    assert seen[0] | seen[1] == set(range(6))
    assert seen[0].isdisjoint(seen[1])


# --------------------------------------------------------------------------
# Sharded patch inference
# --------------------------------------------------------------------------


def single_device(vol, patch_size, overlap, mode, model=None):
    """The JAX package's GridSampler -> PatchAggregator, element by element."""
    from torchio_tpu.data.aggregator import PatchAggregator
    from torchio_tpu.data.patch import PatchLocation
    from torchio_tpu.parallel.patches import grid_corners

    corners = grid_corners(vol.shape[2:], patch_size, (overlap,) * 3)
    outs = []
    for e in range(vol.shape[0]):
        agg = PatchAggregator(vol.shape[2:], overlap_mode=mode)
        for c0 in corners:
            sl = tuple(slice(int(c0[d]), int(c0[d]) + patch_size[d]) for d in range(3))
            patch = vol[e][(slice(None), *sl)]
            if model is not None:
                patch = model(patch)
            agg.add_batch(
                patch[None], [PatchLocation(index=tuple(int(v) for v in c0), size=patch_size)]
            )
        outs.append(np.asarray(agg.get_output()))
    return np.stack(outs)


def jax_inference(vol, **kwargs):
    from torchio_tpu.parallel.patches import sharded_grid_inference

    mesh = jax_mesh()
    if vol.shape[3] % 2 == 0:
        vol = jax_put(vol, mesh, (None, None, None, "space", None))
    return np.asarray(sharded_grid_inference(jnp.asarray(vol), mesh=mesh, **kwargs))


@pytest.mark.parametrize(
    "mode, model, overlap, b",
    [("hann", None, 4, 2), ("average", None, 4, 2), ("average", "affine", 2, 1)],
    ids=["hann", "average", "model"],
)
def test_sharded_inference_matches_single_device(pool, mode, model, overlap, b):
    vol = np.random.default_rng(21).random((b, 1, 10, 48, 12), np.float32)
    fn = (lambda x: 2.0 * x + 1.0) if model else None
    expected = single_device(vol, (6, 8, 6), overlap, mode, model=fn)
    jax_out = jax_inference(vol, model_fn=fn, patch_size=(6, 8, 6), patch_overlap=overlap,
                            overlap_mode=mode)
    results = pool.run("grid_inference", vol, (6, 8, 6), overlap, mode, model, None)
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r["out"], expected, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["out"], jax_out, rtol=1e-5, atol=1e-6)
        assert r["placements"] == ["Replicate()", "Shard(dim=3)"]
        assert r["local_shape"] == (b, 1, 10, 24, 12)
        # the halo exchange and the two folds: no gather
        assert r["spy"]["gathers"] == []
        assert r["spy"]["p2p"] == [p2p_ops(2, rank)] * 3


@pytest.mark.parametrize(
    "shape, patch, mode, match",
    [
        ((2, 1, 8, 16, 8), (4, 12, 4), "hann", "exceeds shard width"),
        ((2, 1, 10, 48, 12), 4, "crop", "hann"),
        ((1, 1, 8, 47, 8), 4, "average", "not divisible"),
    ],
    ids=["patch-wider-than-shard", "crop-mode", "indivisible-j"],
)
def test_sharded_inference_guards(pool, shape, patch, mode, match):
    from torchio_tpu.parallel.halo import HaloUnsupported

    vol = np.zeros(shape, np.float32)
    with pytest.raises(HaloUnsupported, match=match) as jax_error:
        jax_inference(vol, patch_size=patch, overlap_mode=mode)
    for r in pool.run("grid_inference", vol, patch, 0, mode, None, None):
        assert r["error"] == f"HaloUnsupported: {jax_error.value}"


def test_sharded_inference_int_patch_size(pool):
    vol = np.random.default_rng(4).random((1, 1, 8, 48, 8), np.float32)
    jax_out = jax_inference(vol, patch_size=4, patch_overlap=2, overlap_mode="average")
    for r in pool.run("grid_inference", vol, 4, 2, "average", None, None):
        assert r["out"].shape == vol.shape
        np.testing.assert_allclose(r["out"], jax_out, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Volumes from file to file
# --------------------------------------------------------------------------


def test_file_to_file_matches_unsharded(pool, tmp_path):
    from torchio_tpu.io.nifti import read_nifti, write_nifti
    from torchio_tpu.ops.gaussian import gaussian_kernel_1d, radius_for_sigma
    from torchio_tpu.ops.resample import build_coords, resample
    from torchio_tpu.parallel.large import process_large_volume

    rng = np.random.default_rng(3)
    shape = (12, 64, 10)
    vol = rng.random((1, *shape), np.float32)
    src = tmp_path / "big.nii"
    write_nifti(src, vol)
    theta = np.deg2rad(4.0)
    matrix = np.eye(4)
    matrix[0, 0] = matrix[1, 1] = np.cos(theta)
    matrix[0, 1], matrix[1, 0] = -np.sin(theta), np.sin(theta)
    sigma = 1.2
    ref = resample(jnp.asarray(vol)[None], build_coords(shape, matrix), mode="linear", fill=0.0)
    r = radius_for_sigma(sigma, 3.0)
    k = gaussian_kernel_1d(sigma, r)
    padded = np.pad(np.asarray(ref), ((0, 0), (0, 0), (0, 0), (r, r), (0, 0)), mode="edge")
    expected = sum(k[t] * padded[:, :, :, t : t + shape[1], :] for t in range(2 * r + 1))
    jax_dst = tmp_path / "jax.nii"
    process_large_volume(src, jax_dst, mesh=jax_mesh(4), matrix=matrix, sigma=sigma)
    jax_got, _ = read_nifti(jax_dst)

    dst = tmp_path / "out.nii"
    results = pool.run("large", str(src), str(dst), matrix, sigma, 4)
    for rank, result in enumerate(results):
        # each rank holds a 1/4 J slab only
        assert result["placements"] == ["Replicate()", "Shard(dim=3)"]
        assert result["local_shape"] == (1, 1, 12, 16, 10)
        # the region reads, the resample's and the blur's exchanges: no gather
        assert result["spy"]["gathers"] == []
        assert result["spy"]["p2p"] == [p2p_ops(4, rank)] * 2
    got, affine = read_nifti(dst)
    np.testing.assert_allclose(got, expected[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, jax_got, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(affine, np.eye(4))
    assert dst.read_bytes()[:348] == jax_dst.read_bytes()[:348]


def test_lazy_read_is_regional(pool, tmp_path):
    """Each rank's slab comes from its own region read: the backend is
    never asked for the whole J extent, and the image stays unloaded."""
    from torchio_tpu.io.nifti import write_nifti

    vol = np.random.default_rng(0).random((1, 8, 64, 8), np.float32)
    src = tmp_path / "v.nii"
    write_nifti(src, vol)
    for r in pool.run("lazy_read", str(src), 4):
        assert r["widths"] == [16]
        assert not r["loaded"]
        assert r["local_shape"] == (1, 1, 8, 16, 8)
        np.testing.assert_allclose(r["whole"][0], vol, rtol=1e-6)
    bad = tmp_path / "bad.nii"
    write_nifti(bad, np.zeros((1, 4, 10, 4), np.float32))  # J = 10 over 4 slabs
    for r in pool.run("lazy_read", str(bad), 4):
        assert r["error"] == "ValueError: J=10 not divisible by space=4"


def test_write_default_affine_and_multichannel(pool, tmp_path):
    from torchio_tpu.io.nifti import read_nifti

    data = np.random.default_rng(0).random((1, 2, 4, 16, 4)).astype(np.float32)
    out = tmp_path / "mc.nii"
    assert pool.run("write", data, str(out), 4) == [(1, 2, 4, 4, 4)] * WORLD
    got, affine = read_nifti(out)
    np.testing.assert_allclose(got, data[0], rtol=1e-6)
    np.testing.assert_allclose(affine, np.eye(4))


# --------------------------------------------------------------------------
# Names and files
# --------------------------------------------------------------------------


def test_parallel_public_names():
    import torchio_tpu.parallel as jax_parallel
    import torchio_tpu_torch.parallel as port_parallel

    assert port_parallel.__all__ == sorted(jax_parallel.__all__)
    for name in port_parallel.__all__:
        assert getattr(port_parallel, name) is not None
    with pytest.raises(AttributeError):
        port_parallel.not_a_name  # noqa: B018


def test_every_module_has_a_twin():
    """Every module of the JAX package has a counterpart of the same path
    in the port, but the three Pallas files (their kernels are ported to
    ``csrc/``), and no module of the port imports jax or the JAX package."""
    jax_files = {p.relative_to(ROOT / "torchio_tpu") for p in (ROOT / "torchio_tpu").rglob("*.py")}
    port_files = {
        p.relative_to(ROOT / "torchio_tpu_torch")
        for p in (ROOT / "torchio_tpu_torch").rglob("*.py")
    }
    missing = {str(p) for p in jax_files - port_files}
    assert missing == {
        "ops/pallas_resample.py", "ops/shear_resample.py", "ops/window_resample.py"
    }
    pattern = re.compile(r"^\s*(import jax|from jax|import torchio_tpu\b(?!_)|from torchio_tpu\b(?!_))",
                         re.M)
    for path in (ROOT / "torchio_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((ROOT / "tests" / "_torch_dist.py").read_text())
