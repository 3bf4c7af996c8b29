"""Port parity: the dense-coordinate entry (``build_coords``, ``resample``,
dense ``bspline_resample``) against the JAX package.

The same numpy volumes and coordinates go through both packages:

- ``build_coords``: equal to the JAX expression evaluated without
  contraction, and to the JAX package's own result wherever the map is
  axis-aligned; XLA:CPU contracts its sums into fused multiply-adds, so a
  rotated map's coordinates may differ from it by one float32 ulp;
- plain ``resample`` against ``torchio_tpu.ops.resample`` (the XLA
  gather) within 1e-5, nearest equal;
- plain ``resample`` against the JAX package's Pallas kernel for dense
  coordinates, ``pallas_resample(..., interpret=True)``, within 1e-4,
  that kernel's own tolerance (``tests/test_pallas_resample.py``);
- plain dense ``bspline_resample`` against the JAX package's within 2e-5
  (orders 2-3) and 5e-5 (orders 4-7).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu.config as jax_config
import torchio_tpu.ops as jops
import torchio_tpu_torch as tt
import torchio_tpu_torch.ops as tops
from test_torch_resample import _rot
from torchio_tpu.ops.bspline import bspline_resample as jax_bspline_resample
from torchio_tpu.ops.pallas_resample import pallas_resample
from torchio_tpu.transforms.intensity.motion import _rigid_voxel_matrix
from torchio_tpu_torch.ops import bspline as bs
from torchio_tpu_torch.transforms.spatial.spatial import _dispatch_resample

# the ops package exports the function ``resample`` under its module's name
rs = importlib.import_module("torchio_tpu_torch.ops.resample")


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather: its
    opt-in float16 gather (left on for the rest of a process by importing
    ``bench.py``, as ``tests/test_parallel.py`` does) rounds the corner
    values by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


GATHER_ATOL = 1e-5
PALLAS_ATOL = 1e-4
SPLINE_ATOL = {2: 2e-5, 3: 2e-5, 4: 5e-5, 5: 5e-5, 6: 5e-5, 7: 5e-5}

IN_SHAPE = (12, 14, 20)
OUT_SHAPE = (13, 11, 22)  # unlike the input: up- and down-sampled axes


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build grids and fields from host data and compare on
    the CPU: ask the port to put host data there (its default is the
    card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def _volume(b=2, c=2, shape=IN_SHAPE, seed=0):
    return np.random.default_rng(seed).random((b, c, *shape), np.float32)


def _coords(in_shape, out_shape, per_element: bool, b=2, shift=(0.0, 0.0, 0.0)):
    """Rotated, scaled and shifted grids whose borders leave the volume."""
    grids = [
        np.asarray(
            jops.build_coords(
                out_shape,
                _rot(*angles, scale=scale, shift=np.add(shift, offset), spatial=in_shape),
            )
        )
        for angles, scale, offset in (
            ((0.15, -0.1, 0.12), 1.08, (1.5, -2.0, 0.7)),
            ((-0.08, 0.17, -0.05), 0.93, (-3.0, 1.0, 2.5)),
        )[:b]
    ]
    return np.stack(grids) if per_element else grids[0]


MATRICES = {
    "axis-aligned": np.array(
        [[1.1, 0, 0, -1.0], [0, 0.9, 0, 0.5], [0, 0, 1.25, 2.3], [0, 0, 0, 1]]
    ),
    "rotated": _rot(0.2, -0.1, 0.3, scale=1.05, shift=(1.0, -2.0, 0.5), spatial=IN_SHAPE),
    "motion": _rigid_voxel_matrix([3.1, -2.2, 4.5], [1.2, -2.5, 0.7], IN_SHAPE),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_build_coords_matches_jax(name):
    m = MATRICES[name]
    got = tops.build_coords(OUT_SHAPE, m)
    assert got.dtype == torch.float32 and got.shape == (*OUT_SHAPE, 3)
    got = got.numpy()
    mf = m[:3].astype(np.float32)
    ri, rj, rk = (
        np.arange(n, dtype=np.float32).reshape([-1 if a == d else 1 for a in range(4)])
        for d, n in enumerate(OUT_SHAPE)
    )
    uncontracted = ((ri * mf[:, 0] + rj * mf[:, 1]) + rk * mf[:, 2]) + mf[:, 3]
    np.testing.assert_array_equal(got, uncontracted)
    want = np.asarray(jops.build_coords(OUT_SHAPE, m))
    if name == "axis-aligned":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.abs(want).max()))


FILLS = {
    "zero": 0.0,
    "scalar": 1.5,
    "per-channel": np.array([0.5, -1.0], np.float32),
    "per-element": np.array([[0.25, -1.0], [2.0, 0.75]], np.float32),
}


@pytest.mark.parametrize("fill", list(FILLS))
@pytest.mark.parametrize("grid", ["shared", "per-element"])
@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_resample_matches_jax_gather(mode, grid, fill):
    vol = _volume()
    coords = _coords(IN_SHAPE, OUT_SHAPE, grid == "per-element")
    want = np.asarray(jops.resample(vol, coords, mode=mode, fill=FILLS[fill]))
    got = tops.resample(torch.as_tensor(vol), coords, mode=mode, fill=FILLS[fill])
    assert got.dtype == torch.float32 and got.shape == (2, 2, *OUT_SHAPE)
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GATHER_ATOL)
    # the border of the grids leaves the volume: the fill (or the zero
    # padding's partial sums) is exercised
    outside = (coords < -1) | (coords > np.array(IN_SHAPE))
    assert outside.any(axis=-1).mean() > 0.05


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("shape", [(12, 14, 1), (1, 14, 20)], ids=["k1", "i1"])
def test_resample_size_one_axes_match_jax(shape, mode):
    vol = _volume(shape=shape, seed=1)
    coords = _coords(shape, shape, per_element=True)
    for fill in (0.0, 0.5):
        want = np.asarray(jops.resample(vol, coords, mode=mode, fill=fill))
        got = tops.resample(torch.as_tensor(vol), coords, mode=mode, fill=fill).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GATHER_ATOL)


def test_resample_tensor_fill_matches_jax():
    vol = _volume(seed=2)
    coords = _coords(IN_SHAPE, OUT_SHAPE, per_element=True)
    fill = vol.min(axis=(2, 3, 4))
    want = np.asarray(jops.resample(vol, coords, fill=jnp.asarray(fill)))
    got = tops.resample(torch.as_tensor(vol), coords, fill=torch.as_tensor(fill))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GATHER_ATOL)


PALLAS_SHAPE = (16, 16, 24)


@pytest.mark.parametrize(
    "mode,fill,max_tiles",
    [("linear", 0.0, None), ("nearest", 0.0, None), ("linear", 7.0, None),
     ("linear", 0.0, 1)],
    ids=["linear", "nearest", "fill", "chunked"],
)
def test_resample_matches_jax_pallas_interpret(mode, fill, max_tiles, monkeypatch):
    """The JAX package's tiled kernel for dense coordinates, run in the
    Pallas interpreter; ``max_tiles=1`` forces its chunked launches."""
    import torchio_tpu.ops.pallas_resample as pr

    if max_tiles is not None:
        monkeypatch.setattr(pr, "_MAX_TILES_PER_LAUNCH", max_tiles)
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(1, *PALLAS_SHAPE)).astype(np.float32)
    matrix = _rot(0.06, -0.04, 0.08, scale=1.03, shift=(0.8, -1.1, 0.4), spatial=PALLAS_SHAPE)
    if fill:
        matrix[0, 3] += 6.0  # push part of the grid out of the volume
    coords = np.asarray(jops.build_coords(PALLAS_SHAPE, matrix))
    want = np.asarray(
        pallas_resample(
            jnp.asarray(vol), jnp.asarray(coords), matrix, mode=mode, fill=fill,
            interpret=True,
        )
    )
    got = tops.resample(torch.as_tensor(vol[None]), coords, mode=mode, fill=fill)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=PALLAS_ATOL, atol=PALLAS_ATOL)


#: rows of brats' Ko = 155 (two k tiles of the dense spline kernel, the
#: second cut short)
KO155_SHAPE = (3, 4, 155)


@pytest.mark.parametrize("grid", ["shared", "per-element", "per-element Ko=155"])
@pytest.mark.parametrize("order", range(2, 8))
def test_bspline_resample_matches_jax(order, grid):
    vol = _volume(seed=4)
    out_shape = KO155_SHAPE if grid.endswith("155") else OUT_SHAPE
    coords = _coords(IN_SHAPE, out_shape, grid.startswith("per-element"))
    for fill in (0.5, FILLS["per-element"]):
        want = np.asarray(jax_bspline_resample(vol, coords, order=order, fill=fill))
        got = bs.bspline_resample(torch.as_tensor(vol), coords, order=order, fill=fill)
        assert got.dtype == torch.float32 and got.shape == (2, 2, *out_shape)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SPLINE_ATOL[order])


@pytest.mark.parametrize("mode", ["nearest", "linear", "cubic", "seventh"])
def test_dispatch_routes_dense_coords(mode, monkeypatch):
    """Orders 0-1 go to ``resample``, orders 2-7 to ``bspline_resample``."""
    import torchio_tpu_torch.transforms.spatial.spatial as sp

    calls = []
    for name in ("resample", "bspline_resample"):
        real = getattr(sp, name)
        monkeypatch.setattr(
            sp, name, lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k)
        )
    vol = torch.as_tensor(_volume(seed=5))
    coords = torch.as_tensor(_coords(IN_SHAPE, OUT_SHAPE, per_element=True))
    got = _dispatch_resample(vol, coords, mode=mode, fill=0.25)
    order = {"nearest": 0, "linear": 1, "cubic": 3, "seventh": 7}[mode]
    if order >= 2:
        assert calls == ["bspline_resample"]
        want = bs.bspline_resample(vol, coords, order=order, fill=0.25)
    else:
        assert calls == ["resample"]
        want = rs.resample(vol, coords, mode=mode, fill=0.25)
    assert torch.equal(got, want)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"mode": "cubic"}, "Unsupported resampling mode"),
        ({"coords": np.zeros((2, 3, 4))}, "coords must be"),
        ({"coords": np.zeros((3, 2, 3, 4, 3))}, "coords must be"),
        ({"coords": np.zeros((2, 3, 4, 2))}, "coords must be"),
        ({"fill": np.zeros((2, 3))}, "2D fill must have shape"),
        ({"fill": np.zeros(3)}, "fill must be scalar"),
        ({"fill": torch.zeros((1, 2, 2))}, "fill must be scalar"),
    ],
)
def test_resample_rejects_what_the_jax_package_rejects(kwargs, match):
    args = {"data": torch.zeros((2, 2, 4, 4, 4)), "coords": np.zeros((3, 3, 3, 3)),
            "mode": "linear", "fill": 0.0}
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        rs.resample(args.pop("data"), args.pop("coords"), **args)


def test_bspline_resample_rejects_bad_orders_and_devices():
    coords = np.zeros((3, 3, 3, 3))
    with pytest.raises(ValueError, match="order must be 2-7"):
        bs.bspline_resample(torch.zeros((1, 1, 4, 4, 4)), coords, order=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bs.bspline_resample(torch.zeros((1, 1, 4, 4, 4), device="meta"), coords, order=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs.resample(torch.zeros((1, 1, 4, 4, 4), device="meta"), coords)


def test_dense_kernel_wrappers_reject_cpu_tensors():
    from torchio_tpu_torch.ops.bspline_kernel import bspline_coords_cuda
    from torchio_tpu_torch.ops.resample_kernel import resample_coords_cuda

    vol, coords, fill = torch.zeros((1, 1, 4, 4, 4)), torch.zeros((1, 3, 3, 3, 3)), torch.zeros((1, 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        resample_coords_cuda(vol, coords, fill, "linear", False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bspline_coords_cuda(vol, coords, fill, 3)


def test_ops_exports_follow_the_jax_package():
    assert set(tops.__all__) == set(jops.__all__)
    upsampled = tops.upsample_field(np.ones((4, 4, 4, 3), np.float32), (7, 5, 9))
    np.testing.assert_array_equal(
        upsampled.numpy(), np.asarray(jops.upsample_field(jnp.ones((4, 4, 4, 3)), (7, 5, 9)))
    )
