"""Port parity: ``torchio_tpu_torch.ops.resample`` against the JAX package.

The port's plain resample (what a CPU batch runs, and what the CUDA
kernel is held to on the card) is compared with:

- the JAX package's XLA gather (``_resample_element_fused``), atol 1e-5;
- its Pallas kernels run in interpret mode on the CPU, as
  ``tests/test_shear_resample.py`` runs them: ``shear_resample_fused``
  (pre-shear + ``_kernel2``) and ``window_resample_fused``, atol 2e-5,
  that file's own tolerance.

Nearest mode is compared for equality away from .5 ties, where the two
float pipelines may round either way.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu.config as jax_config
from torchio_tpu.ops.resample import _resample_element_fused
from torchio_tpu.ops.shear_resample import shear_eligible, shear_resample_fused
from torchio_tpu.ops.window_resample import window_eligible, window_resample_fused

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
KERNEL_ATOL = 2e-5
TIE_BAND = 1e-4


def _rot(ax, ay, az, scale=1.0, shift=(0.0, 0.0, 0.0), spatial=None):
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = (rx @ ry @ rz) * scale
    c = (np.asarray(spatial, np.float64) - 1) / 2
    m[:3, 3] = c - m[:3, :3] @ c + np.asarray(shift, np.float64)
    return m


def _case(shape, *, out=None, mode="linear", fill=0.0, elastic=(True, False),
          angles=((0.15, -0.1, 0.12), (-0.08, 0.17, -0.05)), kernels=(), seed=0):
    rng = np.random.default_rng(seed)
    b, spatial = shape[0], shape[2:]
    data = rng.random(shape, np.float32)
    ms = [
        _rot(*angles[i], scale=(1.05, 0.95)[i], shift=rng.uniform(-2, 2, 3),
             spatial=spatial)
        for i in range(b)
    ]
    cps = [rng.uniform(-2, 2, (5, 5, 5, 3)) if elastic[i] else None for i in range(b)]
    return dict(data=data, ms=ms, cps=cps, out=tuple(out or spatial), mode=mode,
                fill=fill, kernels=kernels)


CASES = {
    "linear-scalar-fill": _case((2, 2, 16, 18, 40), fill=1.5, kernels=("shear",)),
    "nearest-no-fill": _case(
        (2, 1, 16, 18, 40), mode="nearest", elastic=(True, True), kernels=("shear",)
    ),
    "linear-bc-fill-out-shape": _case(
        (2, 2, 24, 24, 40), out=(18, 20, 30),
        fill=np.array([[0.5, -1.0], [2.0, 0.25]], np.float32), kernels=("shear",),
    ),
    "nearest-fill-out-shape": _case(
        (2, 1, 20, 18, 22), out=(23, 17, 25), mode="nearest", fill=0.75
    ),
    "linear-zero-fill-partial-sums": _case((2, 1, 17, 15, 19), fill=0.0),
    "size-1-axis": _case(
        (2, 1, 16, 20, 1), fill=0.5, angles=((0.0, 0.0, 0.2), (0.0, 0.0, -0.15))
    ),
    "two-chunk-k": _case(
        (1, 1, 16, 16, 200), fill=0.5, elastic=(True,), kernels=("shear",)
    ),
    "window-linear": _case(
        (2, 1, 16, 16, 40), fill=0.5, elastic=(True, True),
        angles=((0.01, 0.0, -0.01), (0.0, 0.012, 0.0)), kernels=("window",),
    ),
    "window-nearest": _case(
        (2, 1, 16, 16, 40), mode="nearest", elastic=(True, True),
        angles=((0.01, 0.0, -0.01), (0.0, 0.012, 0.0)), kernels=("window",),
    ),
}


def _port(case) -> np.ndarray:
    out = rs.resample_fused(
        torch.as_tensor(case["data"]), case["ms"], case["cps"],
        out_shape=case["out"], mode=case["mode"], fill=case["fill"],
    )
    assert out.dtype == torch.float32
    return out.numpy()


def _gather(case) -> np.ndarray:
    data, fill = case["data"], np.asarray(case["fill"], np.float32)
    apply_fill = not (fill.size == 1 and float(fill.reshape(-1)[0]) == 0.0)
    outs = []
    for b in range(data.shape[0]):
        row = fill[b] if fill.ndim == 2 else fill.reshape(-1)
        cp = case["cps"][b]
        outs.append(
            _resample_element_fused(
                jnp.asarray(data[b]),
                jnp.asarray(np.asarray(case["ms"][b], np.float64), jnp.float32),
                None if cp is None else jnp.asarray(cp, jnp.float32),
                jnp.asarray(row, jnp.float32),
                case["out"], case["mode"], apply_fill, False,
            )
        )
    return np.stack([np.asarray(o) for o in outs])


def _off_ties(case) -> np.ndarray:
    """True where no coordinate of the port lies near a .5 tie."""
    maps, fields = rs._marshal_maps(case["ms"], case["cps"], "cpu")
    masks = []
    for b in range(maps.shape[0]):
        coords = rs.coord_planes(maps[b], case["out"])
        if fields is not None:
            disp = rs.upsample_field(fields[b], case["out"])
            coords = [coords[a] + disp[..., a] for a in range(3)]
        ok = np.ones(case["out"], bool)
        for c in coords:
            ok &= np.abs((c - torch.floor(c)).numpy() - 0.5) > TIE_BAND
        masks.append(ok)
    return np.stack(masks)[:, None]


def _coordinate_ulp(case) -> float:
    """One float32 ulp at the largest coordinate magnitude of the case.

    XLA:CPU contracts the JAX coordinate math into fused multiply-adds
    (about a quarter of the coordinates differ from the uncontracted
    port by one ulp), while the port and its CUDA kernel round every
    product. On inputs in [0, 1) a one-ulp coordinate shift moves a
    trilinear value by at most that ulp: 1.5e-5 for coordinates past
    128, above the 1e-5 limit only in the two-chunk-K case.
    """
    io, jo, ko = case["out"]
    corners = np.array([[i, j, k, 1.0] for i in (0, io) for j in (0, jo) for k in (0, ko)])
    biggest = max(np.abs(corners @ np.asarray(m).T).max() for m in case["ms"]) + 2.0
    return float(np.spacing(np.float32(biggest)))


def _assert_match(case, got, want, atol):
    assert got.shape == want.shape
    if case["mode"] == "linear":
        atol = max(atol, _coordinate_ulp(case))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        ok = np.broadcast_to(_off_ties(case), got.shape)
        assert ok.mean() > 0.99
        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_gather(name):
    case = CASES[name]
    _assert_match(case, _port(case), _gather(case), GATHER_ATOL)


KERNEL_CASES = [(n, k) for n, c in CASES.items() for k in c["kernels"]]


@pytest.mark.parametrize("name,kernel", KERNEL_CASES)
def test_plain_matches_jax_pallas_interpret(name, kernel, monkeypatch):
    monkeypatch.setenv("TORCHIO_TPU_WINDOW_INTERPRET", "1")
    case = CASES[name]
    data, ms, cps, out, mode = (case[k] for k in ("data", "ms", "cps", "out", "mode"))
    fill = np.asarray(case["fill"], np.float32)
    apply_fill = not (fill.size == 1 and float(fill.reshape(-1)[0]) == 0.0)
    if kernel == "shear":
        plan = shear_eligible(data.shape, out, ms, cps, mode)
        assert plan is not None
        want = shear_resample_fused(data, ms, cps, fill, plan, mode=mode,
                                    apply_fill=apply_fill)
    else:
        pads = window_eligible(data.shape, out, ms, cps, mode)
        assert pads is not None
        want = window_resample_fused(data, ms, cps, fill, padi=pads[0],
                                     padj=pads[1], apply_fill=apply_fill, mode=mode)
    _assert_match(case, _port(case), np.asarray(want), KERNEL_ATOL)


def test_upsample_volume_matches_jax():
    from torchio_tpu.ops.resample import upsample_volume

    x = np.random.default_rng(3).normal(size=(2, 3, 5, 6, 4)).astype(np.float32)
    want = np.asarray(upsample_volume(jnp.asarray(x), (17, 1, 9)))
    got = rs.upsample_volume(torch.as_tensor(x), (17, 1, 9)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_other_devices_raise_instead_of_taking_the_plain_path(monkeypatch):
    monkeypatch.setattr(rs, "resample_plain", lambda *a: pytest.fail("plain path"))
    data = torch.zeros((1, 1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs.resample_fused(data, [np.eye(4)], [None])


def test_kernel_wrapper_rejects_cpu_tensors():
    from torchio_tpu_torch.ops.resample_kernel import resample_cuda

    vol = torch.zeros((1, 1, 4, 4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        resample_cuda(vol, torch.zeros((1, 3, 4)), None, torch.zeros((1, 1)),
                      (4, 4, 4), "linear", False)
