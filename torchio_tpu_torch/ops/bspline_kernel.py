"""Wrappers of the hand-written CUDA B-spline kernels (``csrc/bspline.cu``).

- :func:`prefilter_cuda`: the direct B-spline transform, one launch per
  axis (``LAUNCHES["bspline_prefilter"]``); its plain version is
  :func:`..bspline.prefilter_plain`. The JAX package computes it in XLA,
  so it has no Pallas counterpart.
- :func:`bspline_resample_cuda`: the (order+1)^3-tap evaluation at grid
  specs, in place of the spline modes of the JAX package's windowed
  Pallas kernel (``LAUNCHES["bspline_resample"]``); its plain version is
  :func:`..bspline.bspline_resample_plain`.
- :func:`bspline_coords_cuda`: the same evaluation at dense coordinates
  (``LAUNCHES["bspline_coords"]``), the JAX package's ``bspline_resample``;
  its plain version is :func:`..bspline.bspline_coords_plain`.

The source file's head says what each kernel computes and what bounds
it; :mod:`.kernel_lib` builds and loads the library.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .bspline import _check_order, pole_constants
from .kernel_lib import F32, I32, I64, P, KernelLibrary, check_tensor, stream
from .resample_kernel import _check_grid, _ptr, check_dense, grid_args

_FLOATS, _INTS = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)

BSPLINE = KernelLibrary(
    "bspline.cu",
    {
        "tio_prefilter_axis": [P, P, I64, I32, I64, I32, _FLOATS, _INTS, _FLOATS,
                               _FLOATS, F32, P],
        "tio_bspline_resample": [P] * 5 + [I32] * 11 + [F32] * 3 + [I32, P],
        "tio_bspline_coords": [P] * 4 + [I32] * 8 + [I64, I32, P],
    },
    kernels=("bspline_prefilter", "bspline_resample", "bspline_coords"),
)


def prefilter_cuda(vol: torch.Tensor, order: int) -> torch.Tensor:
    """Prefilter a (..., I, J, K) float32 CUDA volume over its last three
    axes; returns a new tensor of coefficients."""
    _check_order(order)
    if vol.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {vol.device}")
    if vol.ndim < 3:
        raise ValueError(f"vol must be (..., I, J, K), got {tuple(vol.shape)}")
    check_tensor("vol", vol, tuple(vol.shape), vol.device)
    out = torch.empty_like(vol)
    if out.numel() == 0:
        return out
    spatial = tuple(int(s) for s in vol.shape[-3:])
    src = vol
    with torch.cuda.device(vol.device):
        for rel, n in enumerate(spatial):
            stride = math.prod(spatial[rel + 1:])
            lam, constants = pole_constants(order, n)
            zs, horizons, inv_denoms, antis = zip(*constants)
            BSPLINE.launch(
                "bspline_prefilter", "tio_prefilter_axis",
                src.data_ptr(), out.data_ptr(), vol.numel() // n, n, stride,
                len(constants),
                (ctypes.c_float * 3)(*zs), (ctypes.c_int * 3)(*horizons),
                (ctypes.c_float * 3)(*inv_denoms), (ctypes.c_float * 3)(*antis),
                lam, stream(vol.device),
            )
            src = out
    return out


def bspline_resample_cuda(
    coeffs: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    order: int,
) -> torch.Tensor:
    """Spline evaluation on the card; see
    :func:`..bspline.bspline_resample_plain` for the arguments. Returns a
    new (B, C, Io, Jo, Ko) float32 tensor."""
    _check_order(order)
    out_shape, coarse = _check_grid(coeffs, maps, fields, out_shape)
    b, c = coeffs.shape[:2]
    check_tensor("coeffs", coeffs, tuple(coeffs.shape), coeffs.device)
    check_tensor("fill", fill, (b, c), coeffs.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    if out.numel() == 0:
        return out
    g = grid_args(coeffs, out_shape, coarse)
    with torch.cuda.device(coeffs.device):
        BSPLINE.launch(
            "bspline_resample", "tio_bspline_resample",
            coeffs.data_ptr(), maps.data_ptr(), _ptr(fields), fill.data_ptr(),
            out.data_ptr(), g[0], c, *g[1:], order, stream(coeffs.device),
        )
    return out


def bspline_coords_cuda(
    coeffs: torch.Tensor, coords: torch.Tensor, fill: torch.Tensor, order: int
) -> torch.Tensor:
    """Spline evaluation at dense coordinates on the card; see
    :func:`..bspline.bspline_coords_plain` for the arguments. Returns a
    new (B, C, Io, Jo, Ko) float32 tensor."""
    _check_order(order)
    out_shape, stride = check_dense(coeffs, coords)
    b, c, si, sj, sk = coeffs.shape
    check_tensor("coeffs", coeffs, tuple(coeffs.shape), coeffs.device)
    check_tensor("fill", fill, (b, c), coeffs.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(coeffs.device):
        BSPLINE.launch(
            "bspline_coords", "tio_bspline_coords",
            coeffs.data_ptr(), coords.data_ptr(), fill.data_ptr(), out.data_ptr(),
            b, c, si, sj, sk, *out_shape, stride, order, stream(coeffs.device),
        )
    return out
