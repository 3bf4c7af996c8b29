"""Wrappers of the hand-written CUDA B-spline kernels (``csrc/bspline.cu``).

- :func:`prefilter_cuda`: the direct B-spline transform, one launch per
  axis (:func:`prefilter_pass`); its plain version is
  :func:`..bspline.prefilter_plain`. The JAX package computes it in XLA,
  so it has no Pallas counterpart. :func:`prefilter_steps` lays out the
  three passes (a multi-channel batch comes out channels-last) and
  :func:`prefilter_plan` picks each pass's path by shape: lines staged in
  shared memory (``LAUNCHES["bspline_prefilter"]``), or, for lines longer
  than shared memory holds, lines walked in device memory
  (``LAUNCHES["bspline_prefilter_global"]``).
- :func:`bspline_resample_cuda`: the (order+1)^3-tap evaluation at grid
  specs, in place of the spline modes of the JAX package's windowed
  Pallas kernel (``LAUNCHES["bspline_resample"]``), on channels-last
  coefficients; its plain version is
  :func:`..bspline.bspline_resample_plain`.
- :func:`bspline_coords_cuda`: the same evaluation at dense coordinates
  (``LAUNCHES["bspline_coords"]``), the JAX package's ``bspline_resample``,
  on the row tiles of the resample kernels (:func:`coords_launch_plan`);
  its plain version is :func:`..bspline.bspline_coords_plain`.

The source file's head says what each kernel computes and what bounds
it; :mod:`.kernel_lib` builds and loads the library.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .bspline import _check_order, pole_constants
from .kernel_lib import F32, I32, I64, P, KernelLibrary, check_tensor, stream
from .resample_kernel import (
    ResamplePlan, _check_grid, _ptr, check_dense, grid_args, resample_launch_plan,
)

_FLOATS, _INTS = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)

BSPLINE = KernelLibrary(
    "bspline.cu",
    {
        "tio_prefilter_axis": [P, P, I64, I32, I64] + [I32] * 6
        + [_FLOATS, _INTS, _FLOATS, _FLOATS, F32, P],
        "tio_bspline_resample": [P] * 5 + [I32] * 11 + [F32] * 3 + [I32, I32, P],
        "tio_bspline_coords": [P] * 4 + [I32] * 8 + [I64] + [I32] * 7 + [P],
    },
    kernels=(
        "bspline_prefilter", "bspline_prefilter_global", "bspline_resample",
        "bspline_coords",
    ),
)

#: Dynamic shared memory one block may take on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448
#: Lines per block of the line path, and threads per block of the column
#: path, largest first: the first whose lines fit is taken.
LINES_PER_BLOCK = (64, 32, 16, 8)
COLUMNS_PER_BLOCK = (32, 16, 8)
#: Strides below this take the line path (rows of interleaved lines).
LINE_STRIDE_LIMIT = 32
_PATHS = {"global": 0, "lines": 1, "columns": 2}


class PrefilterPlan(NamedTuple):
    """How one axis pass runs: ``path`` "lines" (stride below
    :data:`LINE_STRIDE_LIMIT`: rows of ``stride`` interleaved lines,
    ``per_block`` lines a block, at line pitch ``pitch`` floats), "columns"
    (an n x ``per_block`` slab a block, row pitch ``pitch``) or "global"
    (lines too long for shared memory), and the block's dynamic shared
    memory."""

    path: str
    per_block: int
    pitch: int
    shared_bytes: int


GLOBAL = PrefilterPlan("global", 0, 0, 0)


def prefilter_plan(n: int, stride: int, channels: int = 1) -> PrefilterPlan:
    """The path of a pass over lines of ``n`` samples ``stride`` floats
    apart. A line is stored at an odd pitch, so that the block's threads,
    one per line, hit different banks at the same index. ``channels`` > 1
    plans the pass that also moves the channels innermost: a column slab
    of whole channel runs (its block's size a multiple of ``channels``),
    or "global" when none fits, which that pass cannot run."""
    if channels > 1:
        for per_block in COLUMNS_PER_BLOCK:
            threads = max(per_block // channels, 1) * channels
            if threads <= 1024 and threads * n * 4 <= MAX_SHARED_BYTES:
                return PrefilterPlan("columns", threads, threads, threads * n * 4)
        return GLOBAL
    if stride < LINE_STRIDE_LIMIT:
        pitch = n | 1
        for lines in LINES_PER_BLOCK:
            per_block = max(lines // stride, 1) * stride
            if per_block * pitch * 4 <= MAX_SHARED_BYTES:
                return PrefilterPlan("lines", per_block, pitch, per_block * pitch * 4)
    else:
        for per_block in COLUMNS_PER_BLOCK:
            if per_block * n * 4 <= MAX_SHARED_BYTES:
                return PrefilterPlan("columns", per_block, per_block, per_block * n * 4)
    return GLOBAL


class PrefilterStep(NamedTuple):
    """One axis pass: the volume viewed as (outer, n, stride), read as
    (outer, channels, n, stride) and written as (outer, n, stride,
    channels) when ``channels`` > 1, and the pass's plan."""

    outer: int
    n: int
    stride: int
    channels: int
    plan: PrefilterPlan


def prefilter_steps(shape: tuple[int, ...]) -> tuple[bool, list[PrefilterStep]]:
    """(channels_last, the three axis passes) of the prefilter of a
    volume of ``shape``. A (B, C, I, J, K) batch of C > 1 channels comes
    out channels-last, (B, I, J, K, C) in memory, for the spline kernels'
    vector loads: the i pass moves the channels innermost, the j and k
    passes filter in place. Any other shape, or a batch whose i pass has
    no plan, keeps its layout."""
    *lead, si, sj, sk = (int(d) for d in shape)
    if len(lead) == 2 and lead[1] > 1:
        b, c = lead
        first = prefilter_plan(si, sj * sk, c)
        if first.path != "global":
            return True, [
                PrefilterStep(b, si, sj * sk, c, first),
                PrefilterStep(b * si, sj, sk * c, 1, prefilter_plan(sj, sk * c)),
                PrefilterStep(b * si * sj, sk, c, 1, prefilter_plan(sk, c)),
            ]
    outer = math.prod(lead)
    return False, [
        PrefilterStep(outer, si, sj * sk, 1, prefilter_plan(si, sj * sk)),
        PrefilterStep(outer * si, sj, sk, 1, prefilter_plan(sj, sk)),
        PrefilterStep(outer * si * sj, sk, 1, 1, prefilter_plan(sk, 1)),
    ]


def prefilter_pass(src: torch.Tensor, dst: torch.Tensor, step: PrefilterStep, order: int) -> None:
    """One axis pass of the prefilter (:func:`prefilter_steps`) from the
    storage of ``src`` into that of ``dst`` (which may be ``src``, unless
    the pass moves channels): float32 CUDA tensors of one size, each
    dense in memory."""
    lam, constants = pole_constants(order, step.n)
    zs, horizons, inv_denoms, antis = zip(*constants)
    plan = step.plan
    kernel = "bspline_prefilter_global" if plan.path == "global" else "bspline_prefilter"
    with torch.cuda.device(src.device):
        BSPLINE.launch(
            kernel, "tio_prefilter_axis",
            src.data_ptr(), dst.data_ptr(), step.outer, step.n, step.stride, step.channels,
            _PATHS[plan.path], plan.per_block, plan.pitch, plan.shared_bytes,
            len(constants),
            (ctypes.c_float * 3)(*zs), (ctypes.c_int * 3)(*horizons),
            (ctypes.c_float * 3)(*inv_denoms), (ctypes.c_float * 3)(*antis),
            lam, stream(src.device),
        )


def prefilter_cuda(vol: torch.Tensor, order: int) -> torch.Tensor:
    """Prefilter a (..., I, J, K) float32 CUDA volume over its last three
    axes; returns a new tensor of coefficients, channels-last in memory
    (``torch.channels_last_3d``) for a (B, C, I, J, K) batch of C > 1."""
    _check_order(order)
    if vol.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {vol.device}")
    if vol.ndim < 3:
        raise ValueError(f"vol must be (..., I, J, K), got {tuple(vol.shape)}")
    check_tensor("vol", vol, tuple(vol.shape), vol.device)
    channels_last, steps = prefilter_steps(tuple(vol.shape))
    out = torch.empty_like(
        vol, memory_format=torch.channels_last_3d if channels_last else torch.contiguous_format
    )
    if out.numel() == 0:
        return out
    src = vol
    for step in steps:
        prefilter_pass(src, out, step, order)
        src = out
    return out


def _channels_last(coeffs: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The (B, C, I, J, K) coefficients channels-last in memory (copied
    only if they are not), and the channels the kernel reads a load: 4
    when C is a multiple of 4 and the data 16-byte aligned, else 1."""
    if coeffs.ndim != 5:
        raise ValueError(f"coeffs must be (B, C, I, J, K), got {tuple(coeffs.shape)}")
    if coeffs.dtype != torch.float32:
        raise TypeError(f"coeffs must be torch.float32, got {coeffs.dtype}")
    if math.prod(coeffs.shape[1:2] + coeffs.shape[3:]) >= 2**31:
        raise ValueError("J * K * C must be below 2**31")
    coeffs = coeffs.contiguous(memory_format=torch.channels_last_3d)
    vec = 4 if coeffs.shape[1] % 4 == 0 and coeffs.data_ptr() % 16 == 0 else 1
    return coeffs, vec


def bspline_resample_cuda(
    coeffs: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    order: int,
) -> torch.Tensor:
    """Spline evaluation on the card; see
    :func:`..bspline.bspline_resample_plain` for the arguments (the
    coefficients in either memory layout; :func:`prefilter_cuda` gives the
    one the kernel reads). Returns a new (B, C, Io, Jo, Ko) float32
    tensor."""
    _check_order(order)
    out_shape, coarse = _check_grid(coeffs, maps, fields, out_shape)
    coeffs, vec = _channels_last(coeffs)
    b, c = coeffs.shape[:2]
    check_tensor("fill", fill, (b, c), coeffs.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    if out.numel() == 0:
        return out
    g = grid_args(coeffs, out_shape, coarse)
    with torch.cuda.device(coeffs.device):
        BSPLINE.launch(
            "bspline_resample", "tio_bspline_resample",
            coeffs.data_ptr(), maps.data_ptr(), _ptr(fields), fill.data_ptr(),
            out.data_ptr(), g[0], c, *g[1:], order, vec, stream(coeffs.device),
        )
    return out


def coords_launch_plan(coeffs_shape, out_shape) -> ResamplePlan:
    """The row-tiled launch of the dense spline (``csrc/row_tiles.cuh``,
    as :func:`.resample_launch_plan` lays it out) for (B, C, I, J, K)
    coefficients and a (Io, Jo, Ko) output: its offsets run over one
    element's I J K C channels-last floats, so it asks for 64-bit offsets
    when those reach 2^31."""
    b, c, si, sj, sk = (int(n) for n in coeffs_shape)
    return resample_launch_plan(b, *out_shape, (si, sj, sk * c))


def bspline_coords_cuda(
    coeffs: torch.Tensor, coords: torch.Tensor, fill: torch.Tensor, order: int
) -> torch.Tensor:
    """Spline evaluation at dense coordinates on the card; see
    :func:`..bspline.bspline_coords_plain` for the arguments (the
    coefficients in either memory layout). Returns a new (B, C, Io, Jo,
    Ko) float32 tensor."""
    _check_order(order)
    out_shape, stride = check_dense(coeffs, coords)
    coeffs, vec = _channels_last(coeffs)
    b, c, si, sj, sk = coeffs.shape
    check_tensor("fill", fill, (b, c), coeffs.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    if out.numel() == 0:
        return out
    plan = coords_launch_plan(coeffs.shape, out_shape)
    with torch.cuda.device(coeffs.device):
        BSPLINE.launch(
            "bspline_coords", "tio_bspline_coords",
            coeffs.data_ptr(), coords.data_ptr(), fill.data_ptr(), out.data_ptr(),
            b, c, si, sj, sk, *out_shape, stride, order, vec, *plan.grid, plan.z_rows,
            int(plan.wide), stream(coeffs.device),
        )
    return out
