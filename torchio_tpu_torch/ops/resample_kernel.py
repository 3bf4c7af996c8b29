"""Wrappers of the hand-written CUDA resample kernels.

- :func:`resample_cuda` (``csrc/resample.cu``): trilinear / nearest, in
  place of the JAX package's Pallas shear and window resample kernels;
  its plain version is :func:`..resample.resample_plain`.
- :func:`resample_coords_cuda` (``csrc/resample.cu``, dense mode): the
  same resample at the points of a dense coordinate tensor, in place of
  the JAX package's tiled Pallas kernel (``pallas_resample.py``); its
  plain version is :func:`..resample.resample_coords_plain`.
- :func:`resample_label_cuda` (``csrc/label_resample.cu``): the
  partial-volume label vote, in place of their "corners" mode; its plain
  version is :func:`..resample.resample_label_plain`.

The source files' heads say what each kernel computes and what bounds
it. :func:`resample_launch_plan` lays out the launch of all three: they
share ``csrc/row_tiles.cuh``'s row tiles. :mod:`.kernel_lib` builds and
loads the libraries and counts the launches (``LAUNCHES["resample"]``,
``LAUNCHES["resample_coords"]``, ``LAUNCHES["label_vote"]``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .kernel_lib import (
    F32, I32, I64, P, KernelLibrary, check_tensor, field_ratio, stream,
)
from .resample import _pad_value

RESAMPLE = KernelLibrary(
    "resample.cu",
    {
        "tio_resample": [P] * 5 + [I32] * 11 + [F32] * 3 + [I32] * 8 + [P],
        "tio_resample_coords": [P] * 4 + [I32] * 8 + [I64] + [I32] * 7 + [P],
    },
    kernels=("resample", "resample_coords"),
)
LABEL = KernelLibrary(
    "label_resample.cu",
    {"tio_resample_label": [P] * 4 + [I32] * 10 + [F32] * 4 + [I32] * 8 + [P]},
    kernels=("label_vote",),
)


#: ``csrc/row_tiles.cuh``'s block: ROWS warps, each on one output row
#: (b, io, jo), walking the row's k tiles of TILE_K = LANES * VEC voxels
#: that its block serves
LANES, ROWS, VEC = 32, 8, 4
TILE_K = LANES * VEC
#: k tiles of a row a block serves: the row's map and field lerps are set
#: up once for them
ROW_TILES = 2
#: CUDA's cap on gridDim.y and gridDim.z (gridDim.x's, 2^31 - 1, is never
#: reached: Ko < 2^31 gives at most 2^23 blocks of ROW_TILES k tiles)
GRID_YZ_MAX = 65535
#: the most shared memory a block stages row fields in without opting in
FIELD_SMEM_MAX = 48 * 1024


class ResamplePlan(NamedTuple):
    """The launch of a row-tiled kernel (``csrc/row_tiles.cuh``: the
    resample, dense and label kernels): ``grid`` is (k tiles, j
    tiles, io x b), each folded into a loop in the block: block z serves
    io = z % z_rows (stepping by z_rows) of b = z // z_rows (stepping by
    grid z // z_rows), block y the j tiles y, y + grid y, ..., block x the
    k tiles x, x + grid x, ...; ``wide`` asks for 64-bit offsets inside
    one (b, c) volume; ``field_smem`` is the shared memory, in bytes, of
    the field's row lerps (0: no field, or one too fine to stage,
    upsampled a voxel)."""

    grid: tuple[int, int, int]
    z_rows: int
    wide: bool
    field_smem: int


def resample_launch_plan(
    b: int, io: int, jo: int, ko: int, in_shape=(1, 1, 1), coarse_k: int = 0
) -> ResamplePlan:
    """The launch plan of a (b, Io, Jo, Ko) output (every extent positive)
    from an input of spatial ``in_shape``, with a coarse field of
    ``coarse_k`` points along k (0 for none)."""
    z_rows = min(io, GRID_YZ_MAX)
    grid = (
        -(-ko // (TILE_K * ROW_TILES)),
        min(-(-jo // ROWS), GRID_YZ_MAX),
        z_rows * min(b, GRID_YZ_MAX // z_rows),
    )
    field_smem = ROWS * coarse_k * 3 * 4
    return ResamplePlan(
        grid, z_rows, math.prod(in_shape) >= 2**31,
        field_smem if field_smem <= FIELD_SMEM_MAX else 0,
    )


def _check_grid(vol, maps, fields, out_shape) -> tuple:
    """Validate a resample's common arguments; returns (out_shape, the
    field's (ni, nj, nk) or zeros)."""
    if vol.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {vol.device}")
    if vol.ndim != 5:
        raise ValueError(f"vol must be (B, C, I, J, K), got {tuple(vol.shape)}")
    b = vol.shape[0]
    io, jo, ko = (int(s) for s in out_shape)
    if min(io, jo, ko) < 1:
        raise ValueError(f"out_shape must be positive, got {out_shape}")
    if max(*vol.shape, io, jo, ko) >= 2**31:
        raise ValueError("every dimension must be below 2**31")
    check_tensor("maps", maps, (b, 3, 4), vol.device)
    ni = nj = nk = 0
    if fields is not None:
        if fields.ndim != 5 or fields.shape[0] != b or fields.shape[-1] != 3:
            raise ValueError(f"fields must be (B, ni, nj, nk, 3), got {tuple(fields.shape)}")
        ni, nj, nk = (int(n) for n in fields.shape[1:4])
        check_tensor("fields", fields, (b, ni, nj, nk, 3), vol.device)
    return (io, jo, ko), (ni, nj, nk)


def grid_args(vol, out_shape, coarse) -> tuple:
    """The (B, [C,] I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk) launch
    arguments shared by every resample kernel, C omitted."""
    b, _, si, sj, sk = vol.shape
    io, jo, ko = out_shape
    ni, nj, nk = coarse
    return (
        b, si, sj, sk, io, jo, ko, ni, nj, nk,
        field_ratio(ni, io), field_ratio(nj, jo), field_ratio(nk, ko),
    )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def resample_cuda(
    vol: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """Resample on the card; see :func:`..resample.resample_plain` for
    the arguments. Returns a new (B, C, Io, Jo, Ko) float32 tensor."""
    out_shape, coarse = _check_grid(vol, maps, fields, out_shape)
    if mode not in ("linear", "nearest"):
        raise ValueError(f"Unsupported resampling mode: {mode!r}")
    b, c = vol.shape[:2]
    check_tensor("vol", vol, tuple(vol.shape), vol.device)
    check_tensor("fill", fill, (b, c), vol.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=vol.device)
    if out.numel() == 0:
        return out
    g = grid_args(vol, out_shape, coarse)
    plan = resample_launch_plan(b, *out_shape, vol.shape[2:], coarse[2])
    with torch.cuda.device(vol.device):
        RESAMPLE.launch(
            "resample", "tio_resample",
            vol.data_ptr(), maps.data_ptr(), _ptr(fields), fill.data_ptr(), out.data_ptr(),
            g[0], c, *g[1:], int(mode == "nearest"), int(apply_fill),
            *plan.grid, plan.z_rows, int(plan.wide), plan.field_smem, stream(vol.device),
        )
    return out


def check_dense(vol, coords) -> tuple:
    """Validate a dense-coordinate launch's volume and coordinates;
    returns ((Io, Jo, Ko), the coordinates' batch stride: 0 for one grid
    shared by the batch)."""
    if vol.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need a CUDA tensor, got {vol.device}")
    if vol.ndim != 5:
        raise ValueError(f"vol must be (B, C, I, J, K), got {tuple(vol.shape)}")
    b = vol.shape[0]
    if coords.ndim != 5 or coords.shape[0] not in (1, b) or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (1 or {b}, Io, Jo, Ko, 3), got {tuple(coords.shape)}")
    check_tensor("coords", coords, tuple(coords.shape), vol.device)
    out_shape = tuple(int(s) for s in coords.shape[1:4])
    if max(*vol.shape, *out_shape) >= 2**31:
        raise ValueError("every dimension must be below 2**31")
    stride = 0 if coords.shape[0] == 1 else 3 * out_shape[0] * out_shape[1] * out_shape[2]
    return out_shape, stride


def resample_coords_cuda(
    vol: torch.Tensor,
    coords: torch.Tensor,
    fill: torch.Tensor,
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """Resample at dense coordinates on the card; see
    :func:`..resample.resample_coords_plain` for the arguments. Returns a
    new (B, C, Io, Jo, Ko) float32 tensor."""
    out_shape, stride = check_dense(vol, coords)
    if mode not in ("linear", "nearest"):
        raise ValueError(f"Unsupported resampling mode: {mode!r}")
    b, c, si, sj, sk = vol.shape
    check_tensor("vol", vol, tuple(vol.shape), vol.device)
    check_tensor("fill", fill, (b, c), vol.device)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=vol.device)
    if out.numel() == 0:
        return out
    plan = resample_launch_plan(b, *out_shape, (si, sj, sk))
    with torch.cuda.device(vol.device):
        RESAMPLE.launch(
            "resample_coords", "tio_resample_coords",
            vol.data_ptr(), coords.data_ptr(), fill.data_ptr(), out.data_ptr(),
            b, c, si, sj, sk, *out_shape, stride,
            int(mode == "nearest"), int(apply_fill), *plan.grid, plan.z_rows,
            int(plan.wide), stream(vol.device),
        )
    return out


def resample_label_cuda(
    vol: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    out_shape: tuple[int, int, int],
    pad_label: float,
) -> torch.Tensor:
    """Partial-volume label vote on the card; see
    :func:`..resample.resample_label_plain` for the arguments. Returns a
    new (B, 1, Io, Jo, Ko) tensor of ``vol``'s type (int32 or float32)."""
    out_shape, coarse = _check_grid(vol, maps, fields, out_shape)
    if vol.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"labels must be int32 or float32, got {vol.dtype}")
    if vol.shape[1] != 1:
        raise ValueError(f"the label vote takes one channel, got {vol.shape[1]}")
    check_tensor("vol", vol, tuple(vol.shape), vol.device, vol.dtype)
    out = torch.empty((vol.shape[0], 1, *out_shape), dtype=vol.dtype, device=vol.device)
    if out.numel() == 0:
        return out
    pad_int = _pad_value(pad_label, torch.int32)
    plan = resample_launch_plan(vol.shape[0], *out_shape, vol.shape[2:], coarse[2])
    with torch.cuda.device(vol.device):
        LABEL.launch(
            "label_vote", "tio_resample_label",
            vol.data_ptr(), maps.data_ptr(), _ptr(fields), out.data_ptr(),
            *grid_args(vol, out_shape, coarse), float(pad_label),
            int(vol.dtype == torch.float32), pad_int,
            *plan.grid, plan.z_rows, int(plan.wide), plan.field_smem, stream(vol.device),
        )
    return out
