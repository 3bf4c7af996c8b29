"""Resampling: trilinear/nearest and label-vote resample from grid specs,
and trilinear/nearest resample at dense coordinates.

Counterpart of ``torchio_tpu/ops/resample.py``. Semantics match
``torch.nn.functional.grid_sample(align_corners=True,
padding_mode="zeros")`` in input voxel coordinates:

- trilinear: the 8 corners of each sample point; corners outside the
  volume contribute 0;
- nearest: round half to even, then a single read;
- size-1 axes: every coordinate maps to index 0 with full weight and is
  never out of bounds;
- out-of-bounds fill: where the trilinear in-bounds weight (the
  bilinear grid-sample of a ones-volume, also in nearest mode) is
  <= 0.5, the voxel takes the per-(B, C) fill value. A scalar fill of 0
  applies no fill at all, so the boundary keeps its partial sums.

The sample point of output voxel ``(i, j, k)`` of element ``b`` is
``M_b [i, j, k, 1]`` plus, for elastic maps, the trilinearly upsampled
coarse displacement field (:func:`upsample_field`), both in float32 in
the operation order of the JAX package.

The partial-volume label vote (:func:`resample_label_fused`) takes the 8
corner labels with the same weights: each corner's label scores the
summed weight of the corners carrying it, the top score wins (ties to the
smallest label), and ``pad_label`` applies where the in-bounds weight is
<= 0.5. It equals one-hot -> trilinear -> argmax without the label set.

:func:`resample` takes the sample points from a dense (Io, Jo, Ko, 3)
or (B, Io, Jo, Ko, 3) coordinate tensor (:func:`build_coords` builds one
from a 4x4 map) instead of building them, with the same sampling rules.

:func:`resample_fused`, :func:`resample_label_fused` and :func:`resample`
send a CUDA batch to the hand-written kernels (:mod:`.resample_kernel`,
``csrc/resample.cu`` and ``csrc/label_resample.cu``) and a CPU batch to
:func:`resample_plain`, :func:`resample_label_plain` and
:func:`resample_coords_plain`, the plain PyTorch versions of the same
functions.
The JAX package's TPU machinery (pre-shear pass, windowed and tiled
Pallas kernels, host tile plans, eligibility guards and their gather
fallback) has no counterpart here: it exists because the TPU has no fast
gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..core.dtypes import cast_like_jax

MODES = ("linear", "nearest")


# --------------------------------------------------------------------
# separable trilinear upsampling (align_corners=True)
# --------------------------------------------------------------------


def _axis_coords(n_in: int, n_out: int, device) -> torch.Tensor:
    if n_out == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    ratio = torch.tensor((n_in - 1) / (n_out - 1), dtype=torch.float32, device=device)
    return torch.arange(n_out, dtype=torch.float32, device=device) * ratio


def _lerp_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """Linear interpolation of ``x`` along ``dim`` to ``n_out`` samples."""
    n_in = x.shape[dim]
    g = _axis_coords(n_in, n_out, x.device)
    i0 = torch.floor(g).long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(0, n_in - 1)
    shape = [1] * x.ndim
    shape[dim] = -1
    f = (g - i0.to(torch.float32)).reshape(shape)
    return x.index_select(dim, i0) * (1.0 - f) + x.index_select(dim, i1) * f


def upsample_field(control_points, out_shape: tuple[int, int, int]) -> torch.Tensor:
    """Trilinearly upsample a coarse (n_i, n_j, n_k, 3) field to
    ``(*out_shape, 3)``: lerp over i, then j, then k (align_corners). A
    tensor stays on its device; host data goes to the default device."""
    out = config.as_tensor(control_points).to(torch.float32)
    for dim, n_out in enumerate(out_shape):
        out = _lerp_axis(out, int(n_out), dim)
    return out


def upsample_volume(x, out_shape: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear align_corners=True upsampling over the LAST 3 axes
    (``F.interpolate(mode="trilinear", align_corners=True)`` for
    (B, C, I, J, K) inputs, computed as three per-axis lerps). A tensor
    stays on its device; host data goes to the default device."""
    out = config.as_tensor(x).to(torch.float32)
    for rel, n_out in enumerate(out_shape):
        out = _lerp_axis(out, int(n_out), out.ndim - 3 + rel)
    return out


# --------------------------------------------------------------------
# the plain version of the resample kernel
# --------------------------------------------------------------------


def coord_planes(map34: torch.Tensor, out_shape) -> tuple[torch.Tensor, ...]:
    """Three (Io, Jo, Ko) float32 coordinate arrays of ``map34 @ [i,j,k,1]``,
    summed as ``((i*m0 + j*m1) + k*m2) + m3`` like the JAX package."""
    io, jo, ko = out_shape
    dev = map34.device
    ri = torch.arange(io, dtype=torch.float32, device=dev)[:, None, None]
    rj = torch.arange(jo, dtype=torch.float32, device=dev)[None, :, None]
    rk = torch.arange(ko, dtype=torch.float32, device=dev)[None, None, :]
    return tuple(
        ri * map34[a, 0] + rj * map34[a, 1] + rk * map34[a, 2] + map34[a, 3]
        for a in range(3)
    )


def build_coords(out_shape, matrix, device=None) -> torch.Tensor:
    """(Io, Jo, Ko, 3) float32 input-voxel coordinates of each output voxel.

    ``matrix`` is the 4x4 output-voxel -> input-voxel map (float64 host
    math, rounded to float32); the grid is built on ``device`` (by default
    the package's default device, :func:`..config.default_device`) from three
    broadcast ramps, summed as ``((i*m0 + j*m1) + k*m2) + m3``, every
    product rounded (XLA:CPU contracts the JAX package's sums into fused
    multiply-adds, so about a fifth of its coordinates differ by one ulp).
    """
    if device is None:
        device = config.default_device()
    m = torch.as_tensor(np.asarray(matrix, np.float64)[:3].astype(np.float32), device=device)
    return torch.stack(coord_planes(m, tuple(int(s) for s in out_shape)), dim=-1)


def _inb(index: torch.Tensor, size: int) -> torch.Tensor:
    return (index >= 0) & (index < size)


def _axis_weights(c: torch.Tensor, size: int):
    """Floor index and the two in-bounds linear weights along one axis."""
    i0 = torch.floor(c).long()
    f = c - i0.to(torch.float32)
    return i0, ((1.0 - f) * _inb(i0, size), f * _inb(i0 + 1, size))


def _sample(vol, ci, cj, ck, fill, mode: str, apply_fill: bool):
    """One element: vol (C, I, J, K) float32, coords (Io, Jo, Ko) each,
    fill (C,). Returns (C, Io, Jo, Ko)."""
    c, si, sj, sk = vol.shape
    flat = vol.reshape(c, -1)
    if si == 1:
        ci = torch.zeros_like(ci)
    if sj == 1:
        cj = torch.zeros_like(cj)
    if sk == 1:
        ck = torch.zeros_like(ck)
    i0, wi = _axis_weights(ci, si)
    j0, wj = _axis_weights(cj, sj)
    k0, wk = _axis_weights(ck, sk)
    mask = torch.zeros_like(ci)
    acc = None if mode == "nearest" else torch.zeros((c, *ci.shape), device=vol.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = wi[di] * wj[dj] * wk[dk]
                mask = mask + w
                if acc is None:
                    continue
                idx = (
                    (i0 + di).clamp(0, si - 1) * (sj * sk)
                    + (j0 + dj).clamp(0, sj - 1) * sk
                    + (k0 + dk).clamp(0, sk - 1)
                )
                acc = acc + flat[:, idx] * w
    if acc is None:  # nearest: one rounded corner, gated by validity
        ri, rj, rk = torch.round(ci).long(), torch.round(cj).long(), torch.round(ck).long()
        valid = _inb(ri, si) & _inb(rj, sj) & _inb(rk, sk)
        idx = (
            ri.clamp(0, si - 1) * (sj * sk)
            + rj.clamp(0, sj - 1) * sk
            + rk.clamp(0, sk - 1)
        )
        acc = flat[:, idx] * valid
    if not apply_fill:
        return acc
    return torch.where(mask > 0.5, acc, fill.reshape(-1, 1, 1, 1))


def _element_coords(maps, fields, b: int, out_shape):
    """Element ``b``'s three (Io, Jo, Ko) sample-coordinate arrays."""
    ci, cj, ck = coord_planes(maps[b], out_shape)
    if fields is not None:
        disp = upsample_field(fields[b], out_shape)
        ci, cj, ck = ci + disp[..., 0], cj + disp[..., 1], ck + disp[..., 2]
    return ci, cj, ck


def resample_plain(
    vol: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """Plain PyTorch version of the resample kernel, same arguments as
    :func:`.resample_kernel.resample_cuda`: vol (B, C, I, J, K) float32,
    maps (B, 3, 4) float32, fields (B, ni, nj, nk, 3) float32 or None,
    fill (B, C) float32. Runs one element at a time."""
    outs = []
    for b in range(vol.shape[0]):
        ci, cj, ck = _element_coords(maps, fields, b, out_shape)
        outs.append(_sample(vol[b], ci, cj, ck, fill[b], mode, apply_fill))
    return torch.stack(outs)


def resample_coords_plain(
    vol: torch.Tensor,
    coords: torch.Tensor,
    fill: torch.Tensor,
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """Plain PyTorch version of the dense-coordinate resample kernel, same
    arguments as :func:`.resample_kernel.resample_coords_cuda`: vol (B, C,
    I, J, K) float32, coords (1 or B, Io, Jo, Ko, 3) float32 (one grid
    shared by the batch, or one per element), fill (B, C) float32."""
    outs = []
    for b in range(vol.shape[0]):
        grid = coords[b if coords.shape[0] > 1 else 0]
        ci, cj, ck = grid[..., 0], grid[..., 1], grid[..., 2]
        outs.append(_sample(vol[b], ci, cj, ck, fill[b], mode, apply_fill))
    return torch.stack(outs)


def _vote(labels: torch.Tensor, ci, cj, ck, pad) -> torch.Tensor:
    """One element: labels (I, J, K) int32 or float32, coords (Io, Jo,
    Ko) each. Returns the (Io, Jo, Ko) winners."""
    si, sj, sk = labels.shape
    flat = labels.reshape(-1)
    if si == 1:
        ci = torch.zeros_like(ci)
    if sj == 1:
        cj = torch.zeros_like(cj)
    if sk == 1:
        ck = torch.zeros_like(ck)
    i0, wi = _axis_weights(ci, si)
    j0, wj = _axis_weights(cj, sj)
    k0, wk = _axis_weights(ck, sk)
    weights, labs = [], []
    wsum = torch.zeros_like(ci)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = wi[di] * wj[dj] * wk[dk]
                weights.append(w)
                wsum = wsum + w
                idx = (
                    (i0 + di).clamp(0, si - 1) * (sj * sk)
                    + (j0 + dj).clamp(0, sj - 1) * sk
                    + (k0 + dk).clamp(0, sk - 1)
                )
                labs.append(flat[idx])
    # each corner's score: the weight of the corners carrying its label,
    # summed in corner order
    scores = []
    for lab in labs:
        score = torch.zeros_like(ci)
        for other, w in zip(labs, weights):
            score = score + torch.where(other == lab, w, 0.0)
        scores.append(score)
    top = scores[0]
    for score in scores[1:]:
        top = torch.maximum(top, score)
    big = float("inf") if labels.dtype.is_floating_point else torch.iinfo(labels.dtype).max
    winner = torch.full_like(labs[0], big)
    for score, lab in zip(scores, labs):
        winner = torch.minimum(winner, torch.where(score == top, lab, big))
    return torch.where(wsum > 0.5, winner, pad)


def resample_label_plain(
    vol: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    out_shape: tuple[int, int, int],
    pad_label: float,
) -> torch.Tensor:
    """Plain PyTorch version of the label-vote kernel, same arguments as
    :func:`.resample_kernel.resample_label_cuda`: vol (B, 1, I, J, K)
    int32 or float32 labels, maps (B, 3, 4), fields (B, ni, nj, nk, 3) or
    None. Returns (B, 1, Io, Jo, Ko) labels of ``vol``'s type."""
    if vol.shape[1] != 1:
        raise ValueError(f"the label vote takes one channel, got {vol.shape[1]}")
    pad = _pad_value(pad_label, vol.dtype)
    outs = []
    for b in range(vol.shape[0]):
        ci, cj, ck = _element_coords(maps, fields, b, out_shape)
        outs.append(_vote(vol[b, 0], ci, cj, ck, pad))
    return torch.stack(outs)[:, None]


def _pad_value(pad_label: float, dtype: torch.dtype):
    """``pad_label`` cast to the label type (float -> int truncates)."""
    if dtype.is_floating_point:
        return float(np.float32(pad_label))
    return int(np.asarray(pad_label).astype(np.int32))


# --------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------


def _marshal_maps(matrices, control_points, device):
    """(B, 3, 4) float32 maps (rounded from float64) and the stacked
    (B, ni, nj, nk, 3) float32 fields, zero for elements without one,
    or None when no element has a field."""
    maps = np.stack([np.asarray(m, np.float64)[:3] for m in matrices])
    maps_t = torch.as_tensor(maps.astype(np.float32), device=device)
    present = [np.asarray(cp, np.float64) for cp in control_points if cp is not None]
    if not present:
        return maps_t, None
    shape = present[0].shape
    stacked = np.stack(
        [
            np.zeros(shape) if cp is None else np.asarray(cp, np.float64)
            for cp in control_points
        ]
    )
    return maps_t, torch.as_tensor(stacked.astype(np.float32), device=device)


def _fill_bc(fill, b: int, c: int, device) -> tuple[torch.Tensor, bool]:
    """Scalar / (C,) / (B, C) fill -> ((B, C) float32 tensor, apply_fill).

    A tensor fill (computed on the device, e.g. the per-element minimum)
    always applies; a host scalar of 0 applies none."""
    if isinstance(fill, torch.Tensor):
        f = fill.to(device=device, dtype=torch.float32)
        apply_fill = True
    else:
        arr = np.asarray(fill, np.float32)
        apply_fill = not (arr.size == 1 and float(arr.reshape(-1)[0]) == 0.0)
        f = torch.as_tensor(arr, device=device)
    if f.ndim != 2:
        f = f.reshape(1, -1)
    return f.expand(b, c).contiguous(), apply_fill


def resample_fused(
    data: torch.Tensor,
    matrices,
    control_points,
    *,
    out_shape=None,
    mode: str = "linear",
    fill=0.0,
) -> torch.Tensor:
    """Resample a (B, C, I, J, K) batch from per-element grid SPECS.

    Args:
        data: (B, C, I, J, K) tensor; the resample runs on its device.
        matrices: length-B list of 4x4 host float64 output->input maps.
        control_points: length-B list of pre-folded coarse displacement
            fields (input-voxel units) or None entries.
        out_shape: (Io, Jo, Ko) output spatial shape (defaults to the
            input spatial shape).
        mode: "linear" or "nearest".
        fill: scalar / (C,) / (B, C) out-of-bounds fill, host or tensor.

    Returns:
        (B, C, Io, Jo, Ko) float32 tensor. A CUDA batch goes through the
        CUDA kernel; a CPU batch through :func:`resample_plain`.
    """
    if mode not in MODES:
        raise ValueError(f"Unsupported resampling mode: {mode!r}")
    b, c = data.shape[:2]
    if len(matrices) != b or len(control_points) != b:
        raise ValueError(f"Expected {b} maps and {b} control-point entries")
    out_spatial = tuple(
        int(s) for s in (out_shape if out_shape is not None else data.shape[-3:])
    )
    vol = data.to(torch.float32).contiguous()
    maps, fields = _marshal_maps(matrices, control_points, data.device)
    fill_bc, apply_fill = _fill_bc(fill, b, c, data.device)
    if data.device.type == "cuda":
        from .resample_kernel import resample_cuda

        return resample_cuda(vol, maps, fields, fill_bc, out_spatial, mode, apply_fill)
    if data.device.type != "cpu":
        raise ValueError(f"resample_fused runs on cuda or cpu, got {data.device}")
    return resample_plain(vol, maps, fields, fill_bc, out_spatial, mode, apply_fill)


def dense_coords(coords, b: int, device) -> torch.Tensor:
    """Validate dense coordinates: a shared (Io, Jo, Ko, 3) grid or
    per-element (B, Io, Jo, Ko, 3) grids -> a contiguous float32 (1 or B,
    Io, Jo, Ko, 3) tensor on ``device``."""
    if isinstance(coords, torch.Tensor):
        grid = coords.to(device=device, dtype=torch.float32)
    else:  # a host array, copied (it may be read-only)
        grid = torch.tensor(np.asarray(coords, np.float32), device=device)
    if grid.ndim == 4:
        grid = grid[None]
    if grid.ndim != 5 or grid.shape[-1] != 3 or grid.shape[0] not in (1, b):
        raise ValueError(
            f"coords must be (Io, Jo, Ko, 3) or ({b}, Io, Jo, Ko, 3),"
            f" got {tuple(grid.shape)}"
        )
    return grid.contiguous()


def _check_fill(fill, b: int, c: int) -> None:
    """The JAX package's fill validation: scalar, (C,) or (B, C)."""
    if isinstance(fill, torch.Tensor):
        if fill.ndim not in (0, 1, 2):
            raise ValueError(f"fill must be scalar/(C,)/(B, C), got {tuple(fill.shape)}")
        return
    arr = np.asarray(fill, np.float32)
    if arr.ndim == 2:
        if arr.shape != (b, c):
            raise ValueError(f"2D fill must have shape (B, C) = {(b, c)}, got {arr.shape}")
    elif arr.reshape(-1).shape[0] not in (1, c):
        raise ValueError(
            f"fill must be scalar, per-channel ({c},), or (B, C); got shape {arr.shape}"
        )


def resample(data: torch.Tensor, coords, *, mode: str = "linear", fill=0.0) -> torch.Tensor:
    """Resample a (B, C, I, J, K) batch at input-voxel coordinates.

    Args:
        data: (B, C, I, J, K) tensor; the resample runs on its device.
        coords: (Io, Jo, Ko, 3) grid shared by the batch, or (B, Io, Jo,
            Ko, 3) per-element grids, in input voxel coordinates.
        mode: "linear" or "nearest".
        fill: scalar, per-channel (C,), or per-element-per-channel (B, C)
            fill for out-of-bounds voxels, host or tensor (a host scalar
            of 0 applies none).

    Returns:
        (B, C, Io, Jo, Ko) float32 tensor. A CUDA batch goes through the
        dense-coordinate CUDA kernel, a CPU batch through
        :func:`resample_coords_plain`.
    """
    if mode not in MODES:
        raise ValueError(f"Unsupported resampling mode: {mode!r}")
    if data.ndim != 5:
        raise ValueError(f"data must be (B, C, I, J, K), got {tuple(data.shape)}")
    b, c = data.shape[:2]
    _check_fill(fill, b, c)
    grid = dense_coords(coords, b, data.device)
    vol = data.to(torch.float32).contiguous()
    fill_bc, apply_fill = _fill_bc(fill, b, c, data.device)
    if data.device.type == "cuda":
        from .resample_kernel import resample_coords_cuda

        return resample_coords_cuda(vol, grid, fill_bc, mode, apply_fill)
    if data.device.type != "cpu":
        raise ValueError(f"resample runs on cuda or cpu, got {data.device}")
    return resample_coords_plain(vol, grid, fill_bc, mode, apply_fill)


def resample_label_fused(
    data: torch.Tensor,
    matrices,
    control_points,
    *,
    out_shape=None,
    pad_label: float = 0.0,
) -> torch.Tensor:
    """Partial-volume label resample of a (B, 1, I, J, K) label batch
    from per-element grid specs (arguments as :func:`resample_fused`).

    Integer labels vote in int32 (values above 2^24 survive, which a
    float32 round trip would not), float labels in float32; the result
    comes back in ``data``'s dtype. A CUDA batch goes through the CUDA
    kernel, a CPU batch through :func:`resample_label_plain`.
    """
    b = data.shape[0]
    if data.ndim != 5 or data.shape[1] != 1:
        raise ValueError(f"labels must be (B, 1, I, J, K), got {tuple(data.shape)}")
    if len(matrices) != b or len(control_points) != b:
        raise ValueError(f"Expected {b} maps and {b} control-point entries")
    out_spatial = tuple(
        int(s) for s in (out_shape if out_shape is not None else data.shape[-3:])
    )
    work = torch.float32 if data.dtype.is_floating_point else torch.int32
    vol = data.to(work).contiguous()
    maps, fields = _marshal_maps(matrices, control_points, data.device)
    if data.device.type == "cuda":
        from .resample_kernel import resample_label_cuda

        out = resample_label_cuda(vol, maps, fields, out_spatial, pad_label)
    elif data.device.type == "cpu":
        out = resample_label_plain(vol, maps, fields, out_spatial, pad_label)
    else:
        raise ValueError(f"resample_label_fused runs on cuda or cpu, got {data.device}")
    return cast_like_jax(out, data.dtype)
