"""Shared spatial padding helpers.

Counterpart of ``torchio_tpu/transforms/spatial/_padding.py`` (modes
constant/reflect/replicate/circular, and the whole-volume statistics
mean/median/minimum, one value per batch element), with ``jnp.pad``'s
semantics: a reflect or circular pad wider than its axis reflects or
wraps again, so each mode gathers its border voxels at computed indices
(``F.pad`` refuses pads as wide as the axis).

A sharded batch is padded on each rank's region (:func:`pad_region`):
along B, I and K in place; along a J split each rank's output columns
take their input columns (the shifted ones, or the mirrored, edge or
wrapped ones) from the ranks that hold them, point to point, and the
result is placed by the new J extent. The statistics modes read whole
elements: along a J split each rank's rows are gathered whole along J
over ``space`` first.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ...parallel.mesh import is_dtensor, map_rows, region_of
from .._statistics import median_rows

PADDING_MODES = (
    "constant",
    "reflect",
    "replicate",
    "circular",
    "mean",
    "median",
    "minimum",
)
_STATISTIC_MODES = ("mean", "median", "minimum")
_WIDE_UNSIGNED = (torch.uint16, torch.uint32)


def parse_padding_mode(padding_mode: str) -> str:
    if padding_mode not in PADDING_MODES:
        raise ValueError(
            f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}"
        )
    return padding_mode


def _padding_statistic(batch: torch.Tensor, mode: str) -> torch.Tensor:
    """One whole-volume statistic per batch element, shape (B,), in the
    batch's dtype. The mean is a float32 mean (torch sums in another
    order than XLA: within a few float32 ulps of the JAX package's); the
    median is exact (:func:`.._statistics.median_rows`); the minimum of
    uint16 and uint32 volumes is taken in int64."""
    flat = batch.reshape(batch.shape[0], -1)
    if mode == "minimum":
        if batch.dtype in _WIDE_UNSIGNED:  # torch has no amin for these
            return torch.amin(flat.to(torch.int64), dim=1).to(batch.dtype)
        return torch.amin(flat, dim=1)
    if not batch.dtype.is_floating_point:
        warnings.warn(
            f'Padding statistic for mode "{mode}" may be truncated:'
            " input image is not floating point.",
            RuntimeWarning,
            stacklevel=4,
        )
    ff = flat.to(torch.float32)
    stat = torch.mean(ff, dim=1) if mode == "mean" else median_rows(ff)
    return stat.to(batch.dtype)


def _border_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of every output position along an axis of ``n``
    voxels padded by ``lo`` and ``hi``, as ``jnp.pad`` reads them."""
    p = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return p.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(p, n)
    if n == 1:  # reflect: one voxel reflects onto itself
        return torch.zeros_like(p)
    m = torch.remainder(p, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def pad_tensor(data: torch.Tensor, padding, padding_mode: str, fill: float) -> torch.Tensor:
    """Pad a (C, I, J, K) or (B, C, I, J, K) tensor along its spatial axes."""
    if data.ndim not in (4, 5):
        raise ValueError(f"Expected a 4D or 5D image tensor, got {data.ndim}D")
    if any(int(v) < 0 for v in padding):
        raise ValueError(f"index can't contain negative values: padding {tuple(padding)}")
    i0, i1, j0, j1, k0, k1 = (int(v) for v in padding)
    spatial = data.shape[-3:]
    if padding_mode in ("reflect", "replicate", "circular"):
        out = data
        for axis, (lo, hi) in enumerate(((i0, i1), (j0, j1), (k0, k1))):
            if lo or hi:
                dim = data.ndim - 3 + axis
                index = _border_index(spatial[axis], lo, hi, padding_mode, data.device)
                out = out.index_select(dim, index)
        return out
    out_spatial = (spatial[0] + i0 + i1, spatial[1] + j0 + j1, spatial[2] + k0 + k1)
    if padding_mode == "constant":
        # the fill takes the data's type as jnp.pad casts it (float ->
        # integer truncates)
        value = _fill_value(fill, data.dtype)
        out = torch.full(
            (*data.shape[:-3], *out_spatial), value, dtype=data.dtype, device=data.device
        )
    else:
        unbatched = data.ndim == 4
        batch = data[None] if unbatched else data
        stat = _padding_statistic(batch, padding_mode)
        out = stat.reshape(-1, 1, 1, 1, 1).expand(
            batch.shape[0], batch.shape[1], *out_spatial
        ).clone()
        out = out[0] if unbatched else out
    out[..., i0 : i0 + spatial[0], j0 : j0 + spatial[1], k0 : k0 + spatial[2]] = data
    return out


def _fill_value(fill: float, dtype: torch.dtype):
    """The constant fill in the data's type, as ``jnp.pad`` casts it
    (float -> integer truncates)."""
    return torch.tensor(float(fill), dtype=torch.float64).to(dtype).item()


def pad_region(data: torch.Tensor, padding, padding_mode: str, fill: float) -> torch.Tensor:
    """:func:`pad_tensor` of a (B, C, I, J, K) tensor; a DTensor on each
    rank's region (see the module's docstring)."""
    if not is_dtensor(data):
        return pad_tensor(data, padding, padding_mode, fill)
    i0, i1, j0, j1, k0, k1 = (int(v) for v in padding)
    region = region_of(data)
    if padding_mode in _STATISTIC_MODES and region.parts(3) > 1:
        return map_rows(lambda rows: pad_tensor(rows, padding, padding_mode, fill), data)
    b, c, si, sj, sk = region.shape
    shape = (b, c, si + i0 + i1, sj + j0 + j1, sk + k0 + k1)
    if region.parts(3) == 1 or not (j0 or j1):
        return region.wrap(pad_tensor(region.local, padding, padding_mode, fill), shape)
    local = pad_tensor(region.local, (i0, i1, 0, 0, k0, k1), padding_mode, fill)
    if padding_mode == "constant":
        start, stop = region.columns(shape[3])
        first, last = max(start, j0), min(stop, j0 + sj)
        out = torch.full((*local.shape[:3], stop - start, local.shape[4]),
                         _fill_value(fill, data.dtype), dtype=data.dtype, device=local.device)
        inner = region.fetch_columns(
            local, shape[3], lambda a, z: np.arange(max(a, j0), min(z, j0 + sj)) - j0)
        if last > first:
            out[:, :, :, first - start:last - start] = inner
        return region.wrap(out, shape)
    index = _border_index(sj, j0, j1, padding_mode, "cpu").numpy()
    return region.wrap(region.fetch_columns(local, shape[3], lambda a, z: index[a:z]), shape)
