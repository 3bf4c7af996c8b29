"""Shared spatial padding helpers.

Counterpart of ``torchio_tpu/transforms/spatial/_padding.py`` (modes
constant/reflect/replicate/circular, and the whole-volume statistics
mean/median/minimum, one value per batch element), with ``jnp.pad``'s
semantics: a reflect or circular pad wider than its axis reflects or
wraps again, so each mode gathers its border voxels at computed indices
(``F.pad`` refuses pads as wide as the axis).
"""

from __future__ import annotations

import warnings

import torch

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
        value = torch.tensor(float(fill), dtype=torch.float64).to(data.dtype).item()
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
