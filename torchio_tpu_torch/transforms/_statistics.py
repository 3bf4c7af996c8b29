"""Exact quantiles from order statistics of ordered 32-bit keys.

Counterpart of ``torchio_tpu/transforms/_statistics.py``. Each float32
maps to its order-preserving 32-bit key (flip every bit of a negative,
the sign bit of a non-negative); NaNs take the largest key, so a masked
volume passed as ``where(mask, data, nan)`` ranks against its non-NaN
count (``nanquantile``). The JAX package bisects the key space with 32
count passes (a TPU sort is slow); here one ``torch.sort`` of the keys
gives the same order statistics, read at ranks computed on the device,
so nothing reaches the host. Linear interpolation between adjacent
order statistics, in float32 with the multiply-add rounded once (as XLA
fuses it), matches ``jnp.quantile``'s default. ``torch.quantile`` is not used: it
interpolates in another order and refuses inputs over 2^24 elements.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _f32_to_ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its order-preserving key (int64 in ``[0, 2^32)``)."""
    u = x.to(torch.float32).view(torch.int32).to(torch.int64) & _MASK32
    return u ^ torch.where(u >= _SIGN, _MASK32, _SIGN)


def _ordered_to_f32(o: torch.Tensor) -> torch.Tensor:
    bits = o ^ torch.where(o < _SIGN, _MASK32, _SIGN)
    signed = torch.where(bits >= _SIGN, bits - 2**32, bits)
    return signed.to(torch.int32).view(torch.float32)


def quantiles_on_device(values, qs) -> torch.Tensor:
    """Exact linear-interpolation quantiles of a flattened tensor, NaNs
    ignored; a float32 tensor of ``len(qs)`` on ``values``' device (pull
    it once for all the quantiles)."""
    data = torch.as_tensor(values).reshape(-1).to(torch.float32)
    device = data.device
    q = torch.as_tensor(np.atleast_1d(np.asarray(qs, np.float32)), device=device)
    valid = ~torch.isnan(data)
    keys = torch.where(valid, _f32_to_ordered(data), _MASK32)
    n = valid.sum(dtype=torch.int32)
    top = (n - 1).to(torch.float32)
    pos = q * top  # 0-indexed fractional rank
    k = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), top)
    frac = pos - k
    lo_ranks = k.to(torch.int32) + 1  # 1-indexed
    hi_ranks = torch.minimum(lo_ranks + 1, torch.clamp(n, min=1))
    ranks = torch.cat([lo_ranks, hi_ranks]).to(torch.int64)
    if keys.numel() == 0:
        # the bisection's answer with nothing to count: no rank is reached
        stats = torch.full_like(ranks, _MASK32)
    else:
        ordered = torch.sort(keys).values
        picked = ordered[torch.clamp(ranks - 1, 0, keys.numel() - 1)]
        # rank 0 (an all-NaN input): the bisection stops at key 0
        stats = torch.where(ranks >= 1, picked, 0)
    values = _ordered_to_f32(stats)
    v_lo, v_hi = values[: q.numel()], values[q.numel():]
    return _fma(frac, v_hi - v_lo, v_lo)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend fuses it:
    the product of two float32 values is exact in float64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def compute_quantile(values, q: float) -> float:
    """Quantile (linear interpolation) of a flattened tensor; q in [0, 1]."""
    return float(quantiles_on_device(values, [q])[0])


def compute_quantiles(values, qs) -> np.ndarray:
    """Vector of quantiles of a flattened tensor (one host transfer)."""
    return quantiles_on_device(values, qs).cpu().numpy()


def median_rows(rows: torch.Tensor) -> torch.Tensor:
    """Per-row median of a (B, N) float32 tensor as ``jnp.quantile(rows,
    0.5, axis=1)`` computes it: the order statistics at ``floor`` and
    ``ceil`` of ``0.5 * (N - 1)`` (float32) from one sort of the ordered
    keys, then ``low * (1 - w) + high * w``, where both products are exact
    (``w`` is 0 or 1/2) and the sum rounds once; a row holding a NaN gives
    NaN. Stays on the rows' device."""
    n = rows.shape[1]
    pos = np.float32(0.5) * (np.float32(n) - np.float32(1))
    low = int(np.clip(np.floor(pos), 0, n - 1))
    high = int(np.clip(np.ceil(pos), 0, n - 1))
    w_high = np.float32(pos - np.floor(pos))
    w_low = np.float32(1) - w_high
    ordered = _ordered_to_f32(torch.sort(_f32_to_ordered(rows), dim=1).values)
    median = ordered[:, low] * float(w_low) + ordered[:, high] * float(w_high)
    return torch.where(torch.isnan(rows).any(dim=1), float("nan"), median)
