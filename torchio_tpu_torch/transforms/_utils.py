"""Shared helpers for transform implementations."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from ..core.dtypes import movable
from ..parallel.mesh import Region, from_local, is_dtensor, local_slices, region_of, sharding_of

__all__ = ["as_tensor", "broadcast_param", "restore_gated", "unique_labels"]


def broadcast_param(value: Any, like: torch.Tensor):
    """Scalar passthrough, or per-element list -> (B, 1, 1, 1, 1) float32
    tensor on ``like``'s device."""
    if isinstance(value, (list, np.ndarray, torch.Tensor)):
        arr = torch.as_tensor(np.asarray(value, dtype=np.float32), device=like.device)
        return arr.reshape((-1,) + (1,) * (like.ndim - 1))
    return value


def restore_gated(transformed: torch.Tensor, original: torch.Tensor, keep):
    """Gated-out elements keep their original values (bit-exact)."""
    if keep is None:
        return transformed
    flags = np.asarray(keep, dtype=bool)
    if flags.all():
        return transformed
    if is_dtensor(transformed):  # each rank its own rows
        sharding = sharding_of(transformed)
        rows = local_slices(transformed.shape, sharding)[0]
        local = restore_gated(transformed.to_local(), original.to_local(), flags[rows])
        return from_local(local, sharding, transformed.shape)
    mask = torch.as_tensor(flags, device=transformed.device)
    mask = mask.reshape((-1,) + (1,) * (transformed.ndim - 1))
    kept = torch.where(mask, movable(transformed), movable(original.to(transformed.dtype)))
    return kept.view(transformed.dtype)


def unique_labels(data: torch.Tensor) -> list[int]:
    """Sorted unique labels as ints. An integer map with labels in
    [0, 65535] is counted by a ``bincount`` on its device, so only the
    histogram reaches the host; anything else goes through ``np.unique``
    (float labels are truncated to int, as in the JAX package). A
    DTensor's labels are counted on each rank's region
    (:func:`region_labels`)."""
    if is_dtensor(data):
        return region_labels(region_of(data))
    if not data.dtype.is_floating_point and data.dtype != torch.bool:
        lo, hi = int(data.min()), int(data.max())
        if 0 <= lo and hi <= 65535:
            counts = torch.bincount(data.reshape(-1).to(torch.int32), minlength=hi + 1)
            return [int(i) for i in torch.nonzero(counts).reshape(-1).tolist()]
    return sorted(int(v) for v in np.unique(data.detach().cpu().numpy()))


#: the widest label range a sharded map's labels are counted over
_LABEL_SPAN = 65536


def region_labels(region: Region) -> list[int]:
    """The sorted labels of the whole tensor a :class:`Region` is part of,
    from its block alone: the block's largest label, its negated smallest
    and whether it holds a non-integral value, reduced to the mesh's by
    one ``all_reduce(MAX)`` over each mesh axis that splits B or J; then
    the block's ``bincount`` over that range, summed over the same axes
    (one ``all_reduce`` each), and only the histogram reaches the host.
    Labels spanning more than 65536 values, or non-integral float
    labels, raise: their set is not a histogram's."""
    local = region.local
    device = local.device
    floor = -(2**62)
    stats = torch.full((3,), floor, dtype=torch.int64, device=device)
    if local.numel():
        values = local.reshape(-1)
        if values.dtype == torch.bool:
            values = values.to(torch.int64)
        if values.dtype.is_floating_point:
            stats[2] = (values != torch.trunc(values)).any().to(torch.int64)
        stats[0], stats[1] = values.max().to(torch.int64), -values.min().to(torch.int64)
    hi, lo, fractional = (int(v) for v in region.reduce_max(stats).tolist())
    lo = -lo
    if hi == floor:
        return []
    if fractional > 0 or hi - lo >= _LABEL_SPAN:
        raise ValueError(
            f"a sharded label map's labels are counted by a histogram: integral values"
            f" spanning at most {_LABEL_SPAN}, got [{lo}, {hi}]"
            + (" with fractional values" if fractional > 0 else "")
        )
    length = hi - lo + 1
    counts = torch.zeros(length, dtype=torch.int64, device=device)
    if local.numel():
        counts = torch.bincount(local.reshape(-1).to(torch.int64) - lo, minlength=length)
    counts = region.reduce_sum(counts)
    return [int(i) + lo for i in torch.nonzero(counts).reshape(-1).tolist()]
