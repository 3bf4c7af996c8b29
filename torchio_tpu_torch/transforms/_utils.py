"""Shared helpers for transform implementations."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from ..core.dtypes import movable

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
    mask = torch.as_tensor(flags, device=transformed.device)
    mask = mask.reshape((-1,) + (1,) * (transformed.ndim - 1))
    kept = torch.where(mask, movable(transformed), movable(original.to(transformed.dtype)))
    return kept.view(transformed.dtype)


def unique_labels(data: torch.Tensor) -> list[int]:
    """Sorted unique labels as ints. An integer map with labels in
    [0, 65535] is counted by a ``bincount`` on its device, so only the
    histogram reaches the host; anything else goes through ``np.unique``
    (float labels are truncated to int, as in the JAX package)."""
    if not data.dtype.is_floating_point and data.dtype != torch.bool:
        lo, hi = int(data.min()), int(data.max())
        if 0 <= lo and hi <= 65535:
            counts = torch.bincount(data.reshape(-1).to(torch.int32), minlength=hi + 1)
            return [int(i) for i in torch.nonzero(counts).reshape(-1).tolist()]
    return sorted(int(v) for v in np.unique(data.detach().cpu().numpy()))
