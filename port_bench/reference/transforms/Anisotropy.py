"""Anisotropy: each element drawn an axis from (0, 1, 2) and a factor
from ``downsampling``; a factor above 1 takes that axis of every image
down to ``round(L / factor)`` samples (Python's ``round``, at least 1) at
the nearest voxel, sample ``m`` taking voxel ``m L // down``, and back up
to ``L``: scalar images linearly with aligned corners, label maps at the
nearest sample. A factor of at most 1 leaves the element as it is."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws

NEEDS_FIRST = False
SUPPORTED = {"downsampling"}
AXES = (0, 1, 2)


def draw(args: dict, rng, ctx):
    unknown = set(args) - SUPPORTED
    if unknown:
        raise NotImplementedError(f"the Anisotropy reference has no {sorted(unknown)}")
    # the coin, then each element's axis and factor: with no ``p`` the
    # program draws no keep mask
    if not draws.coin(args, rng, ctx.batch):
        return None
    axes, factors = [], []
    for _ in range(ctx.batch):
        axes.append(AXES[int(rng.integers(len(AXES)))])
        factors.append(max(1.0, draws.sample_1d(args.get("downsampling", 1.0), rng)))
    return {"axis": axes, "factor": factors}


def degrade(vol: torch.Tensor, dim: int, factor: float, linear: bool) -> torch.Tensor:
    """``vol`` taken down along ``dim`` and back up (float32 where
    ``linear``, else in its own type)."""
    length = vol.shape[dim]
    down = max(1, round(length / factor))
    dev = vol.device
    low = vol.index_select(dim, torch.arange(down, device=dev) * length // down)
    if not linear:
        return low.index_select(dim, torch.arange(length, device=dev) * down // length)
    at = np.arange(length, dtype=np.float64) * ((down - 1) / (length - 1) if length > 1 else 0.0)
    lower = np.floor(at).astype(np.int64)
    upper = np.minimum(lower + 1, down - 1)
    shape = [1] * vol.ndim
    shape[dim] = length
    w = torch.as_tensor((at - lower).astype(np.float32), device=dev).reshape(shape)
    low = low.to(torch.float32)
    return (low.index_select(dim, torch.as_tensor(lower, device=dev)) * (1.0 - w)
            + low.index_select(dim, torch.as_tensor(upper, device=dev)) * w)


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = {}
    for name, image in ctx.images.items():
        volumes = []
        for r, b in enumerate(rows):
            vol, factor = data[name][r], params["factor"][b]
            if factor <= 1.0:
                volumes.append(vol)
                continue
            moved = degrade(vol, params["axis"][b] + 1, factor, image.kind == "scalar")
            volumes.append(ctx.store(moved) if image.kind == "scalar" else moved)
        out[name] = torch.stack(volumes)
    return out
