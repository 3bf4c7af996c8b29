"""Mesh-scale patch inference: GridSampler -> model -> PatchAggregator
over a J-sharded volume, with NO whole-volume gather.

Counterpart of ``torchio_tpu/parallel/patches.py``. The (B, C, I, J, K)
batch is split along J over the mesh's space axis and each rank:

1. takes a patch-wide J halo from its neighbours (zeros at the global
   ends);
2. extracts its OWN patches (those whose grid corner falls in its J
   slab; the halo covers patches overhanging its right edge);
3. runs the model on its flat patch batch;
4. adds the weighted outputs and the window weights into its
   halo-extended slab (:func:`accumulate_patches`), and
5. folds the halo sums back onto the neighbours that own those rows (the
   reverse exchange, :func:`fold_halos`) before normalising.

The result equals the single-device ``GridSampler`` -> ``PatchAggregator``
in "hann" and "average" modes.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import HaloUnsupported, _exchange_halo_zero, _neighbour_slabs, _local_of
from .mesh import NamedSharding, axis_index, axis_size, from_local


def grid_corners(spatial_shape, patch_size, patch_overlap) -> np.ndarray:
    """The GridSampler corner grid (regular steps + end snap), (N, 3)."""
    axes = []
    for dim in range(3):
        size = int(spatial_shape[dim])
        patch = int(patch_size[dim])
        step = max(patch - int(patch_overlap[dim]), 1)
        idx = list(range(0, size - patch + 1, step))
        if not idx or idx[-1] != size - patch:
            idx.append(max(size - patch, 0))
        axes.append(idx)
    return np.asarray(
        [(i, j, k) for i in axes[0] for j in axes[1] for k in axes[2]],
        np.int32,
    )


def _partition_corners(corners: np.ndarray, n_space: int, jl: int):
    """Assign each corner to the shard owning its J index; pad every
    shard's list to the max count (padded rows carry weight 0)."""
    owner = np.minimum(corners[:, 1] // jl, n_space - 1)
    per_shard = [corners[owner == s] for s in range(n_space)]
    n_max = max(len(p) for p in per_shard)
    out = np.zeros((n_space, n_max, 3), np.int32)
    valid = np.zeros((n_space, n_max), np.float32)
    for s, rows in enumerate(per_shard):
        out[s, : len(rows)] = rows
        valid[s, : len(rows)] = 1.0
    return out, valid


def patch_window(patch_size, overlap_mode: str, device) -> torch.Tensor:
    """The aggregation window: the 3D hann window, or one everywhere."""
    from ..data.aggregator import _build_hann_3d

    if overlap_mode == "hann":
        return torch.as_tensor(_build_hann_3d(patch_size), device=device)
    return torch.ones((1, 1, 1), dtype=torch.float32, device=device)


def _region(corner, patch_size, shape) -> tuple[slice, ...]:
    """(B, C, I, J, K) slices of a patch at ``corner``, clamped to fit as
    XLA's ``dynamic_slice`` clamps (a padded corner row is clamped)."""
    starts = (min(max(int(c), 0), int(n) - int(p)) for c, p, n in zip(corner, patch_size, shape))
    return (slice(None), slice(None)) + tuple(
        slice(s, s + int(p)) for s, p in zip(starts, patch_size)
    )


def accumulate_patches(ext, corners, valid, patch_size, window, model_fn=None):
    """One rank's weighted sums over its halo-extended slab.

    Args:
        ext: (B, C, I, jl + 2 halo, K) zero-halo slab.
        corners: (n, 3) patch corners in the slab's frame; ``valid`` (n,)
            1 for a patch, 0 for a padded row.
        window: the aggregation window (:func:`patch_window`).
        model_fn: a shape-preserving model of the flat (n B, C, *patch)
            batch (the identity where None).

    Returns (acc, cnt), each (B, C, I, jl + 2 halo, K) float32.
    """
    b, c = ext.shape[:2]
    spatial = ext.shape[2:]
    regions = [_region(corner, patch_size, spatial) for corner in np.asarray(corners)]
    patches = torch.stack([ext[r] for r in regions])  # (n, B, C, *patch)
    flat = patches.reshape(len(regions) * b, c, *patch_size)
    out = flat if model_fn is None else model_fn(flat)
    out = out.reshape(len(regions), b, c, *patch_size).to(torch.float32)
    acc = torch.zeros(ext.shape, dtype=torch.float32, device=ext.device)
    cnt = torch.zeros_like(acc)
    for n, region in enumerate(regions):
        weight = window * float(valid[n])
        acc[region] = acc[region] + out[n] * weight
        cnt[region] = cnt[region] + weight.expand(b, c, *patch_size)
    return acc, cnt


def fold_local(buf, from_left, from_right, halo: int) -> torch.Tensor:
    """The centre rows of a halo-extended slab, plus the halo sums its
    right and left neighbours hold for them (None past the global ends,
    where the halo sums are zero)."""
    jl = buf.shape[3] - 2 * halo
    center = buf[:, :, :, halo:halo + jl].clone()
    if from_right is not None:
        center[:, :, :, jl - halo:] += from_right
    if from_left is not None:
        center[:, :, :, :halo] += from_left
    return center


def _fold(buf, halo: int, group) -> torch.Tensor:
    """The reverse exchange: each rank sends its left halo rows left and
    its right halo rows right, and adds what it receives."""
    from_left, from_right = _neighbour_slabs(buf, halo, group)
    return fold_local(buf, from_left, from_right, halo)


def sharded_grid_inference(
    volume,
    *,
    mesh,
    space_axis: str = "space",
    model_fn=None,
    patch_size,
    patch_overlap=0,
    overlap_mode: str = "hann",
):
    """Dense patch inference over a J-sharded (B, C, I, J, K) batch.

    Every patch of the GridSampler grid is extracted on the rank owning
    its corner, run through ``model_fn`` (default identity; must be
    shape-preserving), and hann/average-aggregated, with only halo-wide
    neighbour traffic. Equals the single-device GridSampler ->
    PatchAggregator result; returns a DTensor split along J (B whole).
    """
    if overlap_mode not in ("hann", "average"):
        raise HaloUnsupported(
            f"sharded aggregation supports 'hann'/'average', got {overlap_mode!r}"
        )
    b, c, si, sj, sk = volume.shape
    if isinstance(patch_size, int):
        patch_size = (patch_size,) * 3
    patch_size = tuple(int(v) for v in patch_size)
    if isinstance(patch_overlap, int):
        patch_overlap = (patch_overlap,) * 3
    n_space = axis_size(mesh, space_axis)
    if sj % n_space:
        raise HaloUnsupported(f"J={sj} not divisible by space={n_space}")
    jl = sj // n_space
    if patch_size[1] > jl:
        raise HaloUnsupported(f"patch J extent {patch_size[1]} exceeds shard width {jl}")
    corners = grid_corners((si, sj, sk), patch_size, patch_overlap)
    per_shard, valid = _partition_corners(corners, n_space, jl)
    s = axis_index(mesh, space_axis)
    j0, halo = s * jl, patch_size[1]
    sharding = NamedSharding(mesh, (None, None, None, space_axis, None))
    group = mesh.get_group(space_axis)
    xs = _local_of(volume, sharding)
    ext = _exchange_halo_zero(xs, halo, group)
    local_corners = per_shard[s].copy()
    local_corners[:, 1] += halo - j0
    window = patch_window(patch_size, overlap_mode, xs.device)
    acc, cnt = accumulate_patches(ext, local_corners, valid[s], patch_size, window, model_fn)
    out = _fold(acc, halo, group) / torch.clamp(_fold(cnt, halo, group), min=1e-8)
    return from_local(out, sharding, volume.shape)
