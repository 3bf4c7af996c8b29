"""Swap: exchange random same-size patch pairs (context-restoration
self-supervision).

Counterpart of ``torchio_tpu/transforms/intensity/swap.py``: pair
locations are drawn on the host (up to 100 tries for a pair that does
not overlap) and recorded with the patch size; the swaps run in
sequence, so they may chain. Each step is two gathers and two scatters
over every element at once, in the JAX package's order (the first
patch's location takes the second patch, then the second's takes the
first, so an overlap ends up holding the first patch): four launches a
step. An element with fewer steps than the batch's longest swaps a
patch with itself in the steps it lacks. A sharded batch swaps on each
rank's region: over B with no collective (the patches are each
element's own); along J each step's two patches are read in parts, one
``all_reduce`` over ``space`` gives every rank both whole, and each rank
writes its part.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import movable
from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import Region, region_of
from ..parameter_range import to_nonneg_range
from ..transform import IntensityTransform

def _overlap(a, b, patch_size) -> bool:
    for ai, bi, p in zip(a, b, patch_size):
        if ai + p <= bi or bi + p <= ai:
            return False
    return True


def _sample_locations(spatial_shape, patch_size, num_iterations: int):
    rng = tio_random.get_rng()
    max_ini = [s - p for s, p in zip(spatial_shape, patch_size)]
    if any(m < 0 for m in max_ini):
        raise ValueError(
            f"Patch size {patch_size} cannot be larger than spatial shape"
            f" {tuple(spatial_shape)}"
        )

    def origin():
        return tuple(int(rng.integers(m + 1)) if m else 0 for m in max_ini)

    locations = []
    for _ in range(num_iterations):
        first = origin()
        second = first
        for _ in range(100):
            second = origin()
            if not _overlap(first, second, patch_size):
                break
        locations.append((list(first), list(second)))
    return locations


def swap_patches(
    data: torch.Tensor, origins_a: np.ndarray, origins_b: np.ndarray, patch_size
) -> torch.Tensor:
    """Swap ``num_swaps`` patch pairs of each element of ``data`` (B, C,
    I, J, K) in sequence; ``origins_[ab]``: (B, num_swaps, 3) corners."""
    b, c, si, sj, sk = data.shape
    dev = data.device
    pi, pj, pk = patch_size
    grid = np.ix_(np.arange(pi), np.arange(pj), np.arange(pk))
    offsets = ((grid[0] * sj + grid[1]) * sk + grid[2]).reshape(-1)
    steps = origins_a.shape[1]
    corners = np.stack([origins_a, origins_b])  # (2, B, S, 3)
    starts = (corners[..., 0] * sj + corners[..., 1]) * sk + corners[..., 2]
    # (2, S, B, P) flat voxel indices of every patch, built on the device
    index = torch.as_tensor(starts.transpose(0, 2, 1), dtype=torch.int64, device=dev)
    index = index[..., None] + torch.as_tensor(offsets, dtype=torch.int64, device=dev)
    moved = movable(data)
    acc = torch.clone(moved, memory_format=torch.contiguous_format).reshape(b, c, -1)
    for step in range(steps):
        ia = index[0, step][:, None, :].expand(b, c, -1)
        ib = index[1, step][:, None, :].expand(b, c, -1)
        pa = torch.gather(acc, 2, ia)
        pb = torch.gather(acc, 2, ib)
        acc.scatter_(2, ia, pb)
        acc.scatter_(2, ib, pa)
    return acc.reshape(data.shape).view(data.dtype)


#: the integer type of each element width: the patches are summed as bits
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _sum_bits(parts: torch.Tensor, group) -> torch.Tensor:
    """``parts`` summed over ``group`` as integers of their bits (one
    ``all_reduce``): where one rank holds a value and every other rank
    zeros, the sum is that value's bits exactly (a float sum would turn a
    -0.0 into +0.0)."""
    import torch.distributed as dist

    bits = parts.view(_BITS[parts.element_size()])
    wide = bits.to(torch.int64)
    dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group)
    return wide.to(bits.dtype).view(parts.dtype)


def swap_region(data: torch.Tensor, origins_a: np.ndarray, origins_b: np.ndarray, patch_size):
    """:func:`swap_patches` of ``data`` (a DTensor on each rank's region:
    its rows' corners taken to the region; along a J split, a step's
    patches summed over ``space``)."""
    region = region_of(data)
    region.check_rows()
    origins_a, origins_b = region.take(origins_a), region.take(origins_b)
    if region.parts(3) == 1:
        return region.wrap(swap_patches(region.local, origins_a, origins_b, patch_size))
    return region.wrap(_swap_columns(region, origins_a, origins_b, patch_size))


def _swap_columns(region: Region, origins_a, origins_b, patch_size) -> torch.Tensor:
    """The swaps on this rank's J columns: each step reads its rows' parts
    of both patches, sums them over ``space`` (every rank's zeros where it
    holds no column), and writes its part of the first patch's place from
    the second patch, then of the second's from the first, in the whole
    map's order."""
    acc = torch.clone(movable(region.local), memory_format=torch.contiguous_format)
    rows, c, _, jl, _ = acc.shape
    pi, pj, pk = patch_size
    j0 = region.j0

    def parts(corner):
        i, j, k = (int(v) for v in corner)
        lo, hi = max(j, j0), min(j + pj, j0 + jl)
        return i, j, k, lo, hi

    for step in range(origins_a.shape[1]):
        corners = [[parts(origins[r, step]) for r in range(rows)]
                   for origins in (origins_a, origins_b)]
        read = acc.new_zeros((2, rows, c, pi, pj, pk))
        for which, places in enumerate(corners):
            for r, (i, j, k, lo, hi) in enumerate(places):
                if hi > lo:
                    read[which, r, :, :, lo - j:hi - j] = acc[r, :, i:i + pi, lo - j0:hi - j0,
                                                              k:k + pk]
        whole = _sum_bits(read, region.space_group)
        for which, places in enumerate(corners):
            for r, (i, j, k, lo, hi) in enumerate(places):
                if hi > lo:
                    acc[r, :, i:i + pi, lo - j0:hi - j0, k:k + pk] = whole[1 - which, r, :, :,
                                                                           lo - j:hi - j]
    return acc.view(region.local.dtype)


class Swap(IntensityTransform):
    """Exchange random same-size patch pairs within each image."""

    takes_sharded = True

    def __init__(
        self,
        *,
        patch_size: int | tuple[int, int, int] = 15,
        num_iterations: Any = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(patch_size, int):
            patch_size = (patch_size,) * 3
        self.patch_size = tuple(int(p) for p in patch_size)
        self.num_iterations = to_nonneg_range(num_iterations)

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        for img_batch in batch.images.values():
            if issubclass(img_batch.image_class, LabelMap):
                warnings.warn(
                    "Swap is applied to a subject containing LabelMap images."
                    " The spatial rearrangement will make labels inconsistent"
                    " with the swapped image. This transform is intended for"
                    " self-supervised learning.",
                    stacklevel=2,
                )
                break
        any_img = next(iter(batch.images.values()))
        spatial_shape = tuple(any_img.data.shape[2:])
        n = self._resolve_n(batch)
        if n is None:
            iterations = max(1, round(self.num_iterations.sample_1d()))
            return {
                # patch_size recorded so params alone replay the transform
                "patch_size": list(self.patch_size),
                "locations": _sample_locations(
                    spatial_shape, self.patch_size, iterations
                ),
            }
        keep = self._keep_mask(batch, n)
        locations = []
        for i in range(n):
            if keep is not None and not keep[i]:
                locations.append([])
                continue
            iterations = max(1, round(self.num_iterations.sample_1d()))
            locations.append(
                _sample_locations(spatial_shape, self.patch_size, iterations)
            )
        params = {"patch_size": list(self.patch_size), "locations": locations}
        self._tag_batched(params, batch, n, keep, ["locations"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        per_instance = self._is_per_instance_params(params)
        for img_batch in self._get_images(batch).values():
            data = img_batch.data
            b = data.shape[0]
            if per_instance:
                per_element = params["locations"]
            else:
                per_element = [params["locations"]] * b
            num_swaps = max((len(locs) for locs in per_element), default=0)
            if num_swaps == 0:
                continue
            origins_a = np.zeros((b, num_swaps, 3), np.int64)
            origins_b = np.zeros((b, num_swaps, 3), np.int64)
            for bi, locs in enumerate(per_element):
                for si, (a, bb) in enumerate(locs):
                    origins_a[bi, si] = a
                    origins_b[bi, si] = bb
                # inactive steps swap a patch with itself (no-op)
                for si in range(len(locs), num_swaps):
                    origins_b[bi, si] = origins_a[bi, si]
            patch_size = tuple(
                params.get("patch_size", getattr(self, "patch_size", None))
            )
            img_batch.data = swap_region(data, origins_a, origins_b, patch_size)
        return batch
