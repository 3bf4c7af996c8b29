"""Contour: surface voxels of each label via morphological erosion.

Counterpart of ``torchio_tpu/transforms/label/contour.py``: the map is
padded with -1 and eroded by a 3x3x3 minimum (a max pool of the negated
map); a voxel is on the contour where the erosion changed it. A minimum
is exact, so the result equals the JAX package's. Scalar images are
left as they are. On a batch sharded along J each rank erodes its block
with one plane from each neighbour (the halo exchange of
:mod:`...parallel.halo`), -1 past the global ends.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import region_of
from ..transform import Transform


def _extract_contour(data: torch.Tensor) -> torch.Tensor:
    """The contour of a (B, C, I, J, K) map (a DTensor on each rank's
    region; a J split takes one plane from each neighbour)."""
    region = region_of(data)
    region.check_rows()  # the planes it takes from its neighbours lie along J
    f32 = region.local.to(torch.float32)
    left = right = None
    if region.parts(3) > 1:
        if f32.shape[3] == 0:
            raise ValueError("Contour of a J block of no columns: shard J into fewer blocks")
        from ...parallel.halo import _neighbour_slabs

        left, right = _neighbour_slabs(f32, 1, region.space_group)
    return region.wrap(contour_block(f32, left, right))


def contour_block(f32: torch.Tensor, left=None, right=None) -> torch.Tensor:
    """The contour of a float32 (B, C, I, jl, K) block of J columns, given
    the plane before it and the plane after it (each (B, C, I, 1, K), None
    past the global ends: -1, as the whole map's padding): each shard's
    local program."""
    b, c = f32.shape[:2]
    edge = f32.new_full((*f32.shape[:3], 1, f32.shape[4]), -1.0)
    extended = torch.cat([edge if left is None else left, f32,
                          edge if right is None else right], dim=3)
    padded = F.pad(extended, (1, 1, 0, 0, 1, 1), value=-1.0)
    flat = padded.reshape(b * c, 1, *padded.shape[2:])
    eroded = -F.max_pool3d(-flat, 3, stride=1).reshape(f32.shape)
    return (eroded != f32).to(torch.float32)


class Contour(Transform):
    """Replace each label map with its boundary voxels (binary)."""

    takes_sharded = True

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            img_batch.data = _extract_contour(img_batch.data)
        return batch
