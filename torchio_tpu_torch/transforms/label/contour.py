"""Contour: surface voxels of each label via morphological erosion.

Counterpart of ``torchio_tpu/transforms/label/contour.py``: the map is
padded with -1 and eroded by a 3x3x3 minimum (a max pool of the negated
map); a voxel is on the contour where the erosion changed it. A minimum
is exact, so the result equals the JAX package's. Scalar images are
left as they are.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ..transform import Transform


def _extract_contour(data: torch.Tensor) -> torch.Tensor:
    f32 = data.to(torch.float32)
    b, c = f32.shape[:2]
    padded = F.pad(f32, (1, 1, 1, 1, 1, 1), value=-1.0)
    flat = padded.reshape(b * c, 1, *padded.shape[2:])
    eroded = -F.max_pool3d(-flat, 3, stride=1).reshape(f32.shape)
    return (eroded != f32).to(torch.float32)


class Contour(Transform):
    """Replace each label map with its boundary voxels (binary)."""

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            img_batch.data = _extract_contour(img_batch.data)
        return batch
