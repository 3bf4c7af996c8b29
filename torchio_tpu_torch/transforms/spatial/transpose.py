"""Transpose (swap the first and last spatial axes; self-inverse) and
CopyAffine (every image takes a target image's affines).

Counterpart of ``torchio_tpu/transforms/spatial/transpose.py``. The
transposed tensor is a view: the kernel wrappers make their inputs
contiguous where they need it.
"""

from __future__ import annotations

from typing import Any

from ...data.batch import SubjectsBatch
from ..transform import SpatialTransform


class Transpose(SpatialTransform):
    r"""(C, I, J, K) -> (C, K, J, I); affine columns 0 and 2 swap."""

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            img_batch.data = img_batch.data.permute(0, 1, 4, 3, 2)
            for affine in img_batch.affines:
                m = affine.data.copy()
                affine._matrix[:, 0] = m[:, 2]
                affine._matrix[:, 2] = m[:, 0]
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "Transpose":
        return Transpose(copy=False)


class CopyAffine(SpatialTransform):
    """Copy the affine of a target image to all other images."""

    def __init__(self, target: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.target = target

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        if self.target not in batch.images:
            raise KeyError(
                f"Reference image '{self.target}' not found."
                f" Available: {list(batch.images)}"
            )
        ref = batch.images[self.target].affines
        for name, img_batch in batch.images.items():
            if name == self.target:
                continue
            for i, affine in enumerate(img_batch.affines):
                affine._matrix = ref[i].data.copy()
        return batch
