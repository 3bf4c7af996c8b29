"""ToReferenceSpace: give images a reference image's field of view.

Counterpart of ``torchio_tpu/transforms/spatial/to_reference_space.py``:
each image keeps its data and takes an affine, computed on the host in
float64, that places its grid in the reference's field of view with the
reference's centre and orientation.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ...core.affine import AffineMatrix
from ...data.batch import SubjectsBatch
from ...data.image import Image
from ..transform import SpatialTransform


def _reference_space_affine(reference: Image, output_shape) -> AffineMatrix:
    """Affine placing a grid of ``output_shape`` in the reference FOV,
    sharing its physical center and orientation."""
    ref_affine = reference.affine
    rotation = ref_affine.direction.astype(np.float64)
    ref_spacing = np.asarray(ref_affine.spacing, np.float64)
    ref_origin = np.asarray(ref_affine.origin, np.float64)
    ref_shape = np.asarray(reference.spatial_shape, np.float64)
    new_shape = np.asarray(output_shape, np.float64)
    new_spacing = ref_spacing * (ref_shape / new_shape)
    center = ref_origin + rotation @ (((ref_shape - 1) / 2) * ref_spacing)
    new_origin = center - rotation @ (((new_shape - 1) / 2) * new_spacing)
    matrix = np.eye(4)
    matrix[:3, :3] = rotation * new_spacing
    matrix[:3, 3] = new_origin
    return AffineMatrix(matrix)


class ToReferenceSpace(SpatialTransform):
    """Replace each image's affine with a reference-space affine
    (data unchanged) — e.g. to give network embeddings real geometry."""

    def __init__(self, reference: Image, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(reference, Image):
            raise TypeError(
                f"reference must be an Image, got {type(reference).__name__}"
            )
        self.reference = reference

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            output_shape = tuple(int(s) for s in img_batch.data.shape[2:])
            new_affine = _reference_space_affine(self.reference, output_shape)
            img_batch.affines[:] = [new_affine.clone() for _ in img_batch.affines]
        return batch

    @staticmethod
    def from_tensor(tensor, reference: Image) -> Image:
        """Image of the reference's class built from ``tensor`` (kept as it
        is, on its device; host data goes to the default device) with
        reference-space metadata."""
        output_shape = tuple(int(s) for s in tensor.shape[-3:])
        new_affine = _reference_space_affine(reference, output_shape)
        return type(reference)(tensor, affine=new_affine)
