"""Crop: remove voxels from the volume borders (the affine origin shifts).

Counterpart of ``torchio_tpu/transforms/spatial/crop.py``.
"""

from __future__ import annotations

from typing import Any

from ...data.batch import SubjectsBatch
from ..transform import SpatialTransform
from .pad import parse_six, shift_origin


def crop_tensor(data, cropping):
    """The (..., I, J, K) tensor without its ``cropping`` border voxels."""
    i0, i1, j0, j1, k0, k1 = cropping
    si, sj, sk = data.shape[-3:]
    for axis, (size, lo, hi) in enumerate(zip((si, sj, sk), (i0, j0, k0), (i1, j1, k1))):
        if size - lo - hi < 1:
            raise ValueError(
                f"Cropping ({lo}, {hi}) removes all {size} voxels"
                f" of spatial axis {axis}"
            )
    return data[..., i0 : si - i1 or None, j0 : sj - j1 or None, k0 : sk - k1 or None]


class Crop(SpatialTransform):
    r"""Remove ``(i_ini, i_fin, j_ini, j_fin, k_ini, k_fin)`` border voxels.

    Invertible (-> Pad with zero fill).
    """

    def __init__(self, *, cropping, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.cropping = parse_six(cropping, "Cropping")

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {"cropping": self.cropping}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        i0, _, j0, _, k0, _ = params["cropping"]
        for img_batch in self._get_images(batch).values():
            img_batch.data = crop_tensor(img_batch.data, params["cropping"])
            for affine in img_batch.affines:
                shift_origin(affine, (float(i0), float(j0), float(k0)))
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]):
        from .pad import Pad

        return Pad(padding=params["cropping"], copy=False)
