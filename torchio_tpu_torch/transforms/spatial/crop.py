"""Crop: remove voxels from the volume borders (the affine origin shifts).

Counterpart of ``torchio_tpu/transforms/spatial/crop.py``. A sharded
batch is cropped on each rank's region: along B, I and K in place;
along a J split each rank's output columns come from the ranks that
hold them (one ``batch_isend_irecv`` over ``space``), placed by the new
J extent.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ...data.batch import SubjectsBatch
from ...parallel.mesh import is_dtensor, region_of
from ..transform import SpatialTransform
from .pad import parse_six, shift_origin


def _check_cropping(spatial, cropping) -> None:
    i0, i1, j0, j1, k0, k1 = cropping
    for axis, (size, lo, hi) in enumerate(zip(spatial, (i0, j0, k0), (i1, j1, k1))):
        if size - lo - hi < 1:
            raise ValueError(
                f"Cropping ({lo}, {hi}) removes all {size} voxels"
                f" of spatial axis {axis}"
            )


def crop_tensor(data, cropping):
    """The (..., I, J, K) tensor without its ``cropping`` border voxels (a
    DTensor on each rank's region)."""
    if is_dtensor(data):
        return _crop_region(data, cropping)
    i0, i1, j0, j1, k0, k1 = cropping
    si, sj, sk = data.shape[-3:]
    _check_cropping((si, sj, sk), cropping)
    return data[..., i0 : si - i1 or None, j0 : sj - j1 or None, k0 : sk - k1 or None]


def _crop_region(data, cropping):
    i0, i1, j0, j1, k0, k1 = (int(v) for v in cropping)
    region = region_of(data)
    region.check_rows()
    b, c, si, sj, sk = region.shape
    _check_cropping((si, sj, sk), cropping)
    shape = (b, c, si - i0 - i1, sj - j0 - j1, sk - k0 - k1)
    local = region.local[:, :, i0 : si - i1, :, k0 : sk - k1]
    if j0 or j1:
        local = region.fetch_columns(local, shape[3], lambda a, z: np.arange(a, z) + j0)
    return region.wrap(local, shape)


class Crop(SpatialTransform):
    r"""Remove ``(i_ini, i_fin, j_ini, j_fin, k_ini, k_fin)`` border voxels.

    Invertible (-> Pad with zero fill).
    """

    takes_sharded = True

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
