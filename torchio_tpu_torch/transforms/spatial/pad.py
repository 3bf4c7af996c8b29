"""Pad: add voxels at the volume borders (the affine origin shifts back).

Counterpart of ``torchio_tpu/transforms/spatial/pad.py``. A sharded
batch is padded on each rank's region (:func:`._padding.pad_region`).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ...data.batch import SubjectsBatch
from ..transform import SpatialTransform
from ._padding import pad_region, parse_padding_mode


def parse_six(value, name: str) -> tuple[int, int, int, int, int, int]:
    """int | (i, j, k) | 6-tuple -> per-side 6-tuple."""
    if isinstance(value, (int, np.integer)):
        v = int(value)
        return (v,) * 6
    values = [int(v) for v in value]
    if len(values) == 3:
        i, j, k = values
        return (i, i, j, j, k, k)
    if len(values) == 6:
        return tuple(values)  # type: ignore[return-value]
    raise ValueError(f"{name} must have 1, 3, or 6 values, got {len(values)}")


def shift_origin(affine, corner_ijk) -> None:
    """Shift an AffineMatrix origin by a voxel offset (in place)."""
    m = affine.data
    m[:3, 3] += m[:3, :3] @ np.asarray(corner_ijk, dtype=np.float64)


class Pad(SpatialTransform):
    r"""Add ``(i_ini, i_fin, j_ini, j_fin, k_ini, k_fin)`` voxels of border.

    ``padding_mode`` is one of constant/reflect/replicate/circular or the
    whole-volume statistics mean/median/minimum (computed per element).
    Invertible (-> Crop).
    """

    takes_sharded = True

    def __init__(
        self,
        *,
        padding,
        padding_mode: str = "constant",
        fill: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.padding = parse_six(padding, "Padding")
        self.padding_mode = parse_padding_mode(padding_mode)
        self.fill = fill

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {
            "padding": self.padding,
            "padding_mode": self.padding_mode,
            "fill": self.fill,
        }

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        i0, i1, j0, j1, k0, k1 = params["padding"]
        for img_batch in self._get_images(batch).values():
            img_batch.data = pad_region(
                img_batch.data,
                (i0, i1, j0, j1, k0, k1),
                params["padding_mode"],
                params["fill"],
            )
            for affine in img_batch.affines:
                shift_origin(affine, (-float(i0), -float(j0), -float(k0)))
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]):
        from .crop import Crop

        return Crop(cropping=params["padding"], copy=False)
