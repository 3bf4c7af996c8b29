"""Resize: interpolate to a target shape (field of view kept, spacing
scales).

Counterpart of ``torchio_tpu/transforms/spatial/resize.py``: nearest is
one index gather per axis (``floor(dst * in / out)``, as
``F.interpolate``'s nearest), linear the align_corners trilinear
:func:`~torchio_tpu_torch.ops.resample.upsample_volume`; both in float32,
cast back to the data's dtype. The affine's columns scale in float64.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...ops.resample import upsample_volume
from ..transform import SpatialTransform


def _resize_nearest(data: torch.Tensor, target) -> torch.Tensor:
    out = data
    for rel, n_out in enumerate(target):
        axis = out.ndim - 3 + rel
        n_in = out.shape[axis]
        idx = (np.arange(n_out) * n_in // n_out).clip(max=n_in - 1)
        out = torch.index_select(out, axis, torch.as_tensor(idx, device=out.device))
    return out


class Resize(SpatialTransform):
    r"""Resample to a fixed spatial shape (anisotropic scaling warning:
    prefer Resample + CropOrPad for medical data)."""

    def __init__(
        self,
        target_shape: int | tuple[int, int, int],
        *,
        image_interpolation: str = "linear",
        label_interpolation: str = "nearest",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(target_shape, int):
            target_shape = (target_shape,) * 3
        self.target_shape = tuple(int(s) for s in target_shape)
        self.image_interpolation = image_interpolation
        self.label_interpolation = label_interpolation

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {"target_shape": list(self.target_shape)}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        target = tuple(params["target_shape"])
        for img_batch in batch.images.values():
            is_label = issubclass(img_batch.image_class, LabelMap)
            mode = self.label_interpolation if is_label else self.image_interpolation
            data = img_batch.data
            old_shape = data.shape[2:]
            if mode == "nearest":
                resized = _resize_nearest(data.to(torch.float32), target)
            else:
                resized = upsample_volume(data.to(torch.float32), target)
            img_batch.data = cast_like_jax(resized, data.dtype)
            for affine in img_batch.affines:
                for axis in range(3):
                    affine._matrix[:3, axis] *= old_shape[axis] / target[axis]
        return batch
