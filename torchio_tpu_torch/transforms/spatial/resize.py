"""Resize: interpolate to a target shape (field of view kept, spacing
scales).

Counterpart of ``torchio_tpu/transforms/spatial/resize.py``: nearest is
one index gather per axis (``floor(dst * in / out)``, as
``F.interpolate``'s nearest), linear the align_corners trilinear
:func:`~torchio_tpu_torch.ops.resample.upsample_volume`; both in float32,
cast back to the data's dtype. The affine's columns scale in float64.
A sharded batch resizes each rank's region: I and K in place; along a J
split each rank's output columns read their input columns from the
ranks that hold them (one ``batch_isend_irecv`` over ``space``), and the
result is placed by the new J extent.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...ops.resample import _axis_coords, _lerp_axis, upsample_volume
from ...parallel.mesh import Region, region_of
from ..transform import SpatialTransform


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    return (np.arange(n_out) * n_in // n_out).clip(max=n_in - 1)


def _nearest_axis(data: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    idx = _nearest_index(data.shape[axis], n_out)
    return torch.index_select(data, axis, torch.as_tensor(idx, device=data.device))


def _resize_nearest(data: torch.Tensor, target) -> torch.Tensor:
    out = data
    for rel, n_out in enumerate(target):
        out = _nearest_axis(out, n_out, out.ndim - 3 + rel)
    return out


def resize_region(region: Region, data: torch.Tensor, target, mode: str) -> torch.Tensor:
    """This rank's block of the float32 resize of ``data`` (its block of
    the region's tensor, in float32) to the global ``target``, axis by
    axis as the whole tensor's: along a J split the output columns read
    their input columns (the nearest one, or the two a lerp weighs) from
    the ranks that hold them."""
    if region.parts(3) == 1:
        return _resize_nearest(data, target) if mode == "nearest" else upsample_volume(data, target)
    ti, tj, tk = (int(n) for n in target)
    sj = int(region.shape[3])
    if mode == "nearest":
        (out,) = region.fetch_index_columns(_nearest_axis(data, ti, 2), tj,
                                            [_nearest_index(sj, tj)])
        return _nearest_axis(out, tk, 4)
    out = _lerp_axis(data, ti, 2)
    g = _axis_coords(sj, tj, "cpu")
    i0 = torch.floor(g).long().clamp(0, sj - 1)
    i1 = (i0 + 1).clamp(0, sj - 1)
    start, stop = region.columns(tj)
    lo, hi = region.fetch_index_columns(out, tj, [i0.numpy(), i1.numpy()])
    f = (g - i0.to(torch.float32))[start:stop].to(out.device).reshape(1, 1, 1, -1, 1)
    return _lerp_axis(lo * (1.0 - f) + hi * f, tk, 4)


class Resize(SpatialTransform):
    r"""Resample to a fixed spatial shape (anisotropic scaling warning:
    prefer Resample + CropOrPad for medical data)."""

    takes_sharded = True

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
            region = region_of(img_batch.data)
            data = region.local
            old_shape = region.shape[2:]
            resized = resize_region(region, data.to(torch.float32), target, mode)
            img_batch.data = region.wrap(cast_like_jax(resized, data.dtype),
                                         (*region.shape[:2], *target))
            for affine in img_batch.affines:
                for axis in range(3):
                    affine._matrix[:3, axis] *= old_shape[axis] / target[axis]
        return batch
