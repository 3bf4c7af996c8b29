"""CropOrPad and EnsureShapeMultiple: reach a target shape by symmetric
crop and/or pad.

Counterpart of ``torchio_tpu/transforms/spatial/crop_or_pad.py``: the
target in voxels, mm or cm (through the spacing), ``None`` keeping an
axis; a center or random crop location; ``only_crop``/``only_pad``; the
batch path composes Pad and Crop. A Subject or an Image takes the
subject path: one draw for ``p``, the same crop and pad of every
selected image, the ``Pad`` and ``Crop`` history records, and each
image's points and bounding boxes carried unmoved. There an image not
loaded yet (read from a file) gets deferred views instead
(:class:`..io.backends.PaddedBackend` for a constant pad,
:class:`..io.backends.CroppedBackend`), so no voxel is read until the
data is used, and then only the region the views select; a loaded image
(or a pad mode that needs the data) is cropped and padded eagerly, with
the same result.
"""

from __future__ import annotations

import copy as _copy
import math
from typing import Any

from ... import random as tio_random
from ...data.batch import SubjectsBatch
from ...data.image import Image
from ...data.subject import Subject
from ...io.backends import CroppedBackend, PaddedBackend, normalize_index
from ..compose import Compose
from ..transform import AppliedTransform, SpatialTransform
from ._padding import pad_tensor, parse_padding_mode
from .crop import Crop, crop_tensor
from .pad import Pad, shift_origin


def _parse_target_shape(target_shape):
    if isinstance(target_shape, (int, float)):
        return (float(target_shape),) * 3
    values = list(target_shape)
    if len(values) != 3:
        raise ValueError(f"target_shape must have 1 or 3 values, got {len(values)}")
    return tuple(None if v is None else float(v) for v in values)


def _to_voxels(target, units: str, spacing, current_shape):
    out = []
    for t, sp, cur in zip(target, spacing, current_shape):
        if t is None:
            out.append(cur)
        elif units == "voxels":
            out.append(round(t))
        else:
            factor = 10.0 if units == "cm" else 1.0
            out.append(round(t * factor / sp))
    return tuple(out)


def _split_per_axis(diff: int, location: str):
    if diff > 0:
        return (math.ceil(diff / 2), math.floor(diff / 2)), (0, 0)
    if diff < 0:
        amount = -diff
        if location == "random":
            ini = int(tio_random.randint(0, amount + 1))
        else:
            ini = math.ceil(amount / 2)
        return (0, 0), (ini, amount - ini)
    return (0, 0), (0, 0)


def _compute_crop_and_pad(
    current_shape, target_shape, *, only_crop: bool, only_pad: bool,
    location: str = "center",
):
    pads, crops = [], []
    for cur, tgt in zip(current_shape, target_shape):
        pad, crop = _split_per_axis(tgt - cur, location)
        pads.extend(pad)
        crops.extend(crop)
    padding = tuple(pads) if any(v > 0 for v in pads) and not only_crop else None
    cropping = tuple(crops) if any(v > 0 for v in crops) and not only_pad else None
    return padding, cropping


def _replaced_image(image: Image, data, corner) -> Image:
    """A new image of the same class holding ``data`` (a tensor, or a
    lazy backend view), its origin moved by ``corner`` voxels; metadata
    and annotations copied (the points and boxes unmoved, as the JAX
    package's lazy views carry them), history kept."""
    affine = image.affine.clone()
    shift_origin(affine, corner)
    new = type(image)(
        data,
        affine=affine,
        points={k: _copy.deepcopy(v) for k, v in image.points.items()},
        bounding_boxes={k: _copy.deepcopy(v) for k, v in image.bounding_boxes.items()},
        **_copy.deepcopy(image.metadata),
    )
    new.applied_transforms = list(image.applied_transforms)
    return new


class CropOrPad(SpatialTransform):
    r"""Crop and/or pad every image to a target spatial shape.

    As in the JAX package, only the (invertible) Pad and Crop records are
    appended to the history, no CropOrPad record, so
    ``apply_inverse_transform`` undoes it without warnings.
    """

    _records_history = False

    def __init__(
        self,
        target_shape,
        *,
        units: str = "voxels",
        padding_mode: str = "constant",
        fill: float = 0,
        only_crop: bool = False,
        only_pad: bool = False,
        location: str = "center",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if only_crop and only_pad:
            raise ValueError("only_crop and only_pad cannot both be True")
        if units not in ("voxels", "mm", "cm"):
            raise ValueError(f"units must be 'voxels', 'mm', or 'cm', got {units!r}")
        if location not in ("center", "random"):
            raise ValueError(f"location must be 'center' or 'random', got {location!r}")
        self.target_shape = _parse_target_shape(target_shape)
        self.units = units
        self.padding_mode = parse_padding_mode(padding_mode)
        self.fill = fill
        self.only_crop = only_crop
        self.only_pad = only_pad
        self.location = location

    # --- Subject / Image path ---

    def forward(self, data: Any) -> Any:
        if isinstance(data, (Subject, Image)):
            return self._forward_subject(data)
        return super().forward(data)

    def _forward_subject(self, data):
        is_image = isinstance(data, Image)
        subject = Subject(tio_default_image=data) if is_image else data
        if self.copy:
            subject = _copy.deepcopy(subject)
        if float(tio_random.random()) > self.p:
            return subject.tio_default_image if is_image else subject
        first = next(iter(subject.images.values()))
        current_shape = first.spatial_shape
        target_voxels = _to_voxels(
            self.target_shape, self.units, first.affine.spacing, current_shape
        )
        padding, cropping = _compute_crop_and_pad(
            current_shape,
            target_voxels,
            only_crop=self.only_crop,
            only_pad=self.only_pad,
            location=self.location,
        )
        self._apply_to_subject(subject, padding, cropping)
        return subject.tio_default_image if is_image else subject

    def _select_images(self, subject: Subject) -> dict[str, Image]:
        images = dict(subject.images)
        if self.include is not None:
            images = {k: v for k, v in images.items() if k in self.include}
        if self.exclude is not None:
            images = {k: v for k, v in images.items() if k not in self.exclude}
        return images

    def _apply_to_subject(self, subject: Subject, padding, cropping) -> None:
        include = None if self.include is None else list(self.include)
        exclude = None if self.exclude is None else list(self.exclude)
        if padding is not None:
            i0, i1, j0, j1, k0, k1 = padding
            for name, image in self._select_images(subject).items():
                if image.is_loaded or self.padding_mode != "constant":
                    padded = pad_tensor(image.data, padding, self.padding_mode, self.fill)
                else:
                    padded = PaddedBackend(image.dataobj, (i0, j0, k0), (i1, j1, k1), self.fill)
                subject._images[name] = _replaced_image(
                    image, padded, (-float(i0), -float(j0), -float(k0))
                )
            subject.applied_transforms.append(
                AppliedTransform(
                    name="Pad",
                    params={
                        "padding": list(padding),
                        "padding_mode": self.padding_mode,
                        "fill": self.fill,
                    },
                    include=include,
                    exclude=exclude,
                )
            )
        if cropping is not None:
            i0, i1, j0, j1, k0, k1 = cropping
            for name, image in self._select_images(subject).items():
                if image.is_loaded:
                    cropped = crop_tensor(image.data, cropping)
                else:
                    _, si, sj, sk = image.shape
                    window = (slice(None), slice(i0, si - i1), slice(j0, sj - j1), slice(k0, sk - k1))
                    cropped = CroppedBackend(image.dataobj, normalize_index(window, image.shape))
                subject._images[name] = _replaced_image(
                    image, cropped, (float(i0), float(j0), float(k0))
                )
            subject.applied_transforms.append(
                AppliedTransform(
                    name="Crop",
                    params={"cropping": list(cropping)},
                    include=include,
                    exclude=exclude,
                )
            )

    # --- batch path ---

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        first = next(iter(batch.images.values()))
        spacing = first.affines[0].spacing
        current_shape = tuple(first.data.shape[-3:])
        target_voxels = _to_voxels(
            self.target_shape, self.units, spacing, current_shape
        )
        padding, cropping = _compute_crop_and_pad(
            current_shape,
            target_voxels,
            only_crop=self.only_crop,
            only_pad=self.only_pad,
            location=self.location,
        )
        return {
            "padding": None if padding is None else list(padding),
            "cropping": None if cropping is None else list(cropping),
        }

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        transforms: list[SpatialTransform] = []
        if params["padding"] is not None:
            transforms.append(
                Pad(
                    padding=tuple(params["padding"]),
                    padding_mode=self.padding_mode,
                    fill=self.fill,
                    include=self.include,
                    exclude=self.exclude,
                )
            )
        if params["cropping"] is not None:
            transforms.append(
                Crop(
                    cropping=tuple(params["cropping"]),
                    include=self.include,
                    exclude=self.exclude,
                )
            )
        if transforms:
            batch = Compose(transforms, copy=False)(batch)
        return batch


class EnsureShapeMultiple(SpatialTransform):
    r"""Pad (or crop) so every spatial dim is a multiple of ``n``
    (delegates to :class:`CropOrPad`)."""

    _records_history = False

    def __init__(
        self,
        target_multiple,
        *,
        method: str = "pad",
        padding_mode: str = "constant",
        fill: float = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(target_multiple, int):
            if target_multiple < 1:
                raise ValueError(f"target_multiple must be >= 1, got {target_multiple}")
            target_multiple = (target_multiple,) * 3
        values = tuple(int(v) for v in target_multiple)
        if len(values) != 3 or any(v < 1 for v in values):
            raise ValueError(f"target_multiple must be 1 or 3 positive ints: {values}")
        self.target_multiple = values
        if method not in ("crop", "pad"):
            raise ValueError(f"method must be 'crop' or 'pad', got {method!r}")
        self.method = method
        self.padding_mode = parse_padding_mode(padding_mode)
        self.fill = fill

    def _target_shape(self, current_shape):
        out = []
        for size, multiple in zip(current_shape, self.target_multiple):
            if self.method == "pad":
                target = math.ceil(size / multiple) * multiple
            else:
                target = math.floor(size / multiple) * multiple
            out.append(max(target, 1))
        return tuple(out)

    def _build_crop_or_pad(self, current_shape) -> CropOrPad:
        return CropOrPad(
            target_shape=self._target_shape(current_shape),
            padding_mode=self.padding_mode,
            fill=self.fill,
            only_crop=self.method == "crop",
            only_pad=self.method == "pad",
            p=self.p,
            copy=self.copy,
            include=self.include,
            exclude=self.exclude,
        )

    def forward(self, data: Any) -> Any:
        if isinstance(data, (Subject, Image)):
            return self._build_crop_or_pad(data.spatial_shape).forward(data)
        return super().forward(data)

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        first = next(iter(batch.images.values()))
        current_shape = tuple(first.data.shape[-3:])
        inner = self._build_crop_or_pad(current_shape)
        inner.copy = False
        return inner.make_params(batch)

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        first = next(iter(batch.images.values()))
        current_shape = tuple(first.data.shape[-3:])
        inner = self._build_crop_or_pad(current_shape)
        inner.copy = False
        return inner.apply_transform(batch, params)
