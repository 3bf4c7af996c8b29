"""Mask: set voxels outside a mask to a constant.

Counterpart of ``torchio_tpu/transforms/intensity/mask.py``: the mask is
a LabelMap key (optionally restricted to ``labels``) or a callable on the
first element's (C, I, J, K) tensor, taken from the first batch element
and applied batch-wide. The result dtype follows the JAX package's
``jnp.where`` with a Python ``outside_value`` (weak types), as
``torch.where`` promotes: a float value makes an integer image float32.

On a sharded batch (a LabelMap-key mask) the ranks that hold element 0
share its mask's J columns over the mesh axis that splits B (one
``broadcast`` of one element's columns), and every rank masks its
region.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import region_of
from ..transform import IntensityTransform
from .normalize import MaskedStatistic, mask_gathers


def label_mask(mask_data: torch.Tensor, labels) -> torch.Tensor:
    """Voxels of ``mask_data`` whose value is one of ``labels`` (any
    non-zero value when ``labels`` is None)."""
    if labels is None:
        return mask_data.to(torch.bool)
    mask = torch.zeros(mask_data.shape, dtype=torch.bool, device=mask_data.device)
    for label in labels:
        mask = mask | (mask_data == label)
    return mask


def first_mask(mask_data, labels) -> torch.Tensor:
    """:func:`label_mask` of element 0 of the (B, C, I, J, K) ``mask_data``:
    a DTensor's J columns of it on every rank (its holders share it over
    the mesh axis that splits B), a whole tensor's all of it."""
    region = region_of(mask_data)
    if region.whole:
        return label_mask(region.local[0], labels)
    local = region.local
    mask = torch.empty(tuple(local.shape[1:]), dtype=torch.uint8, device=local.device)
    if region.holds_first:
        mask = label_mask(local[0], labels).to(torch.uint8)
    return region.share_first(mask).to(torch.bool)


def masked(data, mask: torch.Tensor, outside_value: float):
    """``where(mask, data, outside_value)`` on each rank's region of a
    DTensor (``mask`` its columns of element 0's mask), or whole."""
    region = region_of(data)
    return region.wrap(torch.where(mask.to(region.local.device), region.local, outside_value))


class Mask(MaskedStatistic, IntensityTransform):
    """Zero (or set to ``outside_value``) voxels outside a mask.

    ``masking_method`` is a LabelMap key or a callable on the first
    sample's tensor; ``labels`` optionally restricts which label values
    count as inside.
    """

    def __init__(
        self,
        *,
        masking_method: str | Callable = "brain",
        outside_value: float = 0.0,
        labels: list[int] | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.masking_method = masking_method
        self.outside_value = outside_value
        self.labels = labels

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        mask = self._resolve_mask(batch)
        for _name, img_batch in self._get_images(batch).items():
            img_batch.data = masked(img_batch.data, mask, self.outside_value)
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        # LabelMap-key masks fuse (the mask rides the data dict)
        return (
            bool(self._get_images(batch))
            and isinstance(self.masking_method, str)
            and self.masking_method in batch.images
            and issubclass(batch.images[self.masking_method].image_class, LabelMap)
        )

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, mask_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        mask_name = self.masking_method
        labels = None if self.labels is None else tuple(self.labels)
        return FusedStage(
            names=(*names, mask_name),
            apply=mask_apply(names, mask_name, labels, self.outside_value),
            args=None,
            params={},
            takes_sharded=True,
        )

    def _resolve_mask(self, batch: SubjectsBatch) -> torch.Tensor:
        if mask_gathers(self.masking_method):
            first = next(iter(self._get_images(batch).values()))
            return torch.as_tensor(
                self.masking_method(first.data[0]), device=first.device
            ).to(torch.bool)
        if isinstance(self.masking_method, str):
            key = self.masking_method
            if key not in batch.images:
                raise KeyError(
                    f'Masking method "{key}" not found in batch images.'
                    f" Available: {list(batch.images)}"
                )
            mask_batch = batch.images[key]
            if not issubclass(mask_batch.image_class, LabelMap):
                raise TypeError(f'Masking method "{key}" must refer to a LabelMap.')
            return first_mask(mask_batch.data, self.labels)
        raise TypeError(
            f"masking_method must be a str or callable, got {type(self.masking_method)}"
        )
