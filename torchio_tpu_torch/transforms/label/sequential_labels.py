"""SequentialLabels: compact labels to 0..N (invertible).

Counterpart of ``torchio_tpu/transforms/label/sequential_labels.py``: the
remapping comes from the first element's labels and applies to every
element; labels it does not mention collapse to 0.
"""

from __future__ import annotations

from typing import Any

import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from .._utils import unique_labels
from ..transform import Transform
from .remap_labels import _remap


class SequentialLabels(Transform):
    r"""Renumber labels to consecutive integers starting from 0."""

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        remappings: dict[str, dict[int, int]] = {}
        for name, img_batch in batch.images.items():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            unique = unique_labels(img_batch.data[0])
            remappings[name] = {old: new for new, old in enumerate(unique)}
        return {"remappings": remappings}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in batch.images.items():
            if name not in params["remappings"]:
                continue
            remapping = {
                int(k): int(v) for k, v in params["remappings"][name].items()
            }
            data = img_batch.data
            img_batch.data = _remap(data, remapping, out=torch.zeros_like(data))
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_SequentialLabelsInverse":
        return _SequentialLabelsInverse(remappings=params["remappings"], copy=False)


class _SequentialLabelsInverse(Transform):
    def __init__(self, *, remappings: dict[str, dict], **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._remappings = remappings

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in batch.images.items():
            if name not in self._remappings:
                continue
            inverse_map = {
                int(v): int(k) for k, v in self._remappings[name].items()
            }
            img_batch.data = _remap(img_batch.data, inverse_map)
        return batch
