"""KeepLargestComponent: per-label connected-component filtering.

Counterpart of ``torchio_tpu/transforms/label/keep_largest.py``.
Connected components are labelled on the host by
``scipy.ndimage.label``, as in the JAX package: the batch's label maps
go to the host in one copy and the filtered maps come back to the device
they came from, with their dtype, in one copy.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from scipy import ndimage

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ..transform import Transform


def _keep_largest(volume: np.ndarray, labels, background_label: int, fully: bool):
    result = volume.copy()
    if labels is None:
        labels = [int(v) for v in np.unique(volume) if int(v) != background_label]
    structure = np.ones((3, 3, 3)) if fully else None  # None -> 6-connectivity
    for label in labels:
        binary = volume == label
        if not binary.any():
            continue
        components, num = ndimage.label(binary, structure=structure)
        if num <= 1:
            continue
        sizes = np.bincount(components.ravel())
        sizes[0] = 0
        largest = int(np.argmax(sizes))
        remove = binary & (components != largest)
        result[remove] = background_label
    return result


class KeepLargestComponent(Transform):
    """Keep only the largest connected component of each label value."""

    def __init__(
        self,
        labels: Sequence[int] | None = None,
        *,
        background_label: int = 0,
        fully_connected: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.labels = list(labels) if labels is not None else None
        self.background_label = background_label
        self.fully_connected = fully_connected

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            data = img_batch.data
            b, c = data.shape[:2]
            if c != 1:
                raise RuntimeError(
                    f"KeepLargestComponent requires single-channel label maps,"
                    f" got {c} channels"
                )
            arr = data.detach().cpu().numpy().copy()
            for i in range(b):
                arr[i, 0] = _keep_largest(
                    arr[i, 0],
                    self.labels,
                    self.background_label,
                    self.fully_connected,
                )
            img_batch.data = torch.from_numpy(arr).to(data.device)
        return batch
