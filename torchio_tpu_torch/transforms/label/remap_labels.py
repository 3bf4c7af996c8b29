"""RemapLabels (invertible when bijective) and RemoveLabels.

Counterpart of ``torchio_tpu/transforms/label/remap_labels.py``. The
JAX package compares with ``float(old)`` and writes ``float(new)``, then
casts back to the data's dtype (its weak-type promotion); here
an integer map is compared and written in float32, a float map in its
own dtype, as JAX promotes them. A sharded batch is remapped on each
rank's region, with no collective.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import map_region
from ..transform import Transform

def _remap(data: torch.Tensor, remapping: dict, out: torch.Tensor | None = None):
    """Labels ``old`` of ``data`` become ``new`` in ``out`` (``data``
    where None), computed in the dtype JAX promotes to, cast back to
    ``data``'s dtype."""
    # JAX promotes an integer array and a Python float to float32
    work = data if data.is_floating_point() else data.to(torch.float32)
    result = work if out is None else out.to(work.dtype)
    for old, new in remapping.items():
        result = torch.where(work == float(old), float(new), result)
    return result.to(data.dtype)


def remap(data: torch.Tensor, remapping: dict, zero_others: bool = False):
    """:func:`_remap` of ``data`` (a DTensor on each rank's region); labels
    the map does not name become 0 with ``zero_others``."""

    def local(block):
        return _remap(block, remapping, out=torch.zeros_like(block) if zero_others else None)

    return map_region(local, data)


class RemapLabels(Transform):
    r"""Replace label values per a ``{old: new}`` dict (others unchanged)."""

    takes_sharded = True

    def __init__(self, remapping: dict[int, int], **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.remapping = dict(remapping)

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {"remapping": {int(k): int(v) for k, v in self.remapping.items()}}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        remapping = {int(k): int(v) for k, v in params["remapping"].items()}
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            img_batch.data = remap(img_batch.data, remapping)
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "RemapLabels":
        remapping = {int(k): int(v) for k, v in params["remapping"].items()}
        return RemapLabels({v: k for k, v in remapping.items()}, copy=False)


class RemoveLabels(Transform):
    """Set the given labels to ``background_label``."""

    takes_sharded = True

    def __init__(
        self,
        labels: Sequence[int],
        *,
        background_label: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.labels = list(labels)
        self.background_label = background_label

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        remapping = {int(lbl): int(self.background_label) for lbl in self.labels}
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            img_batch.data = remap(img_batch.data, remapping)
        return batch
