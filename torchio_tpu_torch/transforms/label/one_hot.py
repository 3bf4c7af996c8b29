"""OneHot: label map -> one-hot channels (invertible via argmax).

Counterpart of ``torchio_tpu/transforms/label/one_hot.py``. The
encoding is ``labels == arange(n)`` in float32, which gives a row of
zeros to a label outside ``[0, n)`` as ``jax.nn.one_hot`` does
(``F.one_hot`` raises on one).
"""

from __future__ import annotations

from typing import Any

import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ..transform import Transform


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 1, I, J, K) int32 labels -> (B, n, I, J, K) float32."""
    classes = torch.arange(n, dtype=labels.dtype, device=labels.device)
    return (labels == classes.reshape(1, -1, 1, 1, 1)).to(torch.float32)


class OneHot(Transform):
    r"""One-hot encode each LabelMap: (1, I, J, K) -> (K, I, J, K)."""

    def __init__(self, *, num_classes: int = -1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {"num_classes": self.num_classes}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        num_classes = params["num_classes"]
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            data = img_batch.data.to(torch.int32)
            n = num_classes
            if n == -1:
                n = int(data.max()) + 1  # scalar pull only
            img_batch.data = one_hot(data[:, 0:1], n)
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_OneHotInverse":
        return _OneHotInverse(copy=False)


class _OneHotInverse(Transform):
    """argmax back to single-channel labels."""

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            data = img_batch.data
            if data.shape[1] > 1:
                img_batch.data = torch.argmax(data, dim=1, keepdim=True).to(torch.float32)
        return batch
