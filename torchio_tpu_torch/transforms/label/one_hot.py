"""OneHot: label map -> one-hot channels (invertible via argmax).

Counterpart of ``torchio_tpu/transforms/label/one_hot.py``. The
encoding is ``labels == arange(n)`` in float32, which gives a row of
zeros to a label outside ``[0, n)`` as ``jax.nn.one_hot`` does
(``F.one_hot`` raises on one). A sharded batch is encoded on each rank's
region; with ``num_classes=-1`` the largest label is each rank's, then
one ``all_reduce(MAX)`` over each mesh axis that splits the batch. The
inverse takes the argmax over C of each rank's block.
"""

from __future__ import annotations

from typing import Any

import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import region_of
from ..transform import Transform


def one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 1, I, J, K) int32 labels -> (B, n, I, J, K) float32."""
    classes = torch.arange(n, dtype=labels.dtype, device=labels.device)
    return (labels == classes.reshape(1, -1, 1, 1, 1)).to(torch.float32)


class OneHot(Transform):
    r"""One-hot encode each LabelMap: (1, I, J, K) -> (K, I, J, K)."""

    takes_sharded = True

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
            region = region_of(img_batch.data)
            data = region.local.to(torch.int32)
            n = num_classes
            if n == -1:
                top = data.amax() if data.numel() else torch.tensor(
                    torch.iinfo(torch.int32).min, device=data.device)
                n = int(region.reduce_max(top.reshape(1))[0]) + 1  # scalar pull only
            b, _, si, sj, sk = region.shape
            img_batch.data = region.wrap(one_hot(data[:, 0:1], n), (b, n, si, sj, sk))
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_OneHotInverse":
        return _OneHotInverse(copy=False)


class _OneHotInverse(Transform):
    """argmax back to single-channel labels (a sharded batch: over C of
    each rank's block, which holds every channel)."""

    takes_sharded = True

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in batch.images.values():
            if not issubclass(img_batch.image_class, LabelMap):
                continue
            region = region_of(img_batch.data)
            b, c, si, sj, sk = region.shape
            if c > 1:
                region.check_rows()
                labels = torch.argmax(region.local, dim=1, keepdim=True).to(torch.float32)
                img_batch.data = region.wrap(labels, (b, 1, si, sj, sk))
        return batch
