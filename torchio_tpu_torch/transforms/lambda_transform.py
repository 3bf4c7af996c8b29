"""Lambda: apply a user callable per image.

Counterpart of ``torchio_tpu/transforms/lambda_transform.py``: the
callable receives each element's (C, I, J, K) tensor and the results are
re-stacked; ``types_to_apply`` filters by image class.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..config import as_tensor
from ..data.batch import SubjectsBatch
from ..data.image import Image
from .transform import Transform


class Lambda(Transform):
    """Apply ``function`` to each image's (C, I, J, K) tensor.

    Args:
        function: callable mapping a tensor to a tensor of the same shape
            family (the output is re-stacked into the batch).
        types_to_apply: image classes (e.g. ``[ScalarImage]``) to
            restrict application; ``None`` applies to all.
    """

    def __init__(
        self,
        function: Callable,
        types_to_apply: Sequence[type[Image]] | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.function = function
        self.types_to_apply = tuple(types_to_apply) if types_to_apply else None

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            if self.types_to_apply is not None and not issubclass(
                img_batch.image_class, self.types_to_apply
            ):
                continue
            data = img_batch.data
            outs = [as_tensor(self.function(data[i])) for i in range(len(data))]
            for out in outs:
                if out.ndim != 4:
                    raise ValueError(
                        "Lambda function must return a 4D (C, I, J, K) array,"
                        f" got {out.ndim}D"
                    )
            img_batch.data = torch.stack(outs)
        return batch
