"""To: device and dtype placement as a pipeline step.

Counterpart of ``torchio_tpu/transforms/to.py``. A lone dtype-like
positional argument is the dtype: a ``torch.dtype`` as well as the numpy
dtypes and names the JAX package accepts (``np.dtype`` refuses a
``torch.dtype``, so the JAX package's test alone would read
``To(torch.float16)`` as a device).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..data.batch import SubjectsBatch
from .transform import Transform


def _looks_like_dtype(value: Any) -> bool:
    if isinstance(value, torch.dtype):
        return True
    if value is None or isinstance(value, str) and not hasattr(np, value):
        return False
    try:
        np.dtype(value)
        return True
    except TypeError:
        return False


def _torch_dtype(value: Any) -> torch.dtype | None:
    """A ``torch.dtype`` for a dtype-like value (None stays None)."""
    if value is None or isinstance(value, torch.dtype):
        return value
    return getattr(torch, np.dtype(value).name)


class To(Transform):
    """Move batch data to a device and/or cast dtype.

    Accepts the reference's positional convention (``To("cpu")``,
    ``To(torch.float32)``, ``To(np.float16)``, ``To(device, dtype)``): a
    lone dtype-like positional argument is treated as the dtype.
    """

    def __init__(self, device: Any = None, dtype: Any = None, **kwargs: Any) -> None:
        kwargs.setdefault("copy", False)
        super().__init__(**kwargs)
        if dtype is None and _looks_like_dtype(device):
            device, dtype = None, device
        self.device = device
        self.dtype = dtype

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        return batch.to(self.device, _torch_dtype(self.dtype))
