"""Standardize / ZNormalization.

Counterpart of ``torchio_tpu/transforms/intensity/standardize.py``: the
mean and the sample standard deviation (``ddof=1``; ``count - 1`` under
a mask) of each image's first batch element, optionally within a mask
(a LabelMap key or a callable), applied batch-wide in float32, and
invertible. The statistics stay on the batch's device as an eager
:class:`DeferredParam`: its finalizer raises on an empty mask and on a
zero standard deviation when the history is recorded, after the output
was computed.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ..transform import DeferredParam, IntensityTransform
from .normalize import resolve_mask


def _finalize_stats(name: str):
    """Host finalizer: validates the (mean, std, count) triple and
    records (mean, std)."""

    def finalize(host: np.ndarray) -> tuple[float, float]:
        mean, std, count = (float(v) for v in host)
        if count == 0:
            raise RuntimeError(f'Standardization mask for "{name}" is empty.')
        if std == 0:
            raise RuntimeError(
                f'Cannot standardize "{name}": standard deviation is zero.'
            )
        return (mean, std)

    return finalize


def standardize_stats(first: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """The (mean, std, count) float32 triple of ``first`` (one element's
    float32 (C, I, J, K) data) on its device; count is 1 without a mask."""
    if mask is None:
        one = torch.ones((), dtype=torch.float32, device=first.device)
        return torch.stack([first.mean(), first.std(correction=1), one])
    m = torch.broadcast_to(mask.to(first.device), first.shape)
    count = m.sum().to(torch.float32)
    mean = torch.where(m, first, 0.0).sum() / torch.clamp(count, min=1.0)
    ss = torch.where(m, (first - mean) ** 2, 0.0).sum()
    std = torch.sqrt(ss / torch.clamp(count - 1.0, min=1.0))
    return torch.stack([mean, std, count])


def standardized(data: torch.Tensor, stats) -> torch.Tensor:
    """``(data - mean) / std`` in float32, from a recorded (mean, std) pair
    or a device triple."""
    mean, std = stats[0], stats[1]
    return (data.to(torch.float32) - mean) / std


class Standardize(IntensityTransform):
    """Z-score normalization: subtract mean, divide by std.

    Statistics are computed from the first batch element (optionally
    within a mask) and applied batch-wide, as in the JAX package.
    """

    def __init__(
        self,
        *,
        masking_method: str | Callable | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.masking_method = masking_method

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        stats: dict[str, Any] = {}
        for name, img_batch in self._get_images(batch).items():
            mask = resolve_mask(self.masking_method, img_batch, batch)
            triple = standardize_stats(img_batch.data[0].to(torch.float32), mask)
            stats[name] = DeferredParam(triple, _finalize_stats(name), eager=True)
        return {"stats": stats}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in self._get_images(batch).items():
            if name not in params["stats"]:
                continue
            recorded = params["stats"][name]
            if isinstance(recorded, DeferredParam):
                recorded = recorded.device
            img_batch.data = standardized(img_batch.data, recorded)
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        if not self._get_images(batch):
            return False
        if self.masking_method is None:
            return True
        # a LabelMap-key mask rides the fused data dict; a callable runs
        # eagerly
        return (
            isinstance(self.masking_method, str)
            and self.masking_method in batch.images
            and issubclass(batch.images[self.masking_method].image_class, LabelMap)
        )

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, install_standardize_params, standardize_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        mask_name = self.masking_method if isinstance(self.masking_method, str) else None
        return FusedStage(
            names=names if mask_name is None else (*names, mask_name),
            apply=standardize_apply(names, mask_name),
            args=None,
            params={},
            finish=install_standardize_params,
        )

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_StandardizeInverse":
        return _StandardizeInverse(stats=params["stats"], copy=False)


class _StandardizeInverse(IntensityTransform):
    def __init__(self, *, stats: dict[str, tuple[float, float]], **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._stats = stats

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in self._get_images(batch).items():
            if name not in self._stats:
                continue
            mean, std = self._stats[name]
            img_batch.data = img_batch.data * std + mean
        return batch


ZNormalization = Standardize
