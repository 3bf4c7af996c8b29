"""Gamma intensity transform.

Counterpart of ``torchio_tpu/transforms/intensity/gamma.py``:
:math:`\\mathrm{sign}(I) \\cdot |I|^{e^\\beta}`, per-instance
log-gamma, invertible via :math:`-\\beta` (``_GammaInverse``).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ...data.batch import SubjectsBatch
from .._utils import broadcast_param
from ..parameter_range import to_range
from ..transform import IntensityTransform


def gamma_pow(data: torch.Tensor, log_gamma) -> torch.Tensor:
    """``sign(v) |v|^exp(log_gamma)``: a per-element list exponentiates on
    the device, a scalar on the host."""
    if isinstance(log_gamma, list):
        gamma = torch.exp(broadcast_param(log_gamma, data))
    else:
        gamma = math.exp(log_gamma)
    return torch.sign(data) * torch.abs(data) ** gamma


class Gamma(IntensityTransform):
    r"""Apply :math:`v \mapsto \mathrm{sign}(v)\,|v|^{\gamma}` with
    :math:`\gamma = e^{\beta}` and :math:`\beta` sampled from ``log_gamma``."""

    def __init__(self, *, log_gamma: Any = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.log_gamma = to_range(log_gamma)
        self.warn_if_noop(
            is_noop=self.log_gamma.is_constant(0.0),
            hint="log_gamma=(-0.3, 0.3)",
        )

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        n = self._resolve_n(batch)
        keep = self._keep_mask(batch, n)
        log_gamma = self._mask_identity(self.log_gamma.sample_1d(n), keep, identity=0.0)
        params = {"log_gamma": self._serialize_param(log_gamma)}
        self._tag_batched(params, batch, n, keep, ["log_gamma"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            img_batch.data = gamma_pow(img_batch.data, params["log_gamma"])
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        return bool(self._get_images(batch))

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, gamma_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        params = self.make_params(batch)
        return FusedStage(
            names=names,
            apply=gamma_apply(names),
            args=params["log_gamma"],
            params=params,
        )

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_GammaInverse":
        return _GammaInverse(log_gamma=params["log_gamma"], copy=False)


class _GammaInverse(IntensityTransform):
    """Applies gamma with the negated log-exponent."""

    def __init__(self, *, log_gamma, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._log_gamma = log_gamma

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        neg = (
            [-v for v in self._log_gamma]
            if isinstance(self._log_gamma, list)
            else -self._log_gamma
        )
        for img_batch in self._get_images(batch).values():
            img_batch.data = gamma_pow(img_batch.data, neg)
        return batch
