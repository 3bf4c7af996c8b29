"""Gaussian / Rician noise.

Counterpart of ``torchio_tpu/transforms/intensity/noise.py``: the seed
is recorded in the params, per-element mean/std broadcast, Rician
magnitude noise, gated-out rows restored bit-exactly (the Rician map is
not the identity at zero noise).

The noise field is drawn on the batch's device through
:func:`torchio_tpu_torch.random.device_normal` from the recorded seed;
image ``n`` of the batch takes draw ``2 n + 1`` (and ``2 n + 2`` for the
second Rician field), in the order the JAX package splits its key.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...data.batch import SubjectsBatch
from .._utils import broadcast_param, restore_gated
from ..parameter_range import to_nonneg_range, to_range
from ..transform import IntensityTransform


def noise_field(seed: int, index: int, data: torch.Tensor, mean, std) -> torch.Tensor:
    """``mean + std * N(0, 1)`` shaped like ``data``, on its device."""
    normal = tio_random.device_normal(seed, tuple(data.shape), data.device, index)
    return mean + std * normal


class Noise(IntensityTransform):
    r"""Add Gaussian noise, or Rician noise
    :math:`\sqrt{(I + n_1)^2 + n_2^2}` with :math:`n_i \sim N(\mu, \sigma^2)`.

    Args:
        mean: scalar, ``(lo, hi)`` range, or distribution for :math:`\mu`.
        std: scalar, range, or distribution for :math:`\sigma` (>= 0).
        rician: use Rician magnitude noise (MRI-typical).
    """

    def __init__(
        self,
        *,
        mean: Any = 0.0,
        std: Any = 0.25,
        rician: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.mean = to_range(mean)
        self.std = to_nonneg_range(std)
        self.rician = rician

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        seed = tio_random.draw_seed()
        n = self._resolve_n(batch)
        keep = self._keep_mask(batch, n)
        mean = self._mask_identity(self.mean.sample_1d(n), keep, identity=0.0)
        std = self._mask_identity(self.std.sample_1d(n), keep, identity=0.0)
        params = {
            "mean": self._serialize_param(mean),
            "std": self._serialize_param(std),
            "seed": seed,
            "rician": self.rician,
        }
        self._tag_batched(params, batch, n, keep, ["mean", "std"])
        return params

    def fusable(self, batch: SubjectsBatch) -> bool:
        return bool(self._get_images(batch))

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, noise_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        params = self.make_params(batch)
        keep = params.get("_keep")
        gated = keep is not None and not all(keep)
        device = batch.device

        def f32(value):
            return torch.as_tensor(np.asarray(value, np.float32), device=device)

        args = (
            f32(params["mean"]),
            f32(params["std"]),
            f32(keep if gated else 0.0),
            params["seed"],
        )
        return FusedStage(
            names=names,
            apply=noise_apply(names, self.rician, gated),
            args=args,
            params=params,
        )

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        keep = params.get("_keep")
        rician = params.get("rician", False)
        for n, img_batch in enumerate(self._get_images(batch).values()):
            data = img_batch.data
            mean = broadcast_param(params["mean"], data)
            std = broadcast_param(params["std"], data)
            noise = noise_field(params["seed"], 2 * n + 1, data, mean, std)
            if rician:
                noise2 = noise_field(params["seed"], 2 * n + 2, data, mean, std)
                out = torch.sqrt((data + noise) ** 2 + noise2**2)
            else:
                out = data + noise
            img_batch.data = restore_gated(out, data, keep)
        return batch
