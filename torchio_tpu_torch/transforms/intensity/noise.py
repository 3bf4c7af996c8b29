"""Gaussian / Rician noise.

Counterpart of ``torchio_tpu/transforms/intensity/noise.py``: the seed
is recorded in the params, per-element mean/std broadcast, Rician
magnitude noise, gated-out rows restored bit-exactly (the Rician map is
not the identity at zero noise).

The noise field is drawn on the batch's device from the recorded seed:
image ``n`` of the batch takes draw ``2 n + 1`` (and ``2 n + 2`` for the
second Rician field), the keys the JAX package splits for it, so the
field is the JAX package's own (the threefry kernel on a card). A Rician
pair is one :func:`torchio_tpu_torch.random.normals` of both keys: one
launch. On a sharded batch each rank draws only its region of each field
(its rows and J slab: one strided segment a field, in the same one
launch), with no collective.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...data.batch import SubjectsBatch
from ...parallel.mesh import Region, region_of
from .._utils import broadcast_param, restore_gated
from ..parameter_range import to_nonneg_range, to_range
from ..transform import IntensityTransform


def add_noise(seed: int, n: int, data: torch.Tensor, mean, std, rician: bool) -> torch.Tensor:
    """Image ``n`` plus its noise ``mean + std * N(0, 1)`` (draw ``2 n +
    1``), or Rician ``sqrt((data + noise)^2 + noise2^2)`` with ``noise2``
    from draw ``2 n + 2``, both fields in one draw. ``mean`` and ``std``
    are scalars or (B, 1, 1, 1, 1). A DTensor takes only its region's
    elements of each field (:func:`noisy_region`)."""
    region = region_of(data)
    return region.wrap(noisy_region(seed, n, region, region.take(mean), region.take(std), rician))


def noisy_region(seed: int, n: int, region: Region, mean, std, rician: bool) -> torch.Tensor:
    """``region.local`` plus its elements of image ``n``'s noise fields,
    drawn over the region's global shape (``mean`` and ``std`` already
    the region's rows): a region that is the whole tensor draws the whole
    fields; a part of it (a rank's rows and J slab) draws one strided
    segment a field (:func:`torchio_tpu_torch.random.region_normals`)."""
    data = region.local
    shape = tuple(data.shape)
    keys = [tio_random.draw_key(seed, 2 * n + 1)]
    if rician:
        keys.append(tio_random.draw_key(seed, 2 * n + 2))
    if not region.whole:
        fields = tio_random.region_normals(keys, region).reshape(len(keys), *shape)
    elif rician:
        fields = tio_random.normals(keys, [shape, shape], None, data.device).reshape(2, *shape)
    else:
        fields = tio_random.device_normal(seed, shape, data.device, 2 * n + 1)[None]
    if rician:
        noise, noise2 = mean + std * fields[0], mean + std * fields[1]
        return torch.sqrt((data + noise) ** 2 + noise2**2)
    return data + (mean + std * fields[0])


class Noise(IntensityTransform):
    r"""Add Gaussian noise, or Rician noise
    :math:`\sqrt{(I + n_1)^2 + n_2^2}` with :math:`n_i \sim N(\mu, \sigma^2)`.

    A sharded batch stays on each rank's region, fused or not.

    Args:
        mean: scalar, ``(lo, hi)`` range, or distribution for :math:`\mu`.
        std: scalar, range, or distribution for :math:`\sigma` (>= 0).
        rician: use Rician magnitude noise (MRI-typical).
    """

    takes_sharded = True

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
            keep if gated else None,
            params["seed"],
        )
        return FusedStage(
            names=names,
            apply=noise_apply(names, self.rician),
            args=args,
            params=params,
            takes_sharded=True,
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
            out = add_noise(params["seed"], n, data, mean, std, rician)
            img_batch.data = restore_gated(out, data, keep)
        return batch
