"""BiasField: smooth multiplicative intensity inhomogeneity.

Counterpart of ``torchio_tpu/transforms/intensity/bias_field.py``: a
coarse N(0, std) field at ``scale`` x resolution, trilinearly upsampled,
``exp``, multiplied in. The seed is recorded in the params, one per
element when batched, so the exact field regenerates.

Fields are drawn on the batch's device under ``PRNGKey(seed)`` (draw
index 0 of the recorded seed, the JAX package's own field): one draw for
a shared seed (:func:`torchio_tpu_torch.random.device_normal`), and all
of a batch's per-element fields, each times its element's std, in one
:func:`torchio_tpu_torch.random.normals` (one launch of the threefry
kernel on a card). The upsample, ``exp`` and multiply are plain torch
ops, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...data.batch import SubjectsBatch
from ...ops.resample import upsample_volume
from .._utils import restore_gated
from ..parameter_range import to_nonneg_range
from ..transform import IntensityTransform


def _coarse_shape(spatial, scale: float) -> tuple[int, int, int]:
    return tuple(max(round(s * scale), 4) for s in spatial)


def _apply_field(data: torch.Tensor, coarse: torch.Tensor, divide: bool) -> torch.Tensor:
    field = torch.exp(upsample_volume(coarse, tuple(data.shape[2:])))
    out = data / field if divide else data * field
    return out.to(data.dtype)


def bias_per_element(data, stds: np.ndarray, seeds, scale: float, divide: bool):
    """One field per element: element ``b``'s coarse field is drawn from
    its own seed with the (1, C, *small) shape the JAX package uses, times
    ``stds[b]`` (float32, on the host), all B fields in one draw."""
    b, c = data.shape[:2]
    small = _coarse_shape(data.shape[2:], scale)
    keys = [tio_random.draw_key(int(sd), 0) for sd in seeds]
    coarse = tio_random.normals(keys, [(1, c, *small)] * b, stds, data.device)
    return _apply_field(data, coarse.reshape(b, c, *small), divide)


def bias_shared(data, std: torch.Tensor, seed: int, scale: float, divide: bool):
    """One (B, C, *small) coarse draw from one seed."""
    b, c = data.shape[:2]
    small = _coarse_shape(data.shape[2:], scale)
    coarse = tio_random.device_normal(int(seed), (b, c, *small), data.device, 0)
    return _apply_field(data, coarse * std.reshape(-1, 1, 1, 1, 1), divide)


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def _apply_bias(data, std, seed, scale: float, *, divide: bool):
    if isinstance(seed, list):  # per-element seeds
        identity = [s == 0 for s in std]
        if all(identity):
            return data
        out = bias_per_element(data, np.asarray(std, np.float32), seed, scale, divide)
        return restore_gated(out, data, [not i for i in identity])
    if std == 0:
        return data
    return bias_shared(data, _f32(std, data.device), seed, scale, divide)


class BiasField(IntensityTransform):
    r"""Multiply by :math:`\exp(\text{upsampled } N(0, \sigma))`.

    Args:
        std: coarse-field standard deviation (scalar / range / dist).
        scale: coarse-to-full resolution ratio in (0, 1].
    """

    def __init__(self, *, std: Any = 0.5, scale: float = 0.025, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.std = to_nonneg_range(std)
        if scale <= 0 or scale > 1:
            raise ValueError(f"scale must be in (0, 1], got {scale}")
        self.scale = scale

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        n = self._resolve_n(batch)
        if n is None:
            return {
                "std": self.std.sample_1d(),
                "seed": tio_random.draw_seed(),
                "scale": self.scale,
            }
        keep = self._keep_mask(batch, n)
        std = self._mask_identity(self.std.sample_1d(n), keep, identity=0.0)
        seeds = [tio_random.draw_seed() for _ in range(n)]
        params = {
            "std": self._serialize_param(std),
            "seed": seeds,
            "scale": self.scale,
        }
        self._tag_batched(params, batch, n, keep, ["std", "seed"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            img_batch.data = _apply_bias(
                img_batch.data,
                params["std"],
                params["seed"],
                params["scale"],
                divide=False,
            )
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        return bool(self._get_images(batch))

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, bias_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        params = self.make_params(batch)
        device = batch.device
        per_element = isinstance(params["seed"], list)
        if per_element:
            identity = [s == 0 for s in params["std"]]
            all_id = all(identity)
            gated = any(identity) and not all_id
            args = (
                np.asarray(params["std"], np.float32),
                params["seed"],
                _f32([not i for i in identity], device),
            )
        else:
            all_id = params["std"] == 0
            gated = False
            args = (_f32(params["std"], device), params["seed"], None)
        return FusedStage(
            names=names,
            apply=bias_apply(names, self.scale, per_element, gated, all_id),
            args=args,
            params=params,
        )

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_BiasFieldInverse":
        return _BiasFieldInverse(
            std=params["std"], seed=params["seed"], scale=params["scale"], copy=False
        )


class _BiasFieldInverse(IntensityTransform):
    """Divides by the regenerated field."""

    def __init__(self, *, std, seed, scale: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._std = std
        self._seed = seed
        self._scale = scale

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for img_batch in self._get_images(batch).values():
            img_batch.data = _apply_bias(
                img_batch.data, self._std, self._seed, self._scale, divide=True
            )
        return batch
