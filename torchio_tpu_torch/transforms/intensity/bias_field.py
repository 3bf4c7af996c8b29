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
ops, as the JAX package leaves them to XLA. On a sharded batch each rank
draws its rows' coarse fields whole (they are tiny), upsamples only its J
columns of the global field, and multiplies its region, with no
collective.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...ops.resample import upsample_volume
from ...parallel.mesh import Region, region_of
from .._utils import restore_gated
from ..parameter_range import to_nonneg_range
from ..transform import IntensityTransform


def _coarse_shape(spatial, scale: float) -> tuple[int, int, int]:
    return tuple(max(round(s * scale), 4) for s in spatial)


def _apply_field(region: Region, coarse: torch.Tensor, divide: bool) -> torch.Tensor:
    """``region.local`` times (or over) ``exp`` of the coarse fields of its
    rows upsampled to the global spatial shape, at the region's J columns
    only (the rows of the global upsample, bit for bit)."""
    region.check_rows()
    data = region.local
    spatial = region.shape[2:]
    if region.split(3):
        from ...parallel.halo import _upsample_field_slab

        smooth = _upsample_field_slab(coarse, spatial, region.j0, int(data.shape[3]), first=2)
    else:
        smooth = upsample_volume(coarse, tuple(spatial))
    field = torch.exp(smooth)
    out = data / field if divide else data * field
    return cast_like_jax(out, data.dtype)


def bias_per_element(data, stds: np.ndarray, seeds, scale: float, divide: bool):
    """One field per element: element ``b``'s coarse field is drawn from
    its own seed with the (1, C, *small) shape the JAX package uses, times
    ``stds[b]`` (float32, on the host), all of the region's fields in one
    draw (a DTensor: each rank draws its rows' fields whole, then
    upsamples its J columns)."""
    region = region_of(data)
    return region.wrap(
        biased_region(region, region.take(np.asarray(stds, np.float32)),
                      region.take(list(seeds)), scale, divide)
    )


def biased_region(region: Region, stds: np.ndarray, seeds, scale: float, divide: bool):
    """The local program of :func:`bias_per_element`: ``region.local``
    times (or over) its rows' fields (``stds`` and ``seeds`` already its
    rows'), each coarse field drawn whole, upsampled at the region's J
    columns of the global shape."""
    local = region.local
    b, c = local.shape[:2]
    small = _coarse_shape(region.shape[2:], scale)
    keys = [tio_random.draw_key(int(sd), 0) for sd in seeds]
    coarse = tio_random.normals(keys, [(1, c, *small)] * b, stds, local.device)
    return _apply_field(region, coarse.reshape(b, c, *small), divide)


def bias_shared(data, std: torch.Tensor, seed: int, scale: float, divide: bool):
    """One (B, C, *small) coarse draw from one seed (a DTensor: each rank
    draws its rows of it, from their counter base)."""
    region = region_of(data)
    local = region.local
    b, c = local.shape[:2]
    small = _coarse_shape(region.shape[2:], scale)
    if int(b) == int(region.shape[0]):
        coarse = tio_random.device_normal(int(seed), (b, c, *small), local.device, 0)
    else:
        start = region.b0 * c * math.prod(small)
        coarse = tio_random.normals(
            [tio_random.draw_key(int(seed), 0)], [(b, c, *small)], None, local.device,
            starts=[start],
        ).reshape(b, c, *small)
    return region.wrap(_apply_field(region, coarse * std.reshape(-1, 1, 1, 1, 1), divide))


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

    A sharded batch stays on each rank's region, fused or not.
    """

    takes_sharded = True

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
            keep = [not i for i in identity] if any(identity) else None
            args = (np.asarray(params["std"], np.float32), params["seed"], keep)
        else:
            all_id = params["std"] == 0
            args = (_f32(params["std"], device), params["seed"], None)
        return FusedStage(
            names=names,
            apply=bias_apply(names, self.scale, per_element, all_id),
            args=args,
            params=params,
            takes_sharded=True,
        )

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_BiasFieldInverse":
        return _BiasFieldInverse(
            std=params["std"], seed=params["seed"], scale=params["scale"], copy=False
        )


class _BiasFieldInverse(IntensityTransform):
    """Divides by the regenerated field (on a sharded batch, each rank's
    region of it, as the forward)."""

    takes_sharded = True

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
