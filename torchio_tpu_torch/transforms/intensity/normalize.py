"""Normalize / RescaleIntensity: clip + linear map to an output range.

Counterpart of ``torchio_tpu/transforms/intensity/normalize.py``: an
explicit or percentile-derived input range (per image, from the first
batch element), a randomizable output range, masking by a LabelMap key
or a callable, and ``_RescaleInverse`` for history replay.

A percentile-derived range stays on the batch's device as a
:class:`DeferredParam`: the rescale consumes the two 0-d tensors, and
the one host transfer happens when the history is first read, after the
output was computed. (0, 100) is the min and max; other percentiles are
exact order statistics (:mod:`.._statistics`).

One deliberate difference from the JAX package (its known fault
``normalize.py:92``): fused, an integer image with a zero input range
keeps its dtype, as it does unfused.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import torch

from ...data.batch import ImagesBatch, SubjectsBatch
from ...data.image import LabelMap
from .._statistics import quantiles_on_device
from .._utils import broadcast_param
from ..fuse import finalize_range_warn
from ..parameter_range import to_range
from ..transform import DeferredParam, IntensityTransform


class Normalize(IntensityTransform):
    r"""Clip to an input range and linearly rescale to an output range.

    :math:`v_{out} = (v - m_{min}) / (m_{max} - m_{min})
    \cdot (n_{max} - n_{min}) + n_{min}`

    Args:
        out_min / out_max: output bounds (randomizable).
        in_min / in_max: explicit input bounds; if ``None``, derived from
            percentiles of the (masked) data per image.
        percentile_low / percentile_high: percentiles for auto input
            range; nnU-Net convention is ``(0.5, 99.5)``.
        masking_method: ``None`` (all voxels), a LabelMap key, or a
            callable ``tensor -> bool mask`` (given the first element's
            (C, I, J, K) tensor).
    """

    def __init__(
        self,
        *,
        out_min: Any = -1.0,
        out_max: Any = 1.0,
        in_min: Any = None,
        in_max: Any = None,
        percentile_low: Any = 0.0,
        percentile_high: Any = 100.0,
        masking_method: str | Callable | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.out_min = to_range(out_min)
        self.out_max = to_range(out_max)
        self.in_min = to_range(in_min) if in_min is not None else None
        self.in_max = to_range(in_max) if in_max is not None else None
        self.percentile_low = to_range(percentile_low)
        self.percentile_high = to_range(percentile_high)
        self.masking_method = masking_method

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def _explicit(self) -> bool:
        return self.in_min is not None and self.in_max is not None

    def _out_params(self, batch: SubjectsBatch):
        n = self._resolve_n(batch)
        out_min = self.out_min.sample_1d(n)
        out_max = self.out_max.sample_1d(n)
        params: dict[str, Any] = {
            "out_min": self._serialize_param(out_min),
            "out_max": self._serialize_param(out_max),
        }
        return n, params

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        n, params = self._out_params(batch)
        if self._explicit:
            params["in_min"] = self.in_min.sample_1d()
            params["in_max"] = self.in_max.sample_1d()
        else:
            pct_low = self.percentile_low.sample_1d()
            pct_high = self.percentile_high.sample_1d()
            in_ranges: dict[str, Any] = {}
            for name, img_batch in self._get_images(batch).items():
                mask = self._get_mask(img_batch, batch)
                in_ranges[name] = _percentile_range(
                    img_batch.data[0], mask, pct_low, pct_high, name
                )
            params["in_ranges"] = in_ranges
        if n is not None:
            self._tag_batched(params, batch, n, None, ["out_min", "out_max"])
        return params

    def fusable(self, batch: SubjectsBatch) -> bool:
        if self.masking_method is not None or not self._get_images(batch):
            return False
        if self._explicit:
            return True
        # the (0, 100) min/max shortcut is chosen when the stage is built,
        # so randomized percentiles stay on the unfused path
        return (
            self.percentile_low.is_deterministic
            and self.percentile_high.is_deterministic
        )

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, install_range_params, normalize_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        # the RNG order of make_params
        n, params = self._out_params(batch)
        if self._explicit:
            params["in_min"] = self.in_min.sample_1d()
            params["in_max"] = self.in_max.sample_1d()
            pcts, finish = None, None
        else:
            pcts = (self.percentile_low.sample_1d(), self.percentile_high.sample_1d())
            finish = install_range_params
        if n is not None:
            self._tag_batched(params, batch, n, None, ["out_min", "out_max"])
        return FusedStage(
            names=names,
            apply=normalize_apply(names, pcts),
            args=params,
            params=params,
            finish=finish,
        )

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in self._get_images(batch).items():
            if "in_min" in params:
                bounds = (params["in_min"], params["in_max"])
            else:
                in_ranges = params.get("in_ranges", {})
                if name not in in_ranges:
                    continue
                bounds = in_ranges[name]
            out = rescale(img_batch.data, bounds, params["out_min"], params["out_max"], name)
            if out is not None:
                img_batch.data = out
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "_RescaleInverse":
        return _RescaleInverse(
            out_min=params["out_min"],
            out_max=params["out_max"],
            in_min=params.get("in_min"),
            in_max=params.get("in_max"),
            in_ranges=params.get("in_ranges"),
            copy=False,
        )

    def _get_mask(self, img_batch: ImagesBatch, batch: SubjectsBatch):
        return resolve_mask(self.masking_method, img_batch, batch)


def rescale(data: torch.Tensor, bounds, out_min, out_max, name: str):
    """Clip ``data`` to the input range ``bounds`` and map it linearly to
    ``[out_min, out_max]`` (scalars or per-element lists); None where the
    input range is zero (the image stays as it is).

    ``bounds`` is a ``(low, high)`` pair of floats, or a
    :class:`DeferredParam` of a device pair: a float image consumes its
    0-d tensors (a zero range selects the input, and its warning fires
    when the pair resolves); an integer image resolves it now, so that a
    zero range keeps the integer dtype."""
    deferred = None
    if isinstance(bounds, DeferredParam):
        if data.dtype.is_floating_point:
            deferred = bounds.device
            in_min, in_max = deferred[0], deferred[1]
        else:
            # the finalizer warns on a zero range
            in_min, in_max = bounds.resolve()
            if in_max - in_min == 0:
                return None
    else:
        in_min, in_max = bounds
    data = data.to(torch.float32)
    out_min = broadcast_param(out_min, data)
    out_max = broadcast_param(out_max, data)
    out_range = out_max - out_min
    if deferred is not None:
        in_range = in_max - in_min
        safe = torch.where(in_range == 0, 1.0, in_range)
        clipped = torch.clamp(data, in_min, in_max)
        scaled = (clipped - in_min) / safe * out_range + out_min
        return torch.where(in_range == 0, data, scaled)
    in_range = in_max - in_min
    if in_range == 0:
        warnings.warn(
            f'Cannot rescale "{name}": input range is zero.',
            RuntimeWarning,
            stacklevel=3,
        )
        return None
    data = torch.clamp(data, in_min, in_max)
    return (data - in_min) / in_range * out_range + out_min


def resolve_mask(masking_method, img_batch: ImagesBatch, batch: SubjectsBatch):
    """A masking spec -> a boolean tensor over the first element (on its
    device), or None."""
    if masking_method is None:
        return None
    if callable(masking_method) and not isinstance(masking_method, str):
        return torch.as_tensor(
            masking_method(img_batch.data[0]), device=img_batch.device
        ).to(torch.bool)
    if isinstance(masking_method, str):
        if masking_method not in batch.images:
            raise KeyError(
                f'Masking method "{masking_method}" not found in batch'
                f" images. Available: {list(batch.images)}"
            )
        mask_batch = batch.images[masking_method]
        if not issubclass(mask_batch.image_class, LabelMap):
            raise TypeError(
                f'Masking method "{masking_method}" must refer to a LabelMap.'
            )
        return mask_batch.data[0] != 0
    raise TypeError(
        f"masking_method must be None, str, or callable, got {type(masking_method)}"
    )


def range_pair(data: torch.Tensor, pct_low: float, pct_high: float) -> torch.Tensor:
    """The (low, high) percentiles of a flat float32 tensor, on its device:
    min and max for (0, 100), exact order statistics otherwise."""
    if pct_low == 0.0 and pct_high == 100.0:
        return torch.stack([data.min(), data.max()])
    return quantiles_on_device(data, [pct_low / 100.0, pct_high / 100.0])


def _percentile_range(tensor, mask, pct_low, pct_high, name) -> DeferredParam:
    """Deferred (low, high) intensity percentiles of ``tensor`` (the first
    element), computed on its device: no blocking transfer on the hot
    path. An empty mask warns and falls back to the full range (that test
    needs one host read, for masked images only)."""
    data = tensor.to(torch.float32).reshape(-1)
    pair = None
    if mask is not None:
        m = torch.broadcast_to(mask.to(data.device), tensor.shape).reshape(-1)
        if not bool(m.any()):
            warnings.warn(
                f'Cannot compute percentiles for "{name}": mask is empty.'
                " Using full range.",
                RuntimeWarning,
                stacklevel=3,
            )
        elif pct_low == 0.0 and pct_high == 100.0:
            pair = torch.stack(
                [
                    torch.where(m, data, torch.inf).min(),
                    torch.where(m, data, -torch.inf).max(),
                ]
            )
        else:
            masked = torch.where(m, data, torch.nan)
            pair = quantiles_on_device(masked, [pct_low / 100.0, pct_high / 100.0])
    if pair is None:
        pair = range_pair(data, pct_low, pct_high)
    return DeferredParam(pair, finalize_range_warn(name))


class _RescaleInverse(IntensityTransform):
    """Inverse of Normalize for history replay."""

    def __init__(
        self,
        *,
        out_min,
        out_max,
        in_min,
        in_max,
        in_ranges,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self._out_min = out_min
        self._out_max = out_max
        self._in_min = in_min
        self._in_max = in_max
        self._in_ranges = in_ranges

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for name, img_batch in self._get_images(batch).items():
            if self._in_min is not None and self._in_max is not None:
                in_min, in_max = self._in_min, self._in_max
            elif self._in_ranges is not None and name in self._in_ranges:
                in_min, in_max = self._in_ranges[name]
            else:
                continue
            in_range = in_max - in_min
            if in_range == 0:
                continue
            data = img_batch.data.to(torch.float32)
            out_min = broadcast_param(self._out_min, data)
            out_max = broadcast_param(self._out_max, data)
            out_range = out_max - out_min
            if isinstance(out_range, float):
                if out_range == 0:
                    continue
                img_batch.data = (data - out_min) / out_range * in_range + in_min
            else:
                zero = out_range == 0
                safe = torch.where(zero, torch.ones_like(out_range), out_range)
                restored = (data - out_min) / safe * in_range + in_min
                img_batch.data = torch.where(zero, data, restored)
        return batch

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {}


RescaleIntensity = Normalize
