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

On a sharded batch (a LabelMap-key mask or none) the range of element 0
is computed where it lies: its minimum and maximum reduce the partial
ones of its J columns (``all_reduce``); other percentiles gather its J
columns, one element, over the mesh axis that splits J (``all_gather``),
and take the exact order statistics there; the pair is shared over the
axis that splits B (``broadcast``). Every rank rescales its region.

One deliberate difference from the JAX package (its known fault
``normalize.py:92``): fused, an integer image with a zero input range
keeps its dtype, as it does unfused.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import numpy as np
import torch

from ...data.batch import ImagesBatch, SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import map_region, region_of
from .._statistics import quantiles_on_device
from .._utils import broadcast_param
from ..fuse import finalize_range_warn
from ..parameter_range import to_range
from ..transform import DeferredParam, IntensityTransform


def mask_gathers(masking_method) -> bool:
    """Whether a masking spec is a callable: it reads the whole first
    element, so its stage runs on the gathered batch."""
    return callable(masking_method) and not isinstance(masking_method, str)


class MaskedStatistic:
    """The dispatch of a transform that reads element 0 within
    ``masking_method``: a sharded batch stays on each rank's region
    unless the mask is a callable (:func:`mask_gathers`)."""

    masking_method: Any

    @property
    def takes_sharded(self) -> bool:
        return not mask_gathers(self.masking_method)


class Normalize(MaskedStatistic, IntensityTransform):
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
                mask_data = mask_data_of(self.masking_method, img_batch, batch)
                in_ranges[name] = first_range(img_batch.data, mask_data, pct_low, pct_high, name)
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
            takes_sharded=True,
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
            out = rescale_region(img_batch.data, bounds, params["out_min"], params["out_max"],
                                 name)
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


def rescale_region(data, bounds, out_min, out_max, name: str):
    """:func:`rescale` of each rank's region of a DTensor (per-element
    output bounds taken to its rows), or of a whole tensor; None where
    the input range is zero."""
    region = region_of(data)
    out = rescale(region.local, bounds, region.take(out_min), region.take(out_max), name)
    return None if out is None else region.wrap(out)


def mask_batch_of(masking_method: str, batch: SubjectsBatch) -> ImagesBatch:
    """The LabelMap batch a masking key names."""
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
    return mask_batch


def mask_data_of(masking_method, img_batch: ImagesBatch, batch: SubjectsBatch):
    """The mask a statistic of element 0 reads, as (B, ...) data whose
    element 0 is read: None (every voxel), a LabelMap key's batch data
    (a DTensor on a sharded batch), or a callable's mask of the first
    element (on the gathered batch) with a leading axis."""
    if isinstance(masking_method, str):
        return mask_batch_of(masking_method, batch).data
    mask = resolve_mask(masking_method, img_batch, batch)
    return None if mask is None else mask[None]


def resolve_mask(masking_method, img_batch: ImagesBatch, batch: SubjectsBatch):
    """A masking spec -> a boolean tensor over the first element (on its
    device), or None."""
    if masking_method is None:
        return None
    if mask_gathers(masking_method):
        return torch.as_tensor(
            masking_method(img_batch.data[0]), device=img_batch.device
        ).to(torch.bool)
    if isinstance(masking_method, str):
        return mask_batch_of(masking_method, batch).data[0] != 0
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


def first_range(data, mask_data, pct_low: float, pct_high: float, name: str) -> DeferredParam:
    """:func:`_percentile_range` of element 0 of the (B, C, I, J, K)
    ``data`` within the non-zero voxels of element 0 of ``mask_data``
    (None: every voxel), the same pair on every rank. A DTensor's holders
    of element 0 reduce their columns' minima and maxima (``all_reduce``)
    or, for other percentiles, gather its columns (one element) and take
    the exact order statistics; the pair (and an empty mask's warning)
    reaches the other rows' ranks by one ``broadcast``."""
    region = region_of(data)
    mask_region = None if mask_data is None else region_of(mask_data)
    if region.whole:
        mask = None if mask_region is None else mask_region.local[0] != 0
        return _percentile_range(region.local[0], mask, pct_low, pct_high, name)
    holds = region.holds_first
    device = region.local.device
    first = m = None
    if holds:
        first = region.local[0].to(torch.float32)
        if mask_region is not None:
            region.check_aligned(mask_region)
            m = torch.broadcast_to(mask_region.local[0] != 0, first.shape)
    if mask_region is not None:
        count = torch.zeros(1, dtype=torch.float64, device=device)
        if holds:
            count = region.reduce_columns(m.sum().to(torch.float64).reshape(1))
        if not bool(region.share_first(count)[0] > 0):
            warnings.warn(
                f'Cannot compute percentiles for "{name}": mask is empty.'
                " Using full range.",
                RuntimeWarning,
                stacklevel=3,
            )
            m = None
    pair = torch.empty(2, dtype=torch.float32, device=device)
    if holds and pct_low == 0.0 and pct_high == 100.0:
        lo = (first if m is None else torch.where(m, first, torch.inf)).amin()
        hi = (first if m is None else torch.where(m, first, -torch.inf)).amax()
        # both as maxima: one all_reduce for the pair
        pair = region.reduce_columns(torch.stack([-lo, hi]), op="max")
        pair = torch.stack([-pair[0], pair[1]])
    elif holds:
        values = first if m is None else torch.where(m, first, torch.nan)
        whole = region.gather_first(values[None])
        pair = quantiles_on_device(whole, [pct_low / 100.0, pct_high / 100.0])
    return DeferredParam(region.share_first(pair), finalize_range_warn(name))


class _RescaleInverse(IntensityTransform):
    """Inverse of Normalize for history replay (a sharded batch on each
    rank's region, per-element output bounds taken to its rows)."""

    takes_sharded = True

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
            bounds = (self._out_min, self._out_max)
            scalar = not any(isinstance(v, (list, np.ndarray, torch.Tensor)) for v in bounds)
            if scalar and self._out_max - self._out_min == 0:
                continue
            img_batch.data = map_region(
                lambda local, lo, hi: _restore(local, lo, hi, in_min, in_range),
                img_batch.data, self._out_min, self._out_max)
        return batch

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        return {}


def _restore(local: torch.Tensor, out_min, out_max, in_min: float, in_range: float):
    """``local`` mapped from ``[out_min, out_max]`` back onto the input
    range in float32 (elements whose output range is zero unchanged)."""
    data = local.to(torch.float32)
    out_min = broadcast_param(out_min, data)
    out_max = broadcast_param(out_max, data)
    out_range = out_max - out_min
    if isinstance(out_range, float):
        return (data - out_min) / out_range * in_range + in_min
    zero = out_range == 0
    safe = torch.where(zero, torch.ones_like(out_range), out_range)
    return torch.where(zero, data, (data - out_min) / safe * in_range + in_min)


RescaleIntensity = Normalize
