"""Anisotropy: downsample then upsample along one axis (thick slices).

Counterpart of ``torchio_tpu/transforms/spatial/anisotropy.py``: nearest
downsampling to ``round(length / factor)`` samples, then nearest or
align_corners linear upsampling back, both folded into index gathers
along the axis (``index_select``, plus a lerp for linear) whose indices
and weights are computed on the host. Per-instance params degrade each
element on its own axis; elements whose factor is at most 1 stay
bit-exact, and label maps always take nearest. A sharded batch degrades
each rank's region: along I and K in place, along a J split from the
input columns its own read, sent by the ranks that hold them (one
``batch_isend_irecv`` over ``space``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
from ...parallel.mesh import Region, region_of
from ..parameter_range import to_nonneg_range
from ..transform import Transform


def _down_size(length: int, factor: float) -> int:
    return max(1, round(length / factor))


def _nearest_indices(length: int, down: int) -> np.ndarray:
    """Original-axis source index for nearest down- then up-sampling."""
    positions = np.arange(length)
    lowres = positions * down // length
    src = lowres * length // down
    return np.minimum(src, length - 1)


def _linear_indices(length: int, down: int):
    positions = np.arange(length, dtype=np.float64)
    if length == 1:
        low_pos = np.zeros(1)
    else:
        low_pos = positions * ((down - 1.0) / (length - 1))
    lower_low = np.floor(low_pos).astype(np.int64)
    upper_low = np.minimum(lower_low + 1, down - 1)
    weights = (low_pos - lower_low).astype(np.float32)
    lower = np.minimum(lower_low * length // down, length - 1)
    upper = np.minimum(upper_low * length // down, length - 1)
    return lower, upper, weights


def _axis_indices(length: int, factor: float, mode: str):
    """The source indices a degraded axis reads (one array for nearest,
    the lower and upper for linear) and the linear weights (None)."""
    down = _down_size(length, factor)
    if mode == "nearest":
        return [_nearest_indices(length, down)], None
    lower, upper, w = _linear_indices(length, down)
    return [lower, upper], w


def _degrade_axis(data: torch.Tensor, axis: int, factor: float, mode: str,
                  region: Region | None = None, fetched=None) -> torch.Tensor:
    """Degrade (B', C, I, J, K) along ``axis`` with a shared factor, in
    float32. ``data`` holds rows of ``region``'s block: along a J split
    the columns its indices read come from the ranks that hold them
    (``fetched``: already taken, :meth:`..parallel.mesh.Region.
    fetch_index_columns`)."""
    dim = axis + 2
    split = region is not None and dim == 3 and region.parts(3) > 1
    length = int(region.shape[3]) if split else data.shape[dim]
    indices, w = _axis_indices(length, factor, mode)
    f32 = data.to(torch.float32)
    dev = data.device
    if split:
        start, stop = region.columns(length)
        picked = fetched or region.fetch_index_columns(f32, length, indices)
    else:
        start, stop = 0, length
        picked = [torch.index_select(f32, dim, torch.as_tensor(i, device=dev)) for i in indices]
    if mode == "nearest":
        return picked[0]
    shape = [1] * 5
    shape[dim] = stop - start
    w = torch.as_tensor(w[start:stop], device=dev).reshape(shape)
    return picked[0] * (1.0 - w) + picked[1] * w


def _fetch_j_rows(region: Region, data: torch.Tensor, axes, factors, mode: str) -> dict:
    """The columns that the rows degraded along a split J read, for all of
    them in one exchange: row -> its fetched columns (nothing where J is
    one block)."""
    rows = [i for i in range(data.shape[0]) if factors[i] > 1.0 and axes[i] == 1]
    if not rows or region.parts(3) == 1:
        return {}
    length = int(region.shape[3])
    arrays = [_axis_indices(length, factors[i], mode)[0] for i in rows]
    index = torch.as_tensor(rows, device=data.device)
    columns = region.fetch_index_columns(data.index_select(0, index).to(torch.float32), length,
                                         [a for arrs in arrays for a in arrs])
    fetched, at = {}, 0
    for n, (i, arrs) in enumerate(zip(rows, arrays)):
        fetched[i] = [c[n:n + 1] for c in columns[at:at + len(arrs)]]
        at += len(arrs)
    return fetched


class Anisotropy(Transform):
    r"""Simulate thick-slice acquisitions along a random axis."""

    takes_sharded = True

    def __init__(
        self,
        *,
        axes: tuple[int, ...] = (0, 1, 2),
        downsampling: Any = 1.0,
        image_interpolation: str = "linear",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.axes = axes
        self.downsampling = to_nonneg_range(downsampling)
        self.image_interpolation = image_interpolation
        _lo, hi = self.downsampling._ranges[0]
        if hi < 1.0:
            raise ValueError(f"downsampling range upper bound must be >= 1, got {hi}")
        self.warn_if_noop(
            is_noop=self.downsampling.is_constant(1.0), hint="downsampling=(1.5, 5)"
        )

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        rng = tio_random.get_rng()
        n = self._resolve_n(batch)
        if n is None:
            return {
                "axis": int(self.axes[rng.integers(len(self.axes))]),
                "factor": max(1.0, self.downsampling.sample_1d()),
            }
        keep = self._keep_mask(batch, n)
        axes, factors = [], []
        for i in range(n):
            if keep is not None and not keep[i]:
                axes.append(int(self.axes[0]))
                factors.append(1.0)
                continue
            axes.append(int(self.axes[rng.integers(len(self.axes))]))
            factors.append(float(max(1.0, self.downsampling.sample_1d())))
        params = {"axis": axes, "factor": factors}
        self._tag_batched(params, batch, n, keep, ["axis", "factor"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        per_instance = self._is_per_instance_params(params)
        for img_batch in batch.images.values():
            is_label = issubclass(img_batch.image_class, LabelMap)
            mode = "nearest" if is_label else self.image_interpolation
            region = region_of(img_batch.data)
            region.check_rows()
            data = region.local
            if not per_instance:
                if params["factor"] <= 1.0:
                    continue
                degraded = _degrade_axis(data, params["axis"], params["factor"], mode, region)
                img_batch.data = region.wrap(cast_like_jax(degraded, data.dtype))
                continue
            axes, factors = region.take(params["axis"]), region.take(params["factor"])
            fetched = _fetch_j_rows(region, data, axes, factors, mode)
            rows = []
            for i in range(data.shape[0]):
                # an element whose factor is at most 1 keeps its float32 row
                if factors[i] <= 1.0:
                    rows.append(data[i].to(torch.float32))
                    continue
                if not 0 <= axes[i] <= 2:
                    raise ValueError(
                        f"Anisotropy axis must be in {{0, 1, 2}}, got {axes[i]}"
                    )
                rows.append(
                    _degrade_axis(data[i : i + 1], axes[i], factors[i], mode, region,
                                  fetched.get(i))[0]
                )
            degraded = torch.stack(rows) if rows else data.to(torch.float32)
            img_batch.data = region.wrap(cast_like_jax(degraded, data.dtype))
        return batch
