"""Anisotropy: downsample then upsample along one axis (thick slices).

Counterpart of ``torchio_tpu/transforms/spatial/anisotropy.py``: nearest
downsampling to ``round(length / factor)`` samples, then nearest or
align_corners linear upsampling back, both folded into index gathers
along the axis (``index_select``, plus a lerp for linear) whose indices
and weights are computed on the host. Per-instance params degrade each
element on its own axis; elements whose factor is at most 1 stay
bit-exact, and label maps always take nearest.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from ...data.image import LabelMap
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


def _degrade_axis(data: torch.Tensor, axis: int, factor: float, mode: str) -> torch.Tensor:
    """Degrade (B', C, I, J, K) along ``axis`` with a shared factor, in
    float32."""
    dim = axis + 2
    length = data.shape[dim]
    down = _down_size(length, factor)
    f32 = data.to(torch.float32)
    dev = data.device
    if mode == "nearest":
        idx = torch.as_tensor(_nearest_indices(length, down), device=dev)
        return torch.index_select(f32, dim, idx)
    lower, upper, w = _linear_indices(length, down)
    shape = [1] * 5
    shape[dim] = length
    w = torch.as_tensor(w, device=dev).reshape(shape)
    lo = torch.index_select(f32, dim, torch.as_tensor(lower, device=dev))
    hi = torch.index_select(f32, dim, torch.as_tensor(upper, device=dev))
    return lo * (1.0 - w) + hi * w


class Anisotropy(Transform):
    r"""Simulate thick-slice acquisitions along a random axis."""

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
            data = img_batch.data
            if not per_instance:
                if params["factor"] <= 1.0:
                    continue
                degraded = _degrade_axis(data, params["axis"], params["factor"], mode)
                img_batch.data = cast_like_jax(degraded, data.dtype)
                continue
            axes, factors = params["axis"], params["factor"]
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
                rows.append(_degrade_axis(data[i : i + 1], axes[i], factors[i], mode)[0])
            img_batch.data = cast_like_jax(torch.stack(rows), data.dtype)
        return batch
