"""Ghosting: periodic k-space line attenuation along a phase axis.

Counterpart of ``torchio_tpu/transforms/intensity/ghosting.py``: every
``size // num_ghosts``-th line of the centred (fftshifted) spectrum is
scaled by ``1 - intensity`` along a random axis, with an optional central
restore band; per-element masks.

The line masks are built on the host and ifftshifted there, so the
spectrum is masked unshifted (:func:`_apply_mask`: ``torch.fft`` forward,
multiply, inverse, real part, where the JAX package uses XLA's FFT). Per
element, only the B * (I + J + K) floats of the three axis lines reach the
device; their outer product is the (B, 1, I, J, K) mask.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import cast_like_jax
from ...data.batch import SubjectsBatch
from .._utils import restore_gated
from ..parameter_range import to_nonneg_range
from ..transform import IntensityTransform

_SPATIAL = (-3, -2, -1)


def _line_mask(size: int, num_ghosts: int, intensity: float, restore: float):
    mask = np.ones(size, np.float32)
    step = max(size // num_ghosts, 1)
    mask[::step] = 1.0 - intensity
    if restore > 0:
        mid = size // 2
        half = max(int(size * restore / 2), 1)
        mask[mid - half : mid + half] = 1.0
    return mask


class Ghosting(IntensityTransform):
    r"""MRI ghosting artifact along a random phase-encoding axis.

    Args:
        num_ghosts: number of ghosts (scalar / range / distribution).
        axes: candidate spatial axes, one drawn per element.
        intensity: attenuation of the ghost lines (>= 0).
        restore: width, as a fraction of the axis, of the central band
            left untouched (None: no band).
    """

    def __init__(
        self,
        *,
        num_ghosts: Any = 4,
        axes: tuple[int, ...] = (0, 1, 2),
        intensity: Any = 0.0,
        restore: float | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_ghosts = to_nonneg_range(num_ghosts)
        self.axes = axes
        self.intensity = to_nonneg_range(intensity)
        self.restore = restore
        self.warn_if_noop(
            is_noop=self.intensity.is_constant(0.0) or self.num_ghosts.is_constant(0.0),
            hint="intensity=(0.5, 1)",
        )

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        restore = self.restore if self.restore is not None else 0.0
        rng = tio_random.get_rng()
        n = self._resolve_n(batch)
        if n is None:
            return {
                "num_ghosts": max(1, round(self.num_ghosts.sample_1d())),
                "axis": int(self.axes[rng.integers(len(self.axes))]),
                "intensity": self.intensity.sample_1d(),
                "restore": restore,
            }
        keep = self._keep_mask(batch, n)
        ghosts, axes, intensities = [], [], []
        for i in range(n):
            if keep is not None and not keep[i]:
                ghosts.append(0)
                axes.append(int(self.axes[0]))
                intensities.append(0.0)
                continue
            ghosts.append(max(1, round(self.num_ghosts.sample_1d())))
            axes.append(int(self.axes[rng.integers(len(self.axes))]))
            intensities.append(float(self.intensity.sample_1d()))
        params = {
            "num_ghosts": ghosts,
            "axis": axes,
            "intensity": intensities,
            "restore": restore,
        }
        self._tag_batched(params, batch, n, keep, ["num_ghosts", "axis", "intensity"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        per_instance = self._is_per_instance_params(params)
        restore = params["restore"]
        for img_batch in self._get_images(batch).values():
            data = img_batch.data
            spatial = data.shape[2:]
            if per_instance:
                b = data.shape[0]
                lines = [np.ones((b, s), np.float32) for s in spatial]
                active = []
                for i in range(b):
                    ghosts = params["num_ghosts"][i]
                    strength = params["intensity"][i]
                    if not ghosts or strength == 0:
                        active.append(False)
                        continue
                    active.append(True)
                    axis = params["axis"][i]
                    lines[axis][i] = np.fft.ifftshift(
                        _line_mask(spatial[axis], ghosts, strength, restore)
                    )
                li, lj, lk = (torch.as_tensor(line, device=data.device) for line in lines)
                mask = (
                    li[:, None, :, None, None]
                    * lj[:, None, None, :, None]
                    * lk[:, None, None, None, :]
                )
                out = _apply_mask(data, mask)
                img_batch.data = restore_gated(out, data, active)
            else:
                ghosts = params["num_ghosts"]
                strength = params["intensity"]
                if not ghosts or strength == 0:
                    continue
                axis = params["axis"]
                size = spatial[axis]
                line = np.fft.ifftshift(_line_mask(size, ghosts, strength, restore))
                shape = [1, 1, 1, 1, 1]
                shape[axis + 2] = size
                mask = torch.as_tensor(line.reshape(shape), device=data.device)
                img_batch.data = _apply_mask(data, mask)
        return batch


def _apply_mask(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multiply the unshifted spectrum by a host-pre-ifftshifted mask
    (fftshift -> mask -> ifftshift without the rolls); returns the real
    part of the inverse FFT in ``data``'s dtype."""
    spectrum = torch.fft.fftn(data.to(torch.float32), dim=_SPATIAL)
    spectrum *= mask  # in place: the spectrum is this function's own buffer
    return cast_like_jax(torch.fft.ifftn(spectrum, dim=_SPATIAL).real.contiguous(), data.dtype)
