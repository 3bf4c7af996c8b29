"""Spike (herringbone) artifact: point impulses in k-space.

Counterpart of ``torchio_tpu/transforms/intensity/spike.py``: impulses
whose amplitude is ``intensity`` times the spectrum's peak magnitude, at
random normalized positions of the centred spectrum; per-element
parameters and masks.

The positions are drawn on the host and moved to ifftshifted indices
there, so the impulses go into the unshifted spectrum: ``torch.fft.fftn``
over the three spatial axes, the per-(b, c) peak ``abs().amax``, one
``index_put_(accumulate=True)`` of every impulse, then the real part of
``ifftn`` in the data's dtype (the JAX package runs the same steps as one
XLA program).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ... import random as tio_random
from ...data.batch import SubjectsBatch
from .._utils import restore_gated
from ..parameter_range import to_nonneg_range, to_range
from ..transform import IntensityTransform

_SPATIAL = (-3, -2, -1)


class Spike(IntensityTransform):
    r"""Add k-space point impulses (stripes in image space).

    Args:
        num_spikes: impulses an element (scalar / range / distribution;
            at least one is drawn).
        intensity: impulse amplitude relative to the spectrum's peak.
    """

    def __init__(self, *, num_spikes: Any = 1, intensity: Any = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_spikes = to_nonneg_range(num_spikes)
        self.intensity = to_range(intensity)
        self.warn_if_noop(
            is_noop=self.intensity.is_constant(0.0) or self.num_spikes.is_constant(0.0),
            hint="intensity=(1, 3)",
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
            num = max(1, round(self.num_spikes.sample_1d()))
            return {
                "positions": rng.random((num, 3)).tolist(),
                "intensity": self.intensity.sample_1d(),
            }
        keep = self._keep_mask(batch, n)
        positions, intensities = [], []
        for i in range(n):
            if keep is not None and not keep[i]:
                positions.append([])
                intensities.append(0.0)
                continue
            num = max(1, round(self.num_spikes.sample_1d()))
            positions.append(rng.random((num, 3)).tolist())
            intensities.append(float(self.intensity.sample_1d()))
        params = {"positions": positions, "intensity": intensities}
        self._tag_batched(params, batch, n, keep, ["positions", "intensity"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        per_instance = self._is_per_instance_params(params)
        for img_batch in self._get_images(batch).values():
            data = img_batch.data
            b = data.shape[0]
            if per_instance:
                per_element = list(zip(params["positions"], params["intensity"]))
            else:
                per_element = [(params["positions"], params["intensity"])] * b
            active = [bool(p) and i != 0 for p, i in per_element]
            if not any(active):
                continue
            out = _add_spikes(data, per_element)
            img_batch.data = restore_gated(out, data, active if per_instance else None)
        return batch


def _add_spikes(data: torch.Tensor, per_element) -> torch.Tensor:
    """Add each element's impulses to its spectrum: (B, C, I, J, K) in,
    the same shape and dtype out."""
    shape = data.shape[2:]
    b_idx, coords, vals = [], [], []
    for b, (positions, intensity) in enumerate(per_element):
        if not positions or intensity == 0:
            continue
        for pos in positions:
            idx = [int(p * s) % s for p, s in zip(pos, shape)]
            # centred (shifted) index -> unshifted: the ifftshift map
            coords.append([(i + (s - s // 2)) % s for i, s in zip(idx, shape)])
            b_idx.append(b)
            vals.append(intensity)
    device = data.device
    b_idx_t = torch.as_tensor(np.asarray(b_idx, np.int64), device=device)
    coords_t = torch.as_tensor(np.asarray(coords, np.int64).reshape(-1, 3), device=device)
    vals_t = torch.as_tensor(np.asarray(vals, np.float32), device=device)
    spectrum = torch.fft.fftn(data.to(torch.float32), dim=_SPATIAL)
    peak = spectrum.abs().amax(dim=_SPATIAL)  # (B, C)
    impulses = (vals_t[:, None] * peak[b_idx_t]).to(spectrum.dtype)  # (M, C)
    channels = torch.arange(data.shape[1], device=device)
    index = (
        b_idx_t[:, None],
        channels[None, :],
        coords_t[:, 0:1],
        coords_t[:, 1:2],
        coords_t[:, 2:3],
    )
    spectrum.index_put_(index, impulses, accumulate=True)
    return torch.fft.ifftn(spectrum, dim=_SPATIAL).real.contiguous().to(data.dtype)
