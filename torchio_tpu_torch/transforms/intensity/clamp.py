"""Clamp (CT windowing).

Counterpart of ``torchio_tpu/transforms/intensity/clamp.py``. The result
dtype follows the JAX package's ``jnp.clip`` with Python bounds (weak
types): an integer image clamped by integer bounds keeps its dtype, and
a float bound makes it float32. ``torch.clamp`` promotes the same way,
but has no kernel for uint16 and uint32, so those go through int64 (or
float32 for a float bound) explicitly.
"""

from __future__ import annotations

from typing import Any

import torch

from ...data.batch import SubjectsBatch
from ..transform import IntensityTransform

#: unsigned types with no ``torch.clamp`` kernel
_WIDE_UNSIGNED = (torch.uint16, torch.uint32)


def clamp_values(data: torch.Tensor, out_min, out_max) -> torch.Tensor:
    """``jnp.clip(data, out_min, out_max)`` with Python bounds (either may
    be None), in the dtype JAX gives it."""
    if out_min is None and out_max is None:
        return data
    if data.dtype in _WIDE_UNSIGNED:
        floating = any(isinstance(b, float) for b in (out_min, out_max))
        wide = data.to(torch.float32 if floating else torch.int64)
        clamped = torch.clamp(wide, out_min, out_max)
        return clamped if floating else clamped.to(data.dtype)
    return torch.clamp(data, out_min, out_max)


class Clamp(IntensityTransform):
    """Clamp intensities to ``[out_min, out_max]``."""

    def __init__(
        self,
        *,
        out_min: float | None = None,
        out_max: float | None = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if out_min is not None and out_max is not None and out_min > out_max:
            raise ValueError(f"out_min ({out_min}) must be <= out_max ({out_max})")
        self.out_min = out_min
        self.out_max = out_max
        self.warn_if_noop(
            is_noop=out_min is None and out_max is None,
            hint="out_min=-1000, out_max=1000",
        )

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        for _name, img_batch in self._get_images(batch).items():
            img_batch.data = clamp_values(img_batch.data, self.out_min, self.out_max)
        return batch

    def fusable(self, batch: SubjectsBatch) -> bool:
        return bool(self._get_images(batch))

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, clamp_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        return FusedStage(
            names=names,
            apply=clamp_apply(names, self.out_min, self.out_max),
            args=None,
            params=self.make_params(batch),
        )
