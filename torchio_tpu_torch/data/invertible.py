"""Mixin giving history-carrying objects inverse-transform support.

Counterpart of ``torchio_tpu/data/invertible.py``. A batch holding
per-element histories (from a per-instance OneOf/SomeOf) has no
counterpart yet: those transforms are not ported.
"""

from __future__ import annotations

from typing import Any


class Invertible:
    """Adds transform-history bookkeeping and inversion entry points.

    Subclasses carry ``applied_transforms``, a list of
    :class:`~torchio_tpu_torch.transforms.transform.AppliedTransform`
    records appended by every transform application.
    """

    applied_transforms: list[Any]

    @property
    def history(self) -> list[Any]:
        """Alias for ``applied_transforms``."""
        return self.applied_transforms

    def clear_history(self) -> None:
        """Drop all recorded transforms."""
        self.applied_transforms = []

    def get_inverse_transform(self, warn: bool = True, ignore_intensity: bool = False):
        """Build a transform that undoes the recorded history."""
        from ..transforms.inverse import get_inverse_transform

        return get_inverse_transform(
            self.applied_transforms, warn=warn, ignore_intensity=ignore_intensity
        )

    def apply_inverse_transform(self, warn: bool = True, ignore_intensity: bool = False):
        """Apply the inverse of the recorded history to ``self``."""
        from ..transforms.inverse import apply_inverse_transform

        return apply_inverse_transform(
            self, warn=warn, ignore_intensity=ignore_intensity
        )
