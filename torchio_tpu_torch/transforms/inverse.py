"""History -> inverse pipeline reconstruction.

Counterpart of ``torchio_tpu/transforms/inverse.py``: walk the recorded
history backwards; rebuild each invertible transform from its serialized
params through the class registry (``object.__new__``, so ``__init__``
never reruns); skip unknown or non-invertible records with a warning;
optionally drop every intensity transform; give each inverse its
record's include/exclude scoping. A record is inverted as drawn where it
holds no deferred statistic (Spatial's arrays are read as arrays, with
no JSON round trip).
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable

from .compose import Compose
from .transform import (
    _TRANSFORM_REGISTRY,
    AppliedTransform,
    DeferredParam,
    IntensityTransform,
    Transform,
    _holds,
)


def _invert_one(trace: AppliedTransform, *, warn: bool, skip_intensity: bool):
    """The inverse of one history record, or None to skip it."""
    cls = _TRANSFORM_REGISTRY.get(trace.name)
    if cls is None:
        if warn:
            warnings.warn(
                f"Unknown transform {trace.name!r} in history, skipping",
                stacklevel=3,
            )
        return None
    if skip_intensity and issubclass(cls, IntensityTransform):
        return None
    shell = object.__new__(cls)  # params-only reconstruction, no __init__
    if not shell.invertible:
        if warn:
            warnings.warn(f"{trace.name} is not invertible, skipping", stacklevel=3)
        return None
    params = trace.raw_params()
    if _holds(params, DeferredParam):
        params = trace.params
    inverse = shell.inverse(params)
    inverse.include = trace.include
    inverse.exclude = trace.exclude
    return inverse


def get_inverse_transform(
    history: Iterable[AppliedTransform],
    *,
    warn: bool = True,
    ignore_intensity: bool = False,
) -> Compose:
    """A Compose undoing ``history`` (most recent transform first)."""
    steps: list[Transform] = []
    for trace in reversed(list(history)):
        inverse = _invert_one(trace, warn=warn, skip_intensity=ignore_intensity)
        if inverse is not None:
            steps.append(inverse)
    # copy=True (the default): inverting never mutates the caller's data
    return Compose(steps)


def apply_inverse_transform(
    data: Any,
    *,
    warn: bool = True,
    ignore_intensity: bool = False,
) -> Any:
    """Undo every recorded transform of a history-carrying object.

    Batches holding per-element histories (from a per-instance
    OneOf/SomeOf) delegate to their own element-wise inversion.
    """
    history = getattr(data, "applied_transforms", None)
    if history is None:
        return data
    if getattr(data, "_per_element_history", None) is not None:
        return data.apply_inverse_transform(warn=warn, ignore_intensity=ignore_intensity)
    pipeline = get_inverse_transform(
        history, warn=warn, ignore_intensity=ignore_intensity
    )
    result = pipeline(data)
    if hasattr(result, "applied_transforms"):
        result.applied_transforms = []
    return result
