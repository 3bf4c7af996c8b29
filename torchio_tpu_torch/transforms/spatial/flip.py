"""Flip: reverse voxel order along spatial axes.

Counterpart of ``torchio_tpu/transforms/spatial/flip.py``: int or
anatomical-label axes (resolved against each element's orientation), a
per-axis ``flip_probability``, a per-element path that flips the batch
once per axis and selects with a mask, and ``_FlipInverse`` (a flip is
its own inverse, element by element).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ... import random as tio_random
from ...core.dtypes import movable
from ...data.batch import SubjectsBatch
from ..transform import SpatialTransform

#: The three anatomical axis families; a label belongs to the family
#: containing its first letter (``'Left'`` -> ``'LR'``, ``'p'`` -> ``'AP'``).
_AXIS_FAMILIES = ("LR", "AP", "IS")


def _axis_from_label(label: str, orientation: tuple[str, str, str] | None) -> int:
    """Voxel axis carrying the anatomical direction named by ``label``:
    an orientation code ('RAS', 'LPI', ...) names each family once."""
    family = next(
        (codes for codes in _AXIS_FAMILIES if label[:1].upper() in codes), None
    )
    if family is None:
        raise ValueError(
            f"Unknown anatomical label {label!r}; use L, R, A, P, I, S"
            " or full names like 'Left'"
        )
    if orientation is None:
        raise ValueError(
            f"Cannot resolve anatomical axis {label!r} without image orientation"
        )
    return next(d for d, code in enumerate(orientation) if code in family)


def _resolve_axes(
    axes: int | str | Sequence[int | str],
    orientation: tuple[str, str, str] | None = None,
) -> tuple[int, ...]:
    """ints and/or anatomical labels -> sorted unique spatial axes."""
    specs = (axes,) if isinstance(axes, (int, str)) else axes
    resolved: set[int] = set()
    for spec in specs:
        if isinstance(spec, (int, np.integer)):
            if spec not in (0, 1, 2):
                raise ValueError(f"Axis must be 0, 1, or 2; got {spec}")
            resolved.add(int(spec))
        elif isinstance(spec, str):
            resolved.add(_axis_from_label(spec, orientation))
        else:
            raise TypeError(f"Axis must be int or str, got {type(spec).__name__}")
    return tuple(sorted(resolved))


def flip(data: torch.Tensor, dims) -> torch.Tensor:
    """``torch.flip`` for every dtype (torch has no flip kernel for its
    wider unsigned types: their bits move as the signed type's)."""
    return torch.flip(movable(data), tuple(dims)).view(data.dtype)


def flip_flags(axes_per_element: list[list[int]]) -> np.ndarray:
    """(B, 3) booleans: element ``b`` flips spatial axis ``a``."""
    flags = np.zeros((len(axes_per_element), 3), bool)
    for element, axes in enumerate(axes_per_element):
        flags[element, list(axes)] = True
    return flags


def flip_per_element(data: torch.Tensor, flags: np.ndarray) -> torch.Tensor:
    """Flip each batch element along its own axes (``flags`` from
    :func:`flip_flags`). Flips along distinct axes commute, so the batch
    is flipped once per axis that any element flips, and a mask picks
    each element's version."""
    result = movable(data)
    for axis in np.flatnonzero(flags.any(axis=0)):
        select = torch.as_tensor(flags[:, axis], device=data.device)
        select = select.reshape(-1, 1, 1, 1, 1)
        result = torch.where(select, torch.flip(result, (int(axis) - 3,)), result)
    return result.view(data.dtype)


class Flip(SpatialTransform):
    """Flip along spatial axes (optionally with a per-axis coin flip).

    ``axes`` may be ints in {0, 1, 2} or anatomical labels ('Left',
    'Posterior', ...) resolved against the image orientation.
    """

    def __init__(
        self,
        *,
        axes: int | str | Sequence[int | str] = 0,
        flip_probability: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.axes = axes
        if not 0 <= flip_probability <= 1:
            raise ValueError(
                f"flip_probability must be in [0, 1], got {flip_probability}"
            )
        self.flip_probability = flip_probability

    @property
    def supports_per_instance_params(self) -> bool:
        return True

    @property
    def supports_per_instance_p(self) -> bool:
        return True

    def _draw_axes(self, orientation) -> list[int]:
        """One coin per requested axis, resolved against an orientation."""
        coins = tio_random.random(3) < self.flip_probability
        return [a for a in _resolve_axes(self.axes, orientation) if coins[a]]

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        images = self._get_images(batch)
        if not images:
            return {"axes": ()}
        first = next(iter(images.values()))
        n = self._resolve_n(batch)
        if n is None:
            orientation = first.affines[0].orientation if first.batch_size else None
            return {"axes": tuple(self._draw_axes(orientation))}
        keep = self._keep_mask(batch, n)
        axes_list = [
            []
            if keep is not None and not keep[i]
            else self._draw_axes(first.affines[i].orientation)
            for i in range(n)
        ]
        params = {"axes": axes_list}
        self._tag_batched(params, batch, n, keep, ["axes"])
        return params

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        axes = params["axes"]
        if self._is_per_instance_params(params):
            flags = flip_flags(axes)
            for img_batch in self._get_images(batch).values():
                img_batch.data = flip_per_element(img_batch.data, flags)
            return batch
        if not axes:
            return batch
        dims = tuple(a - 3 for a in axes)
        for img_batch in self._get_images(batch).values():
            img_batch.data = flip(img_batch.data, dims)
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]):
        if self._is_per_instance_params(params):
            return _FlipInverse(axes_per_element=params["axes"], copy=False)
        return Flip(axes=tuple(params["axes"]), copy=False)

    def fusable(self, batch: SubjectsBatch) -> bool:
        return bool(self._get_images(batch))

    def fused_stage(self, batch: SubjectsBatch):
        from ..fuse import FusedStage, flip_per_element_apply, flip_static_apply

        names = tuple(self._get_images(batch))
        if not names:
            return None
        params = self.make_params(batch)
        axes = params["axes"]
        if self._is_per_instance_params(params):
            return FusedStage(
                names=names,
                apply=flip_per_element_apply(names),
                args=flip_flags(axes),
                params=params,
            )
        return FusedStage(
            names=names,
            apply=flip_static_apply(names, tuple(a - 3 for a in axes)),
            args=(),
            params=params,
        )


class _FlipInverse(SpatialTransform):
    """Inverse of a per-instance Flip (flip is self-inverse per element)."""

    def __init__(self, *, axes_per_element: list[list[int]], **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._axes_per_element = axes_per_element

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        flags = flip_flags(self._axes_per_element)
        for img_batch in self._get_images(batch).values():
            img_batch.data = flip_per_element(img_batch.data, flags)
        return batch
