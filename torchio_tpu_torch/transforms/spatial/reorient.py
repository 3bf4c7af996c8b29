"""Reorient: permute and flip voxel axes to a target anatomical orientation.

Counterpart of ``torchio_tpu/transforms/spatial/reorient.py``: the
orientation transform from the first element's affine to the target code
(nibabel's ``ornt_transform``), applied as ``torch.flip`` plus a
``permute`` of the data and the matching affine update; invertible by
reorienting back to the recorded original orientation. The permuted
tensor is a view: the kernel wrappers make their inputs contiguous where
they need it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.affine import orientation_codes
from ...core.orientation import axcodes2ornt, inv_ornt_aff, io_orientation, ornt_transform
from ...data.batch import SubjectsBatch
from ..transform import SpatialTransform
from .flip import flip

_VALID = set("RLAPIS")
_PAIRS = [{"R", "L"}, {"A", "P"}, {"S", "I"}]


def _validate_orientation(orientation: str) -> str:
    if not isinstance(orientation, str) or len(orientation) != 3:
        raise ValueError(f'Orientation must be a 3-letter string, got "{orientation}"')
    orientation = orientation.upper()
    if not all(c in _VALID for c in orientation):
        raise ValueError(
            f'Orientation code must use characters in {_VALID}, got "{orientation}"'
        )
    codes = set(orientation)
    if not all(codes & pair for pair in _PAIRS):
        raise ValueError(
            "Orientation code must include one character per axis pair"
            f' (R/L, A/P, S/I), got "{orientation}"'
        )
    return orientation


def _apply_ornt(data: torch.Tensor, ornt: np.ndarray) -> torch.Tensor:
    """Flip the spatial axes ``ornt`` marks -1, then move each to its
    output axis (the last three dims of ``data``)."""
    lead = data.ndim - 3
    flips = tuple(ax + lead for ax in range(3) if ornt[ax, 1] == -1)
    if flips:
        data = flip(data, flips)
    perm = list(range(lead)) + [int(p) + lead for p in np.argsort(ornt[:, 0])]
    return data.permute(perm)


class Reorient(SpatialTransform):
    r"""Align voxel axes with a target orientation code (default RAS)."""

    def __init__(self, orientation: str = "RAS", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.orientation = _validate_orientation(orientation)

    def make_params(self, batch: SubjectsBatch) -> dict[str, Any]:
        first = next(iter(batch.images.values()))
        affine = first.affines[0].data
        current = "".join(orientation_codes(affine))
        ornt = ornt_transform(io_orientation(affine), axcodes2ornt(self.orientation))
        return {"ornt": ornt.tolist(), "original_orientation": current}

    def apply_transform(
        self, batch: SubjectsBatch, params: dict[str, Any]
    ) -> SubjectsBatch:
        ornt = np.asarray(params["ornt"], np.float64)
        if np.array_equal(ornt[:, 0], [0, 1, 2]) and np.all(ornt[:, 1] == 1):
            return batch
        for img_batch in self._get_images(batch).values():
            original_shape = tuple(img_batch.data.shape[-3:])
            img_batch.data = _apply_ornt(img_batch.data, ornt)
            inv_aff = inv_ornt_aff(ornt, original_shape)
            for affine in img_batch.affines:
                affine._matrix = affine.data @ inv_aff
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "Reorient":
        return Reorient(orientation=params["original_orientation"], copy=False)
