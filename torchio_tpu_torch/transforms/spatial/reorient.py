"""Reorient: permute and flip voxel axes to a target anatomical orientation.

Counterpart of ``torchio_tpu/transforms/spatial/reorient.py``: the
orientation transform from the first element's affine to the target code
(nibabel's ``ornt_transform``), applied as ``torch.flip`` plus a
``permute`` of the data and the matching affine update; invertible by
reorienting back to the recorded original orientation. The permuted
tensor is a view: the kernel wrappers make their inputs contiguous where
they need it.

A sharded batch is reoriented on each rank's region: the flips through
:func:`.flip.flip` (along a J split from the mirror ranks' columns), the
permutation of the block. A permutation that moves a split J to another
axis makes that axis the split one: each rank flips its block, sends
every other rank the part of it that rank's new J columns cover (one
all-to-all over ``space``, :func:`..parallel.halo.move_split`), flips
the gathered J where it flips, and permutes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.affine import orientation_codes
from ...core.orientation import axcodes2ornt, inv_ornt_aff, io_orientation, ornt_transform
from ...core.dtypes import movable
from ...data.batch import SubjectsBatch
from ...parallel.mesh import is_dtensor, region_of
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


def permuted(data: torch.Tensor, perm) -> torch.Tensor:
    """``data.permute(perm)``; a DTensor's block permuted on each rank (a
    split J must stay the J axis)."""
    if not is_dtensor(data):
        return data.permute(perm)
    region = region_of(data)
    if perm[0] != 0 or (region.parts(3) > 1 and perm[3] != 3):
        raise ValueError(f"the permutation {tuple(perm)} moves a split axis of a sharded batch")
    return region.wrap(region.local.permute(perm), tuple(region.shape[p] for p in perm))


def _apply_ornt(data: torch.Tensor, ornt: np.ndarray) -> torch.Tensor:
    """Flip the spatial axes ``ornt`` marks -1, then move each to its
    output axis (the last three dims of ``data``)."""
    lead = data.ndim - 3
    flips = tuple(ax + lead for ax in range(3) if ornt[ax, 1] == -1)
    if flips:
        data = flip(data, flips)
    perm = list(range(lead)) + [int(p) + lead for p in np.argsort(ornt[:, 0])]
    return permuted(data, perm)


def moves_split_j(data: torch.Tensor, ornt: np.ndarray) -> bool:
    """Whether reorienting ``data`` by ``ornt`` moves a split J axis."""
    return (is_dtensor(data) and region_of(data).parts(3) > 1
            and int(np.argsort(ornt[:, 0])[1]) != 1)


def _move_split_j(data, ornt: np.ndarray):
    """:func:`_apply_ornt` of a DTensor whose split J moves to another
    axis: the input axis that becomes J is whole on every rank, so each
    rank flips its block along every axis but J, trades parts with the
    other ranks of ``space`` (:func:`..parallel.halo.move_split`: this
    rank's new J columns, whole along the old J), flips the old J where
    it flips, and permutes; no other collective."""
    from ...parallel.halo import move_split

    region = region_of(data)
    region.check_rows()
    perm = [0, 1] + [int(p) + 2 for p in np.argsort(ornt[:, 0])]
    local = movable(region.local)
    flips = tuple(ax + 2 for ax in (0, 2) if ornt[ax, 1] == -1)
    if flips:
        local = torch.flip(local, flips)
    moved = move_split(local, int(region.shape[3]), 3, perm[3], region.space_group)
    if ornt[1, 1] == -1:
        moved = torch.flip(moved, (3,))
    shape = tuple(region.shape[p] for p in perm)
    return region.wrap(moved.permute(perm).view(data.dtype), shape)


class Reorient(SpatialTransform):
    r"""Align voxel axes with a target orientation code (default RAS)."""

    takes_sharded = True

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
            data = img_batch.data
            original_shape = tuple(data.shape[-3:])
            if moves_split_j(data, ornt):
                img_batch.data = _move_split_j(data, ornt)
            else:
                img_batch.data = _apply_ornt(data, ornt)
            inv_aff = inv_ornt_aff(ornt, original_shape)
            for affine in img_batch.affines:
                affine._matrix = affine.data @ inv_aff
        return batch

    @property
    def invertible(self) -> bool:
        return True

    def inverse(self, params: dict[str, Any]) -> "Reorient":
        return Reorient(orientation=params["original_orientation"], copy=False)
