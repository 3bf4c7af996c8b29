"""Orientation (ornt) machinery — nibabel-free reimplementation.

Counterpart of ``torchio_tpu/core/orientation.py``, copied verbatim. These
are the standard (3, 2) orientation arrays of ``nibabel.orientations``:
row = input axis, columns = (output/world axis, flip sign).
"""

from __future__ import annotations

import numpy as np

from .affine import affine_to_orientation

_CODE_TO_AXIS_SIGN = {
    "R": (0, 1.0),
    "L": (0, -1.0),
    "A": (1, 1.0),
    "P": (1, -1.0),
    "S": (2, 1.0),
    "I": (2, -1.0),
}


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) array mapping each voxel axis to (world axis, sign)."""
    return np.asarray(affine_to_orientation(affine), dtype=np.float64)


def axcodes2ornt(codes) -> np.ndarray:
    """3-letter code sequence -> (3, 2) orientation array."""
    out = np.zeros((3, 2))
    for i, c in enumerate(codes):
        axis, sign = _CODE_TO_AXIS_SIGN[c.upper()]
        out[i] = (axis, sign)
    return out


def ornt_transform(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Orientation transform taking ``start`` to ``end``."""
    result = np.empty_like(start)
    for end_in, (end_out, end_flip) in enumerate(end):
        for start_in, (start_out, start_flip) in enumerate(start):
            if end_out == start_out:
                result[int(start_in)] = (
                    end_in,
                    1.0 if start_flip == end_flip else -1.0,
                )
                break
        else:
            raise ValueError(f"Incompatible orientations: {start} vs {end}")
    return result


def apply_orientation(arr: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Flip then transpose the LAST 3 axes of an array per ``ornt``."""
    lead = arr.ndim - 3
    for ax in range(3):
        if ornt[ax, 1] == -1:
            arr = np.flip(arr, axis=ax + lead)
    perm = list(range(lead)) + [int(p) + lead for p in np.argsort(ornt[:, 0])]
    return np.ascontiguousarray(np.transpose(arr, perm))


def inv_ornt_aff(ornt: np.ndarray, shape) -> np.ndarray:
    """4x4 affine undoing an orientation transform (nibabel semantics)."""
    shape = np.asarray(shape[:3], np.float64)
    undo_reorder = np.eye(4)[list(ornt[:, 0].astype(int)) + [3], :]
    undo_flip = np.diag(list(ornt[:, 1]) + [1.0])
    center_trans = -(shape - 1) / 2.0
    undo_flip[:3, 3] = (ornt[:, 1] * center_trans) - center_trans
    return undo_flip @ undo_reorder
