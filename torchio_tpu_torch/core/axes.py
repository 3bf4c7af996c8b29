"""Axis-string conventions: voxel ("IJK" permutations) vs anatomical.

Counterpart of ``torchio_tpu/core/axes.py``, copied verbatim.

An axis string is 3 uppercase characters. Voxel strings are the 6
permutations of "IJK". Anatomical strings pick one letter from each of the
pairs {R,L}, {A,P}, {S,I} in any order (48 options). "IJK" is always voxel.
"""

from __future__ import annotations

from enum import Enum

ANATOMICAL_PAIRS: tuple[tuple[str, str], ...] = (("R", "L"), ("A", "P"), ("S", "I"))

_PAIR_OF = {c: pair for pair in ANATOMICAL_PAIRS for c in pair}
_OPPOSITE = {a: b for a, b in ANATOMICAL_PAIRS} | {b: a for a, b in ANATOMICAL_PAIRS}


class AxesType(Enum):
    """Kind of coordinate convention an axis string describes."""

    VOXEL = "voxel"
    ANATOMICAL = "anatomical"


def _is_voxel(axes: str) -> bool:
    return sorted(axes) == ["I", "J", "K"]


def _is_anatomical(axes: str) -> bool:
    if len(axes) != 3 or any(c not in _PAIR_OF for c in axes):
        return False
    pairs = {_PAIR_OF[c] for c in axes}
    return len(pairs) == 3


def validate_axes(axes: str) -> str:
    """Validate and return a 3-character axis string.

    Raises:
        ValueError: if ``axes`` is neither a voxel nor an anatomical string.
    """
    if len(axes) != 3:
        raise ValueError(f"Axis string must have 3 characters, got {axes!r}")
    if not (_is_voxel(axes) or _is_anatomical(axes)):
        raise ValueError(
            f"Invalid axis string {axes!r}: expected a permutation of 'IJK'"
            " or one letter from each of {R,L}, {A,P}, {S,I}"
        )
    return axes


def axes_type(axes: str) -> AxesType:
    """Classify a (valid) axis string as voxel or anatomical."""
    return AxesType.VOXEL if _is_voxel(axes) else AxesType.ANATOMICAL


def opposite(letter: str) -> str:
    """Opposite anatomical direction for a single letter."""
    return _OPPOSITE[letter]


def get_axis_mapping(
    src: str,
    tgt: str,
) -> tuple[tuple[int, int, int], tuple[bool, bool, bool]]:
    """Permutation + flips mapping axis convention ``src`` to ``tgt``.

    Returns ``(perm, flips)`` where ``perm[t]`` is the source axis index
    providing target axis ``t`` and ``flips[t]`` says whether it must be
    negated/reversed. Both strings must be the same :class:`AxesType`;
    converting between voxel and anatomical requires the affine.
    """
    st, tt = axes_type(src), axes_type(tgt)
    if st != tt:
        raise ValueError(
            f"Cannot map between axis types {src!r} ({st.value}) and"
            f" {tgt!r} ({tt.value}); use the image affine instead"
        )
    if st is AxesType.VOXEL:
        perm = tuple(src.index(c) for c in tgt)
        return (perm[0], perm[1], perm[2]), (False, False, False)
    perm_l: list[int] = []
    flips_l: list[bool] = []
    for c in tgt:
        pair = _PAIR_OF[c]
        idx = next(i for i, s in enumerate(src) if _PAIR_OF[s] == pair)
        perm_l.append(idx)
        flips_l.append(src[idx] != c)
    return (perm_l[0], perm_l[1], perm_l[2]), (flips_l[0], flips_l[1], flips_l[2])
