"""4x4 voxel-to-world affine matrices, stored as float64 numpy on host.

Counterpart of ``torchio_tpu/core/affine.py``, copied verbatim: the same
property surface (spacing/origin/direction/orientation/euler_angles,
``@`` composition, ``inverse()``, ``apply(points)``, ``from_spacing``).

Affines are *metadata*: tiny 4x4 matrices that stay float64 for geometric
precision, so all affine algebra happens on the host in numpy and only the
final float32 resampling maps are shipped to the device.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

import numpy as np
import numpy.typing as npt

from .axes import ANATOMICAL_PAIRS

# World axes in RAS+: +x -> R, +y -> A, +z -> S.
_POS_CODES = tuple(pair[0] for pair in ANATOMICAL_PAIRS)  # ('R', 'A', 'S')
_NEG_CODES = tuple(pair[1] for pair in ANATOMICAL_PAIRS)  # ('L', 'P', 'I')


def affine_to_orientation(matrix: npt.NDArray) -> list[tuple[int, float]]:
    """Nearest axis orientation of a voxel-to-world affine.

    For each voxel axis (column), find the world axis it is most aligned
    with, using greedy assignment on the column-normalized rotation block
    (equivalent to ``nibabel.io_orientation`` for non-degenerate affines).

    Returns:
        List of ``(world_axis, sign)`` per voxel axis.
    """
    rot = np.asarray(matrix, dtype=np.float64)[:3, :3].copy()
    norms = np.linalg.norm(rot, axis=0)
    norms[norms == 0] = 1.0
    cosines = np.abs(rot / norms)
    result: list[tuple[int, float] | None] = [None, None, None]
    used_rows: set[int] = set()
    used_cols: set[int] = set()
    for _ in range(3):
        best = (-1.0, -1, -1)
        for i in range(3):  # world axis (row)
            if i in used_rows:
                continue
            for j in range(3):  # voxel axis (column)
                if j in used_cols:
                    continue
                if cosines[i, j] > best[0]:
                    best = (cosines[i, j], i, j)
        _, i, j = best
        used_rows.add(i)
        used_cols.add(j)
        result[j] = (i, float(np.sign(rot[i, j])) or 1.0)
    return result  # type: ignore[return-value]


def orientation_codes(matrix: npt.NDArray) -> tuple[str, str, str]:
    """Anatomical codes of each voxel axis, e.g. ``('R', 'A', 'S')``."""
    codes = []
    for world_axis, sign in affine_to_orientation(matrix):
        codes.append(_POS_CODES[world_axis] if sign > 0 else _NEG_CODES[world_axis])
    return (codes[0], codes[1], codes[2])


class AffineMatrix:
    r"""A :math:`4 \times 4` matrix mapping voxel indices to RAS+ world mm.

    Backed by a float64 numpy array (host memory). Compose with ``@``,
    invert with :meth:`inverse`, and map points with :meth:`apply`.
    """

    __slots__ = ("_matrix",)

    def __init__(self, matrix: Any = None) -> None:
        if matrix is None:
            self._matrix = np.eye(4, dtype=np.float64)
        elif isinstance(matrix, AffineMatrix):
            self._matrix = matrix._matrix.copy()
        else:
            arr = np.asarray(_to_numpy(matrix), dtype=np.float64)
            if arr.shape != (4, 4):
                raise ValueError(f"AffineMatrix must be 4x4, got {arr.shape}")
            self._matrix = arr.copy()

    @classmethod
    def from_spacing(
        cls,
        spacing: float | Iterable[float],
        *,
        origin: Iterable[float] = (0.0, 0.0, 0.0),
        direction: Any = None,
    ) -> "AffineMatrix":
        """Build an affine from spacing, origin and 3x3 direction."""
        m = np.eye(4, dtype=np.float64)
        if direction is not None:
            m[:3, :3] = np.asarray(_to_numpy(direction), dtype=np.float64)
        if np.isscalar(spacing):
            sp = np.full(3, float(spacing))  # type: ignore[arg-type]
        else:
            sp = np.asarray(tuple(spacing), dtype=np.float64)
        m[:3, :3] = m[:3, :3] * sp
        m[:3, 3] = np.asarray(tuple(origin), dtype=np.float64)
        return cls(m)

    # --- Properties ---

    @property
    def data(self) -> np.ndarray:
        """The underlying float64 (4, 4) numpy array."""
        return self._matrix

    @property
    def spacing(self) -> tuple[float, float, float]:
        """Voxel spacing in mm (column norms of the rotation-zoom block)."""
        sp = np.linalg.norm(self._matrix[:3, :3], axis=0)
        return (float(sp[0]), float(sp[1]), float(sp[2]))

    @property
    def origin(self) -> tuple[float, float, float]:
        """World coordinates of the first voxel center."""
        o = self._matrix[:3, 3]
        return (float(o[0]), float(o[1]), float(o[2]))

    @property
    def direction(self) -> np.ndarray:
        """3x3 direction matrix with spacing factored out."""
        rz = self._matrix[:3, :3]
        return rz / np.linalg.norm(rz, axis=0)

    @property
    def orientation(self) -> tuple[str, str, str]:
        """Anatomical orientation codes, e.g. ``('R', 'A', 'S')``."""
        return orientation_codes(self._matrix)

    @property
    def euler_angles(self) -> tuple[float, float, float]:
        """Rotation as XYZ-intrinsic Euler angles in degrees."""
        r = self.direction
        sy = math.hypot(float(r[0, 0]), float(r[1, 0]))
        if sy >= 1e-6:
            x = math.atan2(float(r[2, 1]), float(r[2, 2]))
            y = math.atan2(-float(r[2, 0]), sy)
            z = math.atan2(float(r[1, 0]), float(r[0, 0]))
        else:
            x = math.atan2(-float(r[1, 2]), float(r[1, 1]))
            y = math.atan2(-float(r[2, 0]), sy)
            z = 0.0
        return (math.degrees(x), math.degrees(y), math.degrees(z))

    # --- Methods ---

    def clone(self) -> "AffineMatrix":
        """Deep copy."""
        return AffineMatrix(self._matrix)

    def inverse(self) -> "AffineMatrix":
        """Inverse affine (world -> voxel)."""
        return AffineMatrix(np.linalg.inv(self._matrix))

    def compose(self, other: "AffineMatrix") -> "AffineMatrix":
        """``self @ other``."""
        return AffineMatrix(self._matrix @ other._matrix)

    def apply(self, points: Any) -> np.ndarray:
        """Map an (N, 3) point set through the affine (homogeneous)."""
        pts = np.asarray(_to_numpy(points), dtype=np.float64)
        squeeze = pts.ndim == 1
        pts = np.atleast_2d(pts)
        out = pts @ self._matrix[:3, :3].T + self._matrix[:3, 3]
        return out[0] if squeeze else out

    def numpy(self) -> np.ndarray:
        """Copy of the matrix as float64 numpy."""
        return self._matrix.copy()

    def tolist(self) -> list[list[float]]:
        """Nested-list form (JSON-serializable)."""
        return self._matrix.tolist()

    def to(self, *args: Any, **kwargs: Any) -> "AffineMatrix":
        """No-op for API parity: affines always live on host in float64."""
        return self

    # --- Dunder ---

    def __matmul__(self, other: object) -> "AffineMatrix":
        if not isinstance(other, AffineMatrix):
            return NotImplemented
        return self.compose(other)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self._matrix
        if dtype is not None:
            return np.array(arr, dtype=dtype)
        return arr.copy() if copy else arr

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, AffineMatrix):
            return NotImplemented
        return bool(np.array_equal(self._matrix, other._matrix))

    def __hash__(self) -> int:  # needed since __eq__ is defined
        return hash(self._matrix.tobytes())

    def __repr__(self) -> str:
        sp = ", ".join(f"{s:.2f}" for s in self.spacing)
        o = ", ".join(f"{v:.2f}" for v in self.origin)
        ori = "".join(self.orientation)
        return f"AffineMatrix(spacing=({sp}), origin=({o}), orientation={ori}+)"

    def __copy__(self) -> "AffineMatrix":
        return self.clone()

    def __deepcopy__(self, memo: dict) -> "AffineMatrix":
        new = self.clone()
        memo[id(self)] = new
        return new


def _to_numpy(x: Any) -> Any:
    """Convert torch tensors / lists to something numpy accepts."""
    if hasattr(x, "__array__"):
        return np.asarray(x)
    if hasattr(x, "detach"):  # torch tensor without __array__ on some builds
        return x.detach().cpu().numpy()
    return x
