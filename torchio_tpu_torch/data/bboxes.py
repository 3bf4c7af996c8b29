"""3D bounding boxes with format (axes + representation) conversion.

Counterpart of ``torchio_tpu/data/bboxes.py`` (modelled after
torchvision's ``tv_tensors.BoundingBoxes``, extended to 3D with voxel
and anatomical axis conventions). Boxes are host metadata: float32 numpy
coordinates, int64 labels and a float64 affine on the host, on whatever
device the images lie.
"""

from __future__ import annotations

from enum import Enum
from typing import Any

import numpy as np

from ..core.affine import AffineMatrix
from ..core.axes import AxesType, axes_type, get_axis_mapping, validate_axes
from .points import host_array


class Representation(Enum):
    """How the six columns of a box are interpreted."""

    CORNERS = "corners"  # (a1, b1, c1, a2, b2, c2)
    CENTER_SIZE = "center_size"  # (ac, bc, cc, sa, sb, sc)


class BoundingBoxFormat:
    """(axes, representation) pair describing a bounding-box encoding."""

    IJKIJK: "BoundingBoxFormat"
    IJKWHD: "BoundingBoxFormat"

    __slots__ = ("_axes", "_representation")

    def __init__(
        self,
        axes: str,
        representation: Representation | str = Representation.CORNERS,
    ) -> None:
        self._axes = validate_axes(axes)
        self._representation = Representation(representation)

    @property
    def axes(self) -> str:
        return self._axes

    @property
    def representation(self) -> Representation:
        return self._representation

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, BoundingBoxFormat):
            return NotImplemented
        return (self._axes, self._representation) == (
            other._axes,
            other._representation,
        )

    def __hash__(self) -> int:
        return hash((self._axes, self._representation))

    def __repr__(self) -> str:
        return (
            f"BoundingBoxFormat(axes={self._axes!r},"
            f" representation={self._representation.value!r})"
        )


BoundingBoxFormat.IJKIJK = BoundingBoxFormat("IJK", Representation.CORNERS)
BoundingBoxFormat.IJKWHD = BoundingBoxFormat("IJK", Representation.CENTER_SIZE)


def _cs_to_corners(d: np.ndarray) -> np.ndarray:
    center, size = d[:, :3], d[:, 3:]
    return np.concatenate([center - size / 2, center + size / 2], axis=-1)


def _corners_to_cs(d: np.ndarray) -> np.ndarray:
    lo, hi = d[:, :3], d[:, 3:]
    return np.concatenate([(lo + hi) / 2, hi - lo], axis=-1)


def _permute_corners(d: np.ndarray, perm, flips) -> np.ndarray:
    p = list(perm)
    c1, c2 = d[:, :3][:, p].copy(), d[:, 3:][:, p].copy()
    for col, flip in enumerate(flips):
        if flip:
            a, b = -c1[:, col].copy(), -c2[:, col].copy()
            c1[:, col] = np.minimum(a, b)
            c2[:, col] = np.maximum(a, b)
    return np.concatenate([c1, c2], axis=-1)


def _map_corners(d: np.ndarray, affine: AffineMatrix) -> np.ndarray:
    w1 = affine.apply(d[:, :3]).astype(np.float32)
    w2 = affine.apply(d[:, 3:]).astype(np.float32)
    return np.concatenate([np.minimum(w1, w2), np.maximum(w1, w2)], axis=-1)


class BoundingBoxes:
    """(N, 6) axis-aligned 3D boxes with optional per-box integer labels."""

    def __init__(
        self,
        data: Any,
        *,
        format: BoundingBoxFormat = BoundingBoxFormat.IJKIJK,  # noqa: A002
        labels: Any = None,
        affine: Any = None,
        metadata: dict[str, Any] | None = None,
    ) -> None:
        arr = host_array(data, np.float32)
        if arr.ndim != 2 or arr.shape[1] != 6:
            raise ValueError(f"BoundingBoxes must have shape (N, 6), got {arr.shape}")
        self._data = arr
        self._format = format
        if labels is not None:
            labels = host_array(labels, np.int64)
            if labels.shape != (arr.shape[0],):
                raise ValueError(
                    f"labels must have shape ({arr.shape[0]},), got {labels.shape}"
                )
        self._labels = labels
        self._affine = affine if isinstance(affine, AffineMatrix) else AffineMatrix(affine)
        self._metadata = dict(metadata) if metadata else {}

    # --- Properties ---

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def device(self) -> str:
        """Placement of the box data ("cpu": annotations stay on host)."""
        return "cpu"

    @property
    def format(self) -> BoundingBoxFormat:
        return self._format

    @property
    def labels(self) -> np.ndarray | None:
        return self._labels

    @property
    def affine(self) -> AffineMatrix:
        return self._affine

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def num_boxes(self) -> int:
        return int(self._data.shape[0])

    def to(self, *args: Any, **kwargs: Any) -> "BoundingBoxes":
        """No-op: boxes are host metadata."""
        return self

    # --- Conversion ---

    def to_format(self, format: BoundingBoxFormat) -> "BoundingBoxes":  # noqa: A002
        """Convert representation and/or axis convention."""
        if format == self._format:
            return self._clone(format=format)
        data = self._data
        if self._format.representation is Representation.CENTER_SIZE:
            data = _cs_to_corners(data)
        src_axes, tgt_axes = self._format.axes, format.axes
        if src_axes != tgt_axes:
            st, tt = axes_type(src_axes), axes_type(tgt_axes)
            if st == tt:
                perm, flips = get_axis_mapping(src_axes, tgt_axes)
                data = _permute_corners(data, perm, flips)
            elif st is AxesType.VOXEL:
                if src_axes != "IJK":
                    perm, _ = get_axis_mapping(src_axes, "IJK")
                    data = _permute_corners(data, perm, (False, False, False))
                data = _map_corners(data, self._affine)
                world_axes = "".join(self._affine.orientation)
                if world_axes != tgt_axes:
                    perm, flips = get_axis_mapping(world_axes, tgt_axes)
                    data = _permute_corners(data, perm, flips)
            else:
                world_axes = "".join(self._affine.orientation)
                if src_axes != world_axes:
                    perm, flips = get_axis_mapping(src_axes, world_axes)
                    data = _permute_corners(data, perm, flips)
                data = _map_corners(data, self._affine.inverse())
                if tgt_axes != "IJK":
                    perm, _ = get_axis_mapping("IJK", tgt_axes)
                    data = _permute_corners(data, perm, (False, False, False))
        if format.representation is Representation.CENTER_SIZE:
            data = _corners_to_cs(data)
        return self._clone(data=data, format=format)

    def new_like(
        self, *, data: Any, labels: Any = None, affine: Any = None
    ) -> "BoundingBoxes":
        new_affine = AffineMatrix(affine) if affine is not None else self._affine.clone()
        return type(self)(
            data,
            format=self._format,
            labels=labels,
            affine=new_affine,
            metadata=dict(self._metadata),
        )

    def _clone(
        self,
        *,
        data: np.ndarray | None = None,
        format: BoundingBoxFormat | None = None,  # noqa: A002
    ) -> "BoundingBoxes":
        return type(self)(
            self._data.copy() if data is None else data,
            format=format or self._format,
            labels=None if self._labels is None else self._labels.copy(),
            affine=self._affine.clone(),
            metadata=dict(self._metadata),
        )

    # --- Dunder ---

    def __len__(self) -> int:
        return self.num_boxes

    def __repr__(self) -> str:
        return (
            f"BoundingBoxes(num_boxes={self.num_boxes},"
            f" axes={self._format.axes!r},"
            f" representation={self._format.representation.value!r})"
        )

    def __deepcopy__(self, memo: dict) -> "BoundingBoxes":
        new = self._clone()
        memo[id(self)] = new
        return new
