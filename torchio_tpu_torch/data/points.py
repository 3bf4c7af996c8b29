"""(N, 3) landmark sets with a named axis convention.

Counterpart of ``torchio_tpu/data/points.py``. Point sets are tiny
metadata that ride alongside volumes, so they stay host numpy (float32
coordinates, as the JAX package keeps them) with a float64 affine on the
host, on whatever device the images lie.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.affine import AffineMatrix
from ..core.axes import AxesType, axes_type, get_axis_mapping, validate_axes


def host_array(data: Any, dtype) -> np.ndarray:
    """Annotation data as host numpy of ``dtype`` (a tensor on any device
    is copied to the host)."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data, dtype=dtype)


def _permute_flip(data: np.ndarray, perm, flips) -> np.ndarray:
    out = data[:, list(perm)].copy()
    for col, flip in enumerate(flips):
        if flip:
            out[:, col] = -out[:, col]
    return out


class Points:
    """A set of 3D coordinates plus axes string and affine.

    Args:
        data: (N, 3) array of coordinates.
        axes: 3-character axis string; default ``"IJK"`` (voxel indices).
        affine: 4x4 voxel-to-world matrix (identity if omitted).
        metadata: arbitrary dict.
    """

    def __init__(
        self,
        data: Any,
        *,
        axes: str = "IJK",
        affine: Any = None,
        metadata: dict[str, Any] | None = None,
    ) -> None:
        arr = host_array(data, np.float32)
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise ValueError(f"Points must have shape (N, 3), got {arr.shape}")
        self._data = arr
        self._axes = validate_axes(axes)
        self._affine = affine if isinstance(affine, AffineMatrix) else AffineMatrix(affine)
        self._metadata = dict(metadata) if metadata else {}

    # --- Properties ---

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def device(self) -> str:
        """Placement of the point data ("cpu": annotations stay on host)."""
        return "cpu"

    @property
    def axes(self) -> str:
        return self._axes

    @property
    def affine(self) -> AffineMatrix:
        return self._affine

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def num_points(self) -> int:
        return int(self._data.shape[0])

    def to(self, *args: Any, **kwargs: Any) -> "Points":
        """No-op: point data is host metadata."""
        return self

    # --- Conversions ---

    def to_world(self) -> np.ndarray:
        """Points mapped through the affine into world mm (float32)."""
        return self._affine.apply(self._data).astype(np.float32)

    def to_axes(self, target: str) -> "Points":
        """Return a new :class:`Points` in the target axis convention."""
        target = validate_axes(target)
        if target == self._axes:
            return self._clone(axes=target)
        src_type, tgt_type = axes_type(self._axes), axes_type(target)
        if src_type == tgt_type:
            perm, flips = get_axis_mapping(self._axes, target)
            converted = _permute_flip(self._data, perm, flips)
        elif src_type is AxesType.VOXEL:
            data = self._data
            if self._axes != "IJK":
                perm, _ = get_axis_mapping(self._axes, "IJK")
                data = data[:, list(perm)]
            world = self._affine.apply(data).astype(np.float32)
            world_axes = "".join(self._affine.orientation)
            if world_axes != target:
                perm, flips = get_axis_mapping(world_axes, target)
                world = _permute_flip(world, perm, flips)
            converted = world
        else:
            data = self._data
            world_axes = "".join(self._affine.orientation)
            if self._axes != world_axes:
                perm, flips = get_axis_mapping(self._axes, world_axes)
                data = _permute_flip(data, perm, flips)
            ijk = self._affine.inverse().apply(data).astype(np.float32)
            if target != "IJK":
                perm, _ = get_axis_mapping("IJK", target)
                ijk = ijk[:, list(perm)]
            converted = ijk
        return self._clone(data=converted, axes=target)

    def new_like(self, *, data: Any, affine: Any = None) -> "Points":
        """New Points with the same axes/metadata and given data."""
        new_affine = AffineMatrix(affine) if affine is not None else self._affine.clone()
        return type(self)(
            data, axes=self._axes, affine=new_affine, metadata=dict(self._metadata)
        )

    def _clone(self, *, data: np.ndarray | None = None, axes: str | None = None) -> "Points":
        return type(self)(
            self._data.copy() if data is None else data,
            axes=axes or self._axes,
            affine=self._affine.clone(),
            metadata=dict(self._metadata),
        )

    # --- Dunder ---

    def __len__(self) -> int:
        return self.num_points

    def __repr__(self) -> str:
        return f"Points(num_points={self.num_points}, axes={self._axes!r})"

    def __deepcopy__(self, memo: dict) -> "Points":
        new = self._clone()
        memo[id(self)] = new
        return new
