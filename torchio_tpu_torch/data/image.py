"""In-memory image containers: (C, I, J, K) tensor + RAS+ affine.

Counterpart of ``torchio_tpu/data/image.py``, without file I/O: an image
is built from a numpy array or a torch tensor. A tensor stays on the
device it was given on; host data (numpy, lists) goes to the package's
default device (:func:`..config.default_device`, ``cuda`` unless a
caller asks for the CPU), as the JAX package puts host data on its
default device at the batch boundary. ``to(device)`` moves the data;
``numpy()`` copies it to the host. ``image[i0:i1, ...]`` reads a region
(the patch samplers slice with it): a view on the data's device, no axis
dropped, the origin moved to the region's corner.
"""

from __future__ import annotations

import copy as _copy
from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from ..core.affine import AffineMatrix
from .bboxes import BoundingBoxes
from .invertible import Invertible
from .points import Points


Type4Slices = tuple[slice, slice, slice, slice]


def normalize_index(index: Any, shape: tuple[int, int, int, int]) -> Type4Slices:
    """Normalize any indexing expression into exactly four slices.

    Integers become single-element slices so axes are never dropped;
    ``Ellipsis`` expands to full slices; missing trailing axes are padded.
    Negative indices and slice steps are resolved against ``shape``. (The
    port's copy of ``torchio_tpu/io/backends.py::normalize_index``.)
    """
    if not isinstance(index, tuple):
        index = (index,)
    if index.count(Ellipsis) > 1:
        raise IndexError("An index can only have a single ellipsis")
    items: list[Any] = []
    if Ellipsis in index:
        pos = index.index(Ellipsis)
        explicit = len(index) - 1
        fill = 4 - explicit
        items.extend(index[:pos])
        items.extend([slice(None)] * fill)
        items.extend(index[pos + 1 :])
    else:
        items = list(index)
    if len(items) > 4:
        raise IndexError(f"Too many indices for 4D image data: {len(items)}")
    items.extend([slice(None)] * (4 - len(items)))
    out: list[slice] = []
    for axis, item in enumerate(items):
        size = shape[axis]
        if isinstance(item, (int, np.integer)):
            i = int(item)
            if i < 0:
                i += size
            if not 0 <= i < size:
                raise IndexError(
                    f"Index {item} out of range for axis {axis} with size {size}"
                )
            out.append(slice(i, i + 1, 1))
        elif isinstance(item, slice):
            out.append(slice(*item.indices(size)))
        else:
            raise IndexError(f"Unsupported index type for lazy images: {type(item)}")
    return (out[0], out[1], out[2], out[3])


class Image(Invertible):
    """3D/4D medical image: (C, I, J, K) data + RAS+ affine.

    Args:
        source: a numpy array or torch tensor, (I, J, K) or (C, I, J, K).
        affine: 4x4 voxel-to-world matrix (identity when omitted).
        channels_last: input array is (I, J, K, C) and is permuted.
        points: named :class:`Points` annotations attached to the image.
        bounding_boxes: named :class:`BoundingBoxes` annotations.
        **kwargs: arbitrary metadata (attribute- and key-accessible).
    """

    def __init__(
        self,
        source: Any,
        *,
        affine: Any = None,
        channels_last: bool = False,
        points: dict[str, Points] | None = None,
        bounding_boxes: dict[str, BoundingBoxes] | None = None,
        **kwargs: Any,
    ) -> None:
        data = as_tensor(source)
        if data.ndim == 3:
            data = data[None]
        elif channels_last:
            data = torch.movedim(data, -1, 0)
        if data.ndim != 4:
            raise ValueError(
                f"Image data must be 3D or 4D (C, I, J, K), got {tuple(data.shape)}"
            )
        self._data = data
        self._affine = (
            affine.clone() if isinstance(affine, AffineMatrix) else AffineMatrix(affine)
        )
        self._metadata: dict[str, Any] = dict(kwargs)
        self._points: dict[str, Points] = dict(points or {})
        self._bounding_boxes: dict[str, BoundingBoxes] = dict(bounding_boxes or {})
        self.applied_transforms: list[Any] = []

    # --- Properties ---

    @property
    def data(self) -> torch.Tensor:
        """Voxel data (C, I, J, K)."""
        return self._data

    @data.setter
    def data(self, value: Any) -> None:
        self.set_data(value)

    @property
    def affine(self) -> AffineMatrix:
        return self._affine

    @affine.setter
    def affine(self, value: Any) -> None:
        self._affine = value if isinstance(value, AffineMatrix) else AffineMatrix(value)

    @property
    def metadata(self) -> dict[str, Any]:
        return self._metadata

    @property
    def points(self) -> dict[str, Points]:
        return self._points

    @property
    def bounding_boxes(self) -> dict[str, BoundingBoxes]:
        return self._bounding_boxes

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return tuple(self._data.shape)  # type: ignore[return-value]

    @property
    def spatial_shape(self) -> tuple[int, int, int]:
        return self.shape[1:]

    @property
    def num_channels(self) -> int:
        return self.shape[0]

    @property
    def spacing(self) -> tuple[float, float, float]:
        return self._affine.spacing

    @property
    def origin(self) -> tuple[float, float, float]:
        return self._affine.origin

    @property
    def orientation(self) -> tuple[str, str, str]:
        return self._affine.orientation

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._data.device

    # --- Mutation ---

    def set_data(self, value: Any) -> None:
        """Replace voxel data (keeps the current affine)."""
        data = as_tensor(value)
        if data.ndim == 3:
            data = data[None]
        if data.ndim != 4:
            raise ValueError(f"Image data must be 3D or 4D, got shape {tuple(data.shape)}")
        self._data = data

    def to(self, device: Any = None, dtype: Any = None) -> "Image":
        """Move (and optionally cast) the data; returns ``self``."""
        self._data = self._data.to(device=device, dtype=dtype)
        return self

    def numpy(self) -> np.ndarray:
        """Data as host numpy."""
        return self._data.detach().cpu().numpy()

    def load(self) -> None:
        """Nothing to read: the port holds its data in memory (the JAX
        package's lazy file backends are not ported)."""

    def unload(self) -> None:
        """Nothing to drop: an in-memory image cannot be read again."""

    def new_like(self, *, data: Any = None, affine: Any = None, **kwargs: Any) -> "Image":
        """New image of the same class sharing metadata; annotations copied."""
        new_data = self._data if data is None else data
        new_affine = self._affine if affine is None else affine
        meta = dict(self._metadata)
        meta.update(kwargs)
        return type(self)(
            new_data,
            affine=AffineMatrix(new_affine),
            points={k: _copy.deepcopy(v) for k, v in self._points.items()},
            bounding_boxes={k: _copy.deepcopy(v) for k, v in self._bounding_boxes.items()},
            **meta,
        )

    # --- Metadata access and region reads ---

    def __getitem__(self, index: Any) -> Any:
        """A string reads metadata. Anything else reads a region: a new
        image of the same class whose data is a view of this one's, on
        its device, with no axis dropped and the affine origin moved (in
        float64) to the region's corner."""
        if isinstance(index, str):
            return self._metadata[index]
        slices = normalize_index(index, self.shape)
        region = self._data[slices]
        corner = np.array([slices[1].start, slices[2].start, slices[3].start])
        aff = np.array(self._affine.data)
        aff[:3, 3] = aff[:3, :3] @ corner.astype(np.float64) + aff[:3, 3]
        return self.new_like(data=region, affine=aff)

    def __setitem__(self, key: str, value: Any) -> None:
        self._metadata[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._metadata

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self.__dict__.get("_metadata", {})
        if name in meta:
            return meta[name]
        raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

    # --- Copy ---

    def __deepcopy__(self, memo: dict) -> "Image":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        new._data = self._data.clone()
        new._affine = self._affine.clone()
        new._metadata = _copy.deepcopy(self._metadata, memo)
        new._points = {k: _copy.deepcopy(v, memo) for k, v in self._points.items()}
        new._bounding_boxes = {
            k: _copy.deepcopy(v, memo) for k, v in self._bounding_boxes.items()
        }
        new.applied_transforms = list(self.applied_transforms)
        return new

    def __copy__(self) -> "Image":
        return self.__deepcopy__({})

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape: {self.shape}; spacing:"
            f" ({', '.join(f'{s:.2f}' for s in self.spacing)});"
            f" orientation: {''.join(self.orientation)}+;"
            f" dtype: {self.dtype}; device: {self.device})"
        )


class ScalarImage(Image):
    """Intensity image (MRI, CT, ...). Interpolated smoothly by transforms."""


class LabelMap(Image):
    """Discrete segmentation. Transforms use nearest interpolation and skip
    intensity modifications."""
