"""In-memory image containers: (C, I, J, K) tensor + RAS+ affine.

Counterpart of ``torchio_tpu/data/image.py``, without file I/O: an image
is built from a numpy array or a torch tensor. A tensor stays on the
device it was given on; host data (numpy, lists) goes to the package's
default device (:func:`..config.default_device`, ``cuda`` unless a
caller asks for the CPU), as the JAX package puts host data on its
default device at the batch boundary. ``to(device)`` moves the data;
``numpy()`` copies it to the host.
"""

from __future__ import annotations

import copy as _copy
from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from ..core.affine import AffineMatrix
from .invertible import Invertible


class Image(Invertible):
    """3D/4D medical image: (C, I, J, K) data + RAS+ affine.

    Args:
        source: a numpy array or torch tensor, (I, J, K) or (C, I, J, K).
        affine: 4x4 voxel-to-world matrix (identity when omitted).
        channels_last: input array is (I, J, K, C) and is permuted.
        **kwargs: arbitrary metadata (attribute- and key-accessible).
    """

    def __init__(
        self,
        source: Any,
        *,
        affine: Any = None,
        channels_last: bool = False,
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

    # --- Metadata access ---

    def __getitem__(self, key: str) -> Any:
        return self._metadata[key]

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
