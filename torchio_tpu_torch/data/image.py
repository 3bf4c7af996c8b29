"""Image containers: (C, I, J, K) tensor + RAS+ affine, lazy for files.

Counterpart of ``torchio_tpu/data/image.py``. An image is built from a
numpy array or a torch tensor, from a path (NIfTI, NRRD, MetaImage),
from ``bytes``/``BytesIO`` or a file object holding an encoded file, or
from a lazy backend (:mod:`..io.backends`). A tensor stays on the device
it was given on; host data (numpy, lists) goes to the package's default
device (:func:`..config.default_device`, ``cuda`` unless a caller asks
for the CPU), as the JAX package puts host data on its default device at
the batch boundary.

A file stays on disk until its voxels are used: ``shape``,
``spatial_shape``, ``affine`` and ``dtype`` come from the header alone,
``image[i0:i1, ...]`` reads only that region, and :meth:`Image.load`
(which ``data`` calls) decodes on the host and moves the tensor to the
default device. :meth:`Image.unload` drops the tensor of an image that
can be read again. ``to(device)`` moves the data; ``numpy()`` copies it
to the host.
"""

from __future__ import annotations

import copy as _copy
import io as _stdio
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from .. import config
from ..config import as_tensor
from ..core.affine import AffineMatrix
from ..io.backends import (
    ArrayBackend,
    BackendRequest,
    ImageDataBackend,
    normalize_index,
    resolve_backend,
)
from .bboxes import BoundingBoxes
from .invertible import Invertible
from .points import Points

__all__ = ["Image", "LabelMap", "ScalarImage", "normalize_index"]


def _host_tensor(array: np.ndarray) -> torch.Tensor:
    """A host array (a read-only memmap window too) as a tensor on the
    default device."""
    array = np.asarray(array)
    if not array.flags.writeable or not array.dtype.isnative:
        array = np.array(array, dtype=array.dtype.newbyteorder("="))
    return torch.from_numpy(array).to(config.default_device())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype).newbyteorder("="))).dtype


class Image(Invertible):
    """3D/4D medical image: (C, I, J, K) data + RAS+ affine.

    Args:
        source: ``None`` (empty), a numpy array or torch tensor ((I, J,
            K) or (C, I, J, K)), a path, ``bytes``/``BytesIO`` or a file
            object holding an encoded file, or an
            :class:`~..io.backends.ImageDataBackend`.
        reader: callable ``path -> (data_cijk, affine)`` or a
            :class:`~..io.backends.LazyReader`.
        reader_kwargs: kept with the request the reader gets.
        affine: 4x4 voxel-to-world matrix; overrides the file's (identity
            for an array when omitted).
        channels_last: input array is (I, J, K, C) and is permuted.
        suffix: filename suffix hint for bytes/file-like sources.
        points: named :class:`Points` annotations attached to the image.
        bounding_boxes: named :class:`BoundingBoxes` annotations.
        **kwargs: arbitrary metadata (attribute- and key-accessible).
    """

    #: Source types accepted by the constructor (the documented alias of
    #: the reference's ``Image.ImageInput``; dispatch is duck-typed).
    ImageInput = object

    def __init__(
        self,
        source: Any = None,
        *,
        reader: Callable | None = None,
        reader_kwargs: dict[str, Any] | None = None,
        affine: Any = None,
        channels_last: bool = False,
        suffix: str | None = None,
        points: dict[str, Points] | None = None,
        bounding_boxes: dict[str, BoundingBoxes] | None = None,
        **kwargs: Any,
    ) -> None:
        self._reader = reader
        self._reader_kwargs = dict(reader_kwargs or {})
        self._suffix = suffix
        self._metadata: dict[str, Any] = dict(kwargs)
        self._data: torch.Tensor | None = None
        self._backend: ImageDataBackend | None = None
        self._path: Path | None = None
        self._uri: str | None = None
        self._affine: AffineMatrix | None = None
        if affine is not None:
            self._affine = (
                affine.clone() if isinstance(affine, AffineMatrix) else AffineMatrix(affine)
            )
        self._points: dict[str, Points] = dict(points or {})
        self._bounding_boxes: dict[str, BoundingBoxes] = dict(bounding_boxes or {})
        self.applied_transforms: list[Any] = []

        if source is None:
            pass
        elif isinstance(source, (torch.Tensor, np.ndarray, list, tuple)):
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
            if self._affine is None:
                self._affine = AffineMatrix()
        elif isinstance(source, (bytes, bytearray, _stdio.BytesIO)):
            raw = source.getvalue() if isinstance(source, _stdio.BytesIO) else bytes(source)
            self._backend = self._resolve(raw)
        elif isinstance(source, str) and "://" in source and not source.startswith("file://"):
            self._uri = source  # fetched by the registry's remote matcher on first use
        elif isinstance(source, (str, Path)):
            self._path = Path(str(source).removeprefix("file://"))
        elif hasattr(source, "read"):
            self._backend = self._resolve(source.read())
        elif isinstance(source, ImageDataBackend):
            self._backend = source
        else:
            raise ValueError(f"Unsupported Image source type: {type(source)}")

    # --- Lazy machinery ---

    def _resolve(self, source: Any) -> ImageDataBackend:
        return resolve_backend(
            BackendRequest(
                source=source,
                reader=self._reader,
                suffix=self._suffix,
                kwargs=self._reader_kwargs,
            )
        )

    def _ensure_backend(self) -> ImageDataBackend:
        if self._backend is None:
            if self._data is not None:
                # loaded from memory: a host view on demand
                return ArrayBackend(self.numpy(), self.affine.data)
            source = self._uri if self._uri is not None else self._path
            if source is None:
                raise RuntimeError("Image has no data: construct with a source or call set_data()")
            self._backend = self._resolve(source)
        return self._backend

    def load(self) -> None:
        """Read the voxels (on the host, through the backend) and move them
        to the default device; nothing to do once loaded."""
        if self._data is not None:
            return
        backend = self._ensure_backend()
        self._data = _host_tensor(backend.to_array())
        if self._affine is None:
            self._affine = AffineMatrix(backend.affine)
        if self._path is not None or self._uri is not None:
            # the header is read again if needed; a decoded file's cache goes
            self._backend = None

    def unload(self) -> None:
        """Drop the voxels of an image that can be read again (from its
        file or its backend); an image built from memory keeps them."""
        if self._path is None and self._uri is None and self._backend is None:
            return
        self._data = None

    # --- Properties ---

    @property
    def path(self) -> Path | None:
        return self._path

    @property
    def is_loaded(self) -> bool:
        return self._data is not None

    @property
    def dataobj(self) -> ImageDataBackend:
        """The lazy backend (header metadata + region reads); a host view
        of the data for an image built from memory."""
        return self._ensure_backend()

    @property
    def data(self) -> torch.Tensor:
        """Voxel data (C, I, J, K); :meth:`load` runs first when lazy."""
        self.load()
        return self._data  # type: ignore[return-value]

    @data.setter
    def data(self, value: Any) -> None:
        self.set_data(value)

    @property
    def affine(self) -> AffineMatrix:
        if self._affine is None:
            self._affine = AffineMatrix(self._ensure_backend().affine)
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
        if self._data is not None:
            return tuple(self._data.shape)  # type: ignore[return-value]
        return tuple(self._ensure_backend().shape)  # type: ignore[return-value]

    @property
    def spatial_shape(self) -> tuple[int, int, int]:
        return self.shape[1:]

    @property
    def num_channels(self) -> int:
        return self.shape[0]

    @property
    def spacing(self) -> tuple[float, float, float]:
        return self.affine.spacing

    @property
    def origin(self) -> tuple[float, float, float]:
        return self.affine.origin

    @property
    def orientation(self) -> tuple[str, str, str]:
        return self.affine.orientation

    @property
    def memory(self) -> int:
        """Bytes of the data once loaded: the elements of ``shape`` times
        the element size (from the header's dtype while the image is
        lazy, without reading the voxels)."""
        n = 1
        for d in self.shape:
            n *= d
        if self._data is not None:
            return n * self._data.element_size()
        return n * np.dtype(self._ensure_backend().dtype).itemsize

    @property
    def dtype(self) -> torch.dtype:
        if self._data is not None:
            return self._data.dtype
        return _torch_dtype(self._ensure_backend().dtype)

    @property
    def device(self) -> torch.device | None:
        """The data's device, or None while the image is not loaded."""
        return None if self._data is None else self._data.device

    # --- Mutation ---

    def set_data(self, value: Any) -> None:
        """Replace voxel data (keeps the current affine); the image no
        longer reads from its source."""
        data = as_tensor(value)
        if data.ndim == 3:
            data = data[None]
        if data.ndim != 4:
            raise ValueError(f"Image data must be 3D or 4D, got shape {tuple(data.shape)}")
        if self._affine is None:
            self._affine = AffineMatrix()
        self._data = data
        self._backend = None
        self._path = None
        self._uri = None

    def to(self, device: Any = None, dtype: Any = None) -> "Image":
        """Move (and optionally cast) the data; returns ``self``."""
        self._data = self.data.to(device=device, dtype=dtype)
        return self

    def numpy(self) -> np.ndarray:
        """Data as host numpy."""
        return self.data.detach().cpu().numpy()

    def new_like(self, *, data: Any = None, affine: Any = None, **kwargs: Any) -> "Image":
        """New image of the same class sharing metadata; annotations copied."""
        new_data = self.data if data is None else data
        new_affine = self.affine if affine is None else affine
        meta = dict(self._metadata)
        meta.update(kwargs)
        return type(self)(
            new_data,
            affine=AffineMatrix(new_affine),
            points={k: _copy.deepcopy(v) for k, v in self._points.items()},
            bounding_boxes={k: _copy.deepcopy(v) for k, v in self._bounding_boxes.items()},
            **meta,
        )

    def save(self, path: str | Path) -> None:
        """Write to disk, the format chosen by the suffix (``.nii``,
        ``.nii.gz``, ``.nrrd``, ``.nhdr``, ``.mha``, ``.mhd``)."""
        from ..io.write import write_image

        write_image(path, self.numpy(), self.affine.data)

    # --- Visualization hooks ---

    def plot(self, **kwargs: Any) -> Any:
        """Three-plane slice plot (see :mod:`torchio_tpu_torch.visualization`)."""
        from ..visualization import plot_image

        return plot_image(self, **kwargs)

    def to_gif(self, output_path: str | Path, **kwargs: Any) -> Path:
        """Save a slice-sweep animated GIF."""
        from ..visualization import make_gif

        return make_gif(self, output_path, **kwargs)

    def to_video(self, output_path: str | Path, **kwargs: Any) -> Path:
        """Save a slice-sweep MP4 (needs the ffmpeg binary)."""
        from ..visualization import make_video

        return make_video(self, output_path, **kwargs)

    def plot_interactive(self, *, height: int = 300) -> Any:
        """Interactive NiiVue viewer in Jupyter (requires ipyniivue)."""
        import tempfile

        from ..external.imports import get_ipyniivue

        ipyniivue = get_ipyniivue()
        tmp = tempfile.NamedTemporaryFile(suffix=".nii.gz", delete=False)  # noqa: SIM115
        tmp.close()
        self.save(tmp.name)
        viewer = ipyniivue.NiiVue(height=height)
        viewer.load_volumes([{"path": tmp.name}])
        return viewer

    def _repr_html_(self) -> str:
        from ..repr_html import image_repr_html

        return image_repr_html(self)

    # --- Metadata access and region reads ---

    def __getitem__(self, index: Any) -> Any:
        """A string reads metadata. Anything else reads a region: a new
        image of the same class, with no axis dropped and the affine
        origin moved (in float64) to the region's corner. A loaded image
        gives a view of its data, on its device; a lazy one reads only the
        region through its backend."""
        if isinstance(index, str):
            return self._metadata[index]
        if self._data is not None:
            slices = normalize_index(index, self.shape)
            region = self._data[slices]
        else:
            backend = self._ensure_backend()
            slices = normalize_index(index, backend.shape)
            region = _host_tensor(backend[slices])
        corner = np.array([slices[1].start, slices[2].start, slices[3].start])
        aff = np.array(self.affine.data)
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
        """Deep copy; an unloaded image stays unloaded (backends are
        read-only views, shared)."""
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        new._reader = self._reader
        new._reader_kwargs = dict(self._reader_kwargs)
        new._suffix = self._suffix
        new._data = None if self._data is None else self._data.clone()
        new._backend = self._backend
        new._path = self._path
        new._uri = self._uri
        new._affine = None if self._affine is None else self._affine.clone()
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
        if self._data is None and self._backend is None and self._path is None and self._uri is None:
            return f"{type(self).__name__}(empty)"
        where = f"device: {self.device}" if self.is_loaded else "lazy"
        return (
            f"{type(self).__name__}(shape: {self.shape}; spacing:"
            f" ({', '.join(f'{s:.2f}' for s in self.spacing)});"
            f" orientation: {''.join(self.orientation)}+;"
            f" dtype: {self.dtype}; {where})"
        )


class ScalarImage(Image):
    """Intensity image (MRI, CT, ...). Interpolated smoothly by transforms."""


class LabelMap(Image):
    """Discrete segmentation. Transforms use nearest interpolation and skip
    intensity modifications."""
