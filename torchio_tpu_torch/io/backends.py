"""Lazy image-data backends and the registry that picks one for a source.

The port's copy of ``torchio_tpu/io/backends.py``: a backend exposes
header-level metadata (``shape``/``affine``/``dtype``) without reading
voxels, reads 4D regions through ``__getitem__`` and materializes with
``to_array()``. Backend data is host numpy; :class:`..data.image.Image`
moves it to its device when it loads. ``CroppedBackend`` and
``PaddedBackend`` are the deferred views of a lazy CropOrPad.

The registry holds the custom-reader, NIfTI (by suffix, then by magic
bytes) and NRRD/MetaImage matchers. The DICOM, remote and ``.nii.zarr``
sources are not ported yet (ROADMAP.md, Queue 1, item 3b): their
matchers raise ``NotImplementedError`` for a source they recognise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Protocol, Union, runtime_checkable

import numpy as np

from .nifti import NiftiFile

TypeIndex = Any
Type4Slices = tuple[slice, slice, slice, slice]


def normalize_index(index: TypeIndex, shape: tuple[int, int, int, int]) -> Type4Slices:
    """Normalize any indexing expression into exactly four slices.

    Integers become single-element slices so axes are never dropped;
    ``Ellipsis`` expands to full slices; missing trailing axes are padded.
    Negative indices and slice steps are resolved against ``shape``.
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


def slices_shape(slices: Type4Slices) -> tuple[int, int, int, int]:
    """Output shape of a normalized 4-slice index."""
    dims = []
    for s in slices:
        step = s.step or 1
        if step > 0:
            n = max(0, (s.stop - s.start + step - 1) // step)
        else:
            n = max(0, (s.stop - s.start + step + 1) // step)
        dims.append(n)
    return (dims[0], dims[1], dims[2], dims[3])


@runtime_checkable
class ImageDataBackend(Protocol):
    """Protocol every lazy data backend implements."""

    @property
    def shape(self) -> tuple[int, int, int, int]:  # (C, I, J, K)
        ...  # pragma: no cover - protocol stub

    @property
    def affine(self) -> np.ndarray:  # float64 (4, 4)
        ...  # pragma: no cover - protocol stub

    @property
    def dtype(self) -> np.dtype:  # on-disk dtype
        ...  # pragma: no cover - protocol stub

    def __getitem__(self, slices: Type4Slices) -> np.ndarray: ...

    def to_array(self) -> np.ndarray: ...


class ArrayBackend:
    """In-memory backend over a (C, I, J, K) numpy array."""

    def __init__(self, data: np.ndarray, affine: np.ndarray | None = None):
        arr = np.asarray(data)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4:
            raise ValueError(f"Backend data must be 3D or 4D, got {arr.shape}")
        self._data = arr
        self._affine = (
            np.eye(4, dtype=np.float64)
            if affine is None
            else np.asarray(affine, dtype=np.float64)
        )

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return self._data.shape  # type: ignore[return-value]

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def dtype(self) -> np.dtype:
        return self._data.dtype

    def __getitem__(self, slices: Type4Slices) -> np.ndarray:
        return np.asarray(self._data[slices])

    def to_array(self) -> np.ndarray:
        return np.asarray(self._data)

    # reference API spelling
    to_tensor = to_array


# Backwards-friendly alias matching the reference name.
TensorBackend = ArrayBackend


class NiftiBackend:
    """Header-only NIfTI backend with memmap/cached region reads."""

    def __init__(self, source: Any):
        self._file = NiftiFile(source)

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return self._file.shape_cijk

    @property
    def affine(self) -> np.ndarray:
        return self._file.affine

    @property
    def dtype(self) -> np.dtype:
        return self._file.dtype

    def __getitem__(self, slices: Type4Slices) -> np.ndarray:
        return self._file.read_region(slices)

    def to_array(self) -> np.ndarray:
        return self._file.read()

    to_tensor = to_array


class CroppedBackend:
    """Deferred crop view over another backend (lazy CropOrPad), as
    TorchIO's ``_CroppedBackend`` in ``transforms/spatial/crop_or_pad.py``."""

    def __init__(self, parent: ImageDataBackend, slices: Type4Slices):
        self._parent = parent
        self._slices = slices
        self._shape = slices_shape(slices)
        affine = np.array(parent.affine, dtype=np.float64)
        corner = np.array([slices[1].start, slices[2].start, slices[3].start], float)
        affine[:3, 3] = affine[:3, :3] @ corner + affine[:3, 3]
        self._affine = affine

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return self._shape

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def dtype(self) -> np.dtype:
        return self._parent.dtype

    def __getitem__(self, slices: Type4Slices) -> np.ndarray:
        composed = []
        for outer, inner in zip(self._slices, slices):
            start = outer.start + inner.start * (outer.step or 1)
            stop = outer.start + inner.stop * (outer.step or 1)
            step = (outer.step or 1) * (inner.step or 1)
            composed.append(slice(start, stop, step))
        return self._parent[(composed[0], composed[1], composed[2], composed[3])]

    def to_array(self) -> np.ndarray:
        return self._parent[self._slices]

    to_tensor = to_array


class PaddedBackend:
    """Deferred pad view over another backend (lazy CropOrPad).

    Only the requested region intersected with the parent's extent is
    read; the rest is filled on the fly.
    """

    def __init__(
        self,
        parent: ImageDataBackend,
        pad_before: tuple[int, int, int],
        pad_after: tuple[int, int, int],
        fill: float = 0.0,
    ):
        self._parent = parent
        self._before = pad_before
        self._after = pad_after
        self._fill = fill
        c, i, j, k = parent.shape
        self._shape = (
            c,
            i + pad_before[0] + pad_after[0],
            j + pad_before[1] + pad_after[1],
            k + pad_before[2] + pad_after[2],
        )
        affine = np.array(parent.affine, dtype=np.float64)
        corner = -np.asarray(pad_before, dtype=np.float64)
        affine[:3, 3] = affine[:3, :3] @ corner + affine[:3, 3]
        self._affine = affine

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return self._shape

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def dtype(self) -> np.dtype:
        return self._parent.dtype

    def __getitem__(self, slices: Type4Slices) -> np.ndarray:
        out_shape = slices_shape(slices)
        out = np.full(out_shape, self._fill, dtype=self._parent.dtype)
        parent_shape = self._parent.shape
        parent_slices = [slices[0]]
        out_slices: list[slice] = [slice(None)]
        for axis in range(3):
            s = slices[axis + 1]
            lo = s.start - self._before[axis]
            hi = s.stop - self._before[axis]
            plo, phi = max(lo, 0), min(hi, parent_shape[axis + 1])
            if plo >= phi:
                return out
            parent_slices.append(slice(plo, phi))
            out_slices.append(slice(plo - lo, phi - lo))
        region = self._parent[tuple(parent_slices)]  # type: ignore[arg-type]
        out[tuple(out_slices)] = region
        return out

    def to_array(self) -> np.ndarray:
        full = normalize_index((), self._shape)
        return self[full]

    to_tensor = to_array


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass
class BackendRequest:
    """What the Image constructor knows about a data source."""

    source: Any
    reader: Callable | None = None
    suffix: str | None = None
    kwargs: dict = field(default_factory=dict)

    @property
    def path(self) -> Path | None:
        if isinstance(self.source, (str, Path)):
            s = str(self.source)
            if "://" not in s or s.startswith("file://"):
                return Path(s.removeprefix("file://"))
        return None


@runtime_checkable
class LazyReader(Protocol):
    """A custom reader that can hand back a lazy backend directly."""

    def get_backend(self, request: BackendRequest) -> ImageDataBackend: ...


TypeMatcher = Callable[[BackendRequest], "ImageDataBackend | None"]

_MATCHERS: list[tuple[str, TypeMatcher]] = []


def register_backend(name: str, matcher: TypeMatcher, *, index: int = 0) -> None:
    """Register a backend matcher. Earlier (lower index) matchers win."""
    _MATCHERS.insert(index, (name, matcher))


def unregister_backend(name: str) -> None:
    """Remove a registered matcher by name."""
    global _MATCHERS
    _MATCHERS = [(n, m) for n, m in _MATCHERS if n != name]


def registered_backends() -> list[str]:
    return [n for n, _ in _MATCHERS]


def resolve_backend(request: BackendRequest) -> ImageDataBackend:
    """Find the first matcher that accepts the request."""
    for name, matcher in _MATCHERS:
        backend = matcher(request)
        if backend is not None:
            # Validate up front: a backend missing a protocol method
            # would otherwise surface later as an AttributeError inside
            # a property, which Image.__getattr__ misreports as the
            # property itself being missing.
            if not isinstance(backend, ImageDataBackend):
                missing = [
                    attr
                    for attr in ("shape", "affine", "dtype", "__getitem__", "to_array")
                    if not hasattr(backend, attr)
                ]
                raise TypeError(
                    f"Backend {type(backend).__name__!r} from matcher"
                    f" {name!r} does not implement ImageDataBackend;"
                    f" missing: {missing}"
                )
            return backend
    raise ValueError(f"No backend can read source: {request.source!r}")


def _match_custom_reader(request: BackendRequest) -> ImageDataBackend | None:
    reader = request.reader
    if reader is None:
        return None
    if isinstance(reader, LazyReader):
        return reader.get_backend(request)
    data, affine = reader(request.source)
    return ArrayBackend(np.asarray(data), np.asarray(affine, dtype=np.float64))


_NIFTI_SUFFIXES = (".nii", ".nii.gz", ".hdr", ".img", ".img.gz")


def _match_nifti(request: BackendRequest) -> ImageDataBackend | None:
    path = request.path
    if path is not None:
        name = path.name.lower()
        if any(name.endswith(s) for s in _NIFTI_SUFFIXES):
            return NiftiBackend(path)
        return None
    if isinstance(request.source, (bytes, bytearray)):
        try:
            return NiftiBackend(bytes(request.source))
        except ValueError:
            return None
    return None


def _match_nifti_sniff(request: BackendRequest) -> ImageDataBackend | None:
    """Fallback: sniff magic bytes for files with unusual suffixes."""
    path = request.path
    if path is None or not path.is_file():
        return None
    try:
        return NiftiBackend(path)
    except (ValueError, OSError):
        return None


_DEFERRED = "is not ported yet (ROADMAP.md, Queue 1, item 3b)"


def _match_zarr(request: BackendRequest) -> ImageDataBackend | None:
    source = request.source
    if isinstance(source, (str, Path)) and str(source).rstrip("/").lower().endswith(".nii.zarr"):
        raise NotImplementedError(f"Reading .nii.zarr stores {_DEFERRED}: {source}")
    if type(source).__module__.startswith("zarr"):
        raise NotImplementedError(f"Reading zarr stores {_DEFERRED}")
    return None


def _match_remote(request: BackendRequest) -> ImageDataBackend | None:
    source = request.source
    if isinstance(source, str) and "://" in source and not source.startswith("file://"):
        raise NotImplementedError(f"Reading remote sources {_DEFERRED}: {source}")
    return None


def _is_dicom(path: Path) -> bool:
    """Whether ``path`` holds the DICM magic at byte 128."""
    try:
        with open(path, "rb") as f:
            f.seek(128)
            return f.read(4) == b"DICM"
    except OSError:
        return False


def _match_dicom(request: BackendRequest) -> ImageDataBackend | None:
    path = request.path
    if path is None:
        return None
    if path.is_dir():
        files = [p for p in list(path.iterdir())[:5] if p.is_file()]
        found = any(_is_dicom(p) for p in files)
    else:
        found = path.suffix.lower() in (".dcm", ".ima") or (path.is_file() and _is_dicom(path))
    if found:
        raise NotImplementedError(f"Reading DICOM {_DEFERRED}: {path}")
    return None


def _match_other_formats(request: BackendRequest) -> ImageDataBackend | None:
    path = request.path
    if path is None:
        return None
    suffix = path.suffix.lower()
    if suffix in (".nrrd", ".nhdr"):
        from .other_formats import read_nrrd

        data, affine = read_nrrd(path)
        return ArrayBackend(data, affine)
    if suffix in (".mha", ".mhd"):
        from .other_formats import read_meta_image

        data, affine = read_meta_image(path)
        return ArrayBackend(data, affine)
    return None


register_backend("nifti-sniff", _match_nifti_sniff)
register_backend("other-formats", _match_other_formats)
register_backend("dicom", _match_dicom)
register_backend("nifti", _match_nifti)
register_backend("remote", _match_remote)
register_backend("zarr", _match_zarr)
register_backend("custom-reader", _match_custom_reader)
