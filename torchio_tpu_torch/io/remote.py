"""Remote sources (through ``fsspec``) and NIfTI-Zarr stores.

The port's copy of ``torchio_tpu/io/remote.py``: any ``scheme://`` URI
(http, s3, gs, memory, ...) and an fsspec ``OpenFile`` are fetched into a
temporary local file, which the registry then reads; a ``.nii.zarr``
store, local or remote, is read through :class:`ZarrBackend`, chunk by
chunk for a region. ``fsspec`` and ``zarr`` are optional and imported
where they are used; without ``zarr`` the backend raises an
``ImportError`` that says what to install.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Any

import numpy as np


def is_remote(source: Any) -> bool:
    """Any ``scheme://`` URI counts as remote: http, s3, gs, az, memory
    and the rest all go through fsspec, not an allow-list."""
    return isinstance(source, str) and "://" in source


def is_nifti_zarr(source: Any) -> bool:
    if not isinstance(source, (str, Path)):
        return False
    return str(source).rstrip("/").endswith((".nii.zarr", ".ome.zarr"))


def is_remote_nifti_zarr(source: Any) -> bool:
    return is_remote(source) and is_nifti_zarr(source)


def _fetch_remote(uri: str, suffix: str | None = None) -> Path:
    """Download a remote URI to a temp file via fsspec."""
    import fsspec

    if suffix is None:
        name = uri.split("?")[0].rstrip("/").split("/")[-1]
        suffix = "".join(Path(name).suffixes) or ".nii.gz"
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)  # noqa: SIM115
    with fsspec.open(uri, "rb") as src:
        tmp.write(src.read())
    tmp.close()
    return Path(tmp.name)


def resolve_source(source: Any, suffix: str | None = None) -> Path:
    """Local path / remote URI / fsspec OpenFile / file-like -> local Path."""
    if isinstance(source, Path):
        return source
    if isinstance(source, str):
        if is_remote(source):
            return _fetch_remote(source, suffix)
        return Path(source)
    if hasattr(source, "open") and hasattr(source, "path"):  # fsspec OpenFile
        with source.open() as f:
            data = f.read()
        tmp = tempfile.NamedTemporaryFile(
            suffix=suffix or ".nii.gz", delete=False
        )  # noqa: SIM115
        tmp.write(data)
        tmp.close()
        return Path(tmp.name)
    raise TypeError(f"Cannot resolve source of type {type(source)}")


class ZarrBackend:
    """Chunked (possibly remote) NIfTI-Zarr backend (needs ``zarr``).

    The affine comes from the store's ``affine`` attribute (identity
    without one); region reads fetch only the chunks they overlap.
    """

    def __init__(self, source: Any):
        try:
            import zarr  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Reading .nii.zarr requires the 'zarr' package:"
                " pip install zarr niizarr"
            ) from e
        import zarr

        self._store = zarr.open(source, mode="r")
        arrays = (
            [self._store] if hasattr(self._store, "shape") else list(self._store.values())
        )
        self._array = arrays[0]
        shape = tuple(self._array.shape)
        if len(shape) == 3:
            self._cijk = (1,) + shape
            self._has_channel = False
        else:
            self._cijk = (shape[-4] if len(shape) >= 4 else 1,) + shape[-3:]
            self._has_channel = True
        attrs = dict(getattr(self._store, "attrs", {}) or {})
        affine = attrs.get("affine")
        self._affine = (
            np.asarray(affine, np.float64) if affine is not None else np.eye(4)
        )

    @property
    def shape(self):
        return self._cijk

    @property
    def affine(self):
        return self._affine

    @property
    def dtype(self):
        return self._array.dtype

    def __getitem__(self, slices):
        sc, si, sj, sk = slices
        if self._has_channel:
            region = self._array[..., sc, si, sj, sk]
            return np.asarray(region).reshape(-1, *np.asarray(region).shape[-3:])
        return np.asarray(self._array[si, sj, sk])[None][sc]

    def to_array(self):
        arr = np.asarray(self._array)
        if arr.ndim == 3:
            return arr[None]
        return arr.reshape(-1, *arr.shape[-3:])

    to_tensor = to_array
