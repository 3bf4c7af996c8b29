"""Image writing, the format chosen by the file's suffix.

The port's copy of ``torchio_tpu/io/write.py``: NIfTI (``.nii``,
``.nii.gz``), NRRD (``.nrrd``, ``.nhdr``), MetaImage (``.mha``, ``.mhd``),
one multi-frame DICOM file (``.dcm``), a DICOM series (a directory, one
file a slice) and ``.nii.zarr`` stores (which need the optional ``zarr``
package). Data may be numpy or a tensor on any device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .nifti import _host_array, write_nifti
from .other_formats import write_meta_image, write_nrrd


def write_nifti_zarr(path, data, affine=None, *, chunks=None) -> None:
    """Write (C, I, J, K) data + RAS affine as a ``.nii.zarr`` store.

    The affine is stored in the array attributes (the layout
    :class:`.remote.ZarrBackend` reads back).
    """
    try:
        import zarr
    except ImportError as e:
        raise ImportError(
            "Writing .nii.zarr requires the 'zarr' package:"
            " pip install zarr"
        ) from e
    arr = _host_array(data)
    if arr.ndim == 3:
        arr = arr[None]
    affine = np.eye(4) if affine is None else np.asarray(_host_array(affine), np.float64)
    store = zarr.open(
        str(path),
        mode="w",
        shape=arr.shape,
        chunks=chunks or (arr.shape[0], 64, 64, 64),
        dtype=arr.dtype,
    )
    store[:] = arr
    store.attrs["affine"] = affine.tolist()


def _write_dcm(path, data, affine=None) -> None:
    from .dicom import write_dicom

    write_dicom(path, data, affine)


_WRITERS = {
    ".nii": write_nifti,
    ".nii.gz": write_nifti,
    ".nrrd": write_nrrd,
    ".nhdr": write_nrrd,
    ".mha": write_meta_image,
    ".mhd": write_meta_image,
    ".nii.zarr": write_nifti_zarr,
    ".dcm": _write_dcm,
}


def supported_write_suffixes() -> tuple[str, ...]:
    return tuple(sorted(_WRITERS))


def write_image(path, data, affine=None) -> None:
    """Write (C, I, J, K) data and its RAS affine, the format chosen by the
    suffix; a directory target (an existing directory, or a path ending in
    a separator) gets a one-file-a-slice DICOM series."""
    raw = str(path)
    name = raw.lower().rstrip("/")
    for suffix in sorted(_WRITERS, key=len, reverse=True):
        if name.endswith(suffix):
            _WRITERS[suffix](Path(path), data, affine)
            return
    if raw.endswith(("/", "\\")) or Path(path).is_dir():
        from .dicom import write_dicom_series

        write_dicom_series(Path(path), data, affine)
        return
    raise ValueError(
        f"Unsupported output format for {path!r}; supported suffixes:"
        f" {', '.join(supported_write_suffixes())} (or a directory for a"
        " DICOM series)"
    )
