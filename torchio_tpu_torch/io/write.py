"""Image writing, the format chosen by the file's suffix.

The port's copy of ``torchio_tpu/io/write.py``: NIfTI (``.nii``,
``.nii.gz``), NRRD (``.nrrd``, ``.nhdr``) and MetaImage (``.mha``,
``.mhd``). DICOM (``.dcm`` and series directories) and ``.nii.zarr``
are not ported yet (ROADMAP.md, Queue 1, item 3b) and raise
``NotImplementedError``.
"""

from __future__ import annotations

from pathlib import Path

from .nifti import write_nifti
from .other_formats import write_meta_image, write_nrrd

_DEFERRED = ".dcm", ".nii.zarr"

_WRITERS = {
    ".nii": write_nifti,
    ".nii.gz": write_nifti,
    ".nrrd": write_nrrd,
    ".nhdr": write_nrrd,
    ".mha": write_meta_image,
    ".mhd": write_meta_image,
}


def supported_write_suffixes() -> tuple[str, ...]:
    return tuple(sorted(_WRITERS))


def write_image(path, data, affine=None) -> None:
    """Write (C, I, J, K) data (numpy or a tensor on any device) and its
    RAS affine; the format is chosen by the suffix."""
    raw = str(path)
    name = raw.lower().rstrip("/")
    for suffix in sorted(_WRITERS, key=len, reverse=True):
        if name.endswith(suffix):
            _WRITERS[suffix](Path(path), data, affine)
            return
    if name.endswith(_DEFERRED) or raw.endswith(("/", "\\")) or Path(path).is_dir():
        raise NotImplementedError(
            f"Writing {path!r} needs DICOM or zarr output, which is not ported yet"
            " (ROADMAP.md, Queue 1, item 3b)"
        )
    raise ValueError(
        f"Unsupported output format for {path!r}; supported suffixes:"
        f" {', '.join(supported_write_suffixes())}"
    )
