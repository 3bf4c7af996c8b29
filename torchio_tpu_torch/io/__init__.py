"""Host I/O: NIfTI-1/2, NRRD, MetaImage, DICOM (series and multi-frame
files, uncompressed, RLE, JPEG Lossless, JPEG-LS, and JPEG/JPEG 2000
through Pillow), remote URIs (fsspec), ``.nii.zarr`` stores, transform
files, and the lazy backends images read through (the port's copy of
``torchio_tpu/io``)."""

from .backends import (
    ArrayBackend,
    BackendRequest,
    CroppedBackend,
    ImageDataBackend,
    LazyReader,
    NiftiBackend,
    PaddedBackend,
    TensorBackend,
    normalize_index,
    register_backend,
    registered_backends,
    resolve_backend,
    unregister_backend,
)
from .matrix import read_matrix, write_matrix
from .nifti import NiftiFile, NiftiHeader, is_nifti, read_header, read_nifti, write_nifti
from .other_formats import read_meta_image, read_nrrd, write_meta_image, write_nrrd
from .write import supported_write_suffixes, write_image, write_nifti_zarr

__all__ = [
    "ArrayBackend",
    "BackendRequest",
    "CroppedBackend",
    "ImageDataBackend",
    "LazyReader",
    "NiftiBackend",
    "NiftiFile",
    "NiftiHeader",
    "PaddedBackend",
    "TensorBackend",
    "is_nifti",
    "normalize_index",
    "read_header",
    "read_matrix",
    "read_meta_image",
    "read_nifti",
    "read_nrrd",
    "register_backend",
    "registered_backends",
    "resolve_backend",
    "supported_write_suffixes",
    "unregister_backend",
    "write_image",
    "write_matrix",
    "write_meta_image",
    "write_nifti",
    "write_nifti_zarr",
    "write_nrrd",
]
