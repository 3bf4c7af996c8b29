"""NIfTI-1/NIfTI-2 reader and writer on the host (numpy, no nibabel).

The port's copy of ``torchio_tpu/io/nifti.py``, read for read and byte
for byte: the same header parsing (both versions, both byte orders,
sform before qform before pixdim, ``scl_slope``/``scl_inter``), the same
canonical (C, I, J, K) layout and the same NIfTI-1 writer. Voxels stay
numpy here; :class:`..data.image.Image` turns them into a tensor on its
device. The decode goes through the package's native library
(:mod:`..native`): a gzipped file or buffer is inflated by
``native.gunzip`` into a buffer of the size the header gives, a 3D
volume leaves its Fortran order by ``native.f2c_transpose``, and a
big-endian one is swapped by ``native.byteswap_inplace``.

- Header-only parsing (shape/dtype/affine) without touching voxel data.
- Region reads: ``np.memmap`` windows for uncompressed ``.nii``; a
  gzipped file is inflated once on first data access and cached.
"""

from __future__ import annotations

import gzip
import io as _stdio
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO, Union

import numpy as np

from .. import native

TypeSource = Union[str, Path, bytes, BinaryIO]

# NIfTI datatype codes <-> numpy dtypes.
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
    1536: np.longdouble,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_NIFTI1_HDR_SIZE = 348
_NIFTI2_HDR_SIZE = 540


@dataclass
class NiftiHeader:
    """Parsed NIfTI header metadata (no voxel data)."""

    shape: tuple[int, ...]  # on-disk dims, e.g. (I, J, K) or (I, J, K, T)
    dtype: np.dtype
    affine: np.ndarray  # float64 (4, 4), RAS+ voxel->world
    vox_offset: int
    scl_slope: float
    scl_inter: float
    byteorder: str  # '<' or '>'
    version: int  # 1 or 2
    pixdim: tuple[float, ...]

    @property
    def needs_scaling(self) -> bool:
        slope, inter = self.scl_slope, self.scl_inter
        if slope == 0 or np.isnan(slope):
            return False
        return not (slope == 1.0 and inter == 0.0)

    @property
    def spatial_shape(self) -> tuple[int, int, int]:
        s = self.shape
        return (s[0], s[1] if len(s) > 1 else 1, s[2] if len(s) > 2 else 1)

    @property
    def num_channels(self) -> int:
        extra = 1
        for d in self.shape[3:]:
            extra *= d
        return extra


def _host_array(x: Any) -> np.ndarray:
    """numpy as it is; a tensor (any device) or an AffineMatrix to host
    numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "data") and not isinstance(x, np.ndarray):
        return np.asarray(x.data)
    return np.asarray(x)


def _quaternion_to_affine(
    b: float, c: float, d: float, qfac: float,
    pixdim: tuple[float, ...], offsets: tuple[float, float, float],
) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    r = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ],
        dtype=np.float64,
    )
    zooms = np.array([pixdim[0], pixdim[1], pixdim[2] * (qfac if qfac != 0 else 1.0)])
    aff = np.eye(4, dtype=np.float64)
    aff[:3, :3] = r * zooms
    aff[:3, 3] = offsets
    return aff


def parse_header(raw: bytes) -> NiftiHeader:
    """Parse the first bytes of a NIfTI file into a :class:`NiftiHeader`."""
    if len(raw) < _NIFTI1_HDR_SIZE:
        raise ValueError("File too small to hold a NIfTI header")
    sizeof_hdr_le = struct.unpack("<i", raw[:4])[0]
    if sizeof_hdr_le == _NIFTI1_HDR_SIZE:
        bo, version = "<", 1
    elif sizeof_hdr_le == _NIFTI2_HDR_SIZE:
        bo, version = "<", 2
    else:
        sizeof_hdr_be = struct.unpack(">i", raw[:4])[0]
        if sizeof_hdr_be == _NIFTI1_HDR_SIZE:
            bo, version = ">", 1
        elif sizeof_hdr_be == _NIFTI2_HDR_SIZE:
            bo, version = ">", 2
        else:
            raise ValueError("Not a NIfTI file (bad sizeof_hdr)")
    if version == 1:
        return _parse_nifti1(raw, bo)
    return _parse_nifti2(raw, bo)


def _parse_nifti1(raw: bytes, bo: str) -> NiftiHeader:
    u = lambda fmt, off: struct.unpack_from(bo + fmt, raw, off)  # noqa: E731
    dim = u("8h", 40)
    ndim = int(dim[0])
    shape = tuple(max(int(d), 1) for d in dim[1 : 1 + max(ndim, 3)])
    datatype = u("h", 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    pixdim = u("8f", 76)
    vox_offset = int(u("f", 108)[0])
    scl_slope, scl_inter = u("2f", 112)
    qform_code, sform_code = u("h", 252)[0], u("h", 254)[0]
    quatern = u("6f", 256)  # b, c, d, qoffset_x, qoffset_y, qoffset_z
    srow = np.array(u("12f", 280), dtype=np.float64).reshape(3, 4)
    if sform_code > 0:
        affine = np.eye(4, dtype=np.float64)
        affine[:3] = srow
    elif qform_code > 0:
        affine = _quaternion_to_affine(
            quatern[0], quatern[1], quatern[2], pixdim[0],
            (pixdim[1], pixdim[2], pixdim[3]),
            (quatern[3], quatern[4], quatern[5]),
        )
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return NiftiHeader(
        shape=shape,
        dtype=dtype,
        affine=affine,
        vox_offset=max(vox_offset, 352),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        byteorder=bo,
        version=1,
        pixdim=tuple(float(p) for p in pixdim),
    )


def _parse_nifti2(raw: bytes, bo: str) -> NiftiHeader:
    if len(raw) < _NIFTI2_HDR_SIZE:
        raise ValueError("Truncated NIfTI-2 header")
    u = lambda fmt, off: struct.unpack_from(bo + fmt, raw, off)  # noqa: E731
    datatype = u("h", 12)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    dim = u("8q", 16)
    ndim = int(dim[0])
    shape = tuple(max(int(d), 1) for d in dim[1 : 1 + max(ndim, 3)])
    pixdim = u("8d", 104)
    vox_offset = int(u("q", 168)[0])
    scl_slope, scl_inter = u("2d", 176)
    qform_code, sform_code = u("2i", 344)
    quatern = u("6d", 352)
    srow = np.array(u("12d", 400), dtype=np.float64).reshape(3, 4)
    if sform_code > 0:
        affine = np.eye(4, dtype=np.float64)
        affine[:3] = srow
    elif qform_code > 0:
        affine = _quaternion_to_affine(
            quatern[0], quatern[1], quatern[2], pixdim[0],
            (pixdim[1], pixdim[2], pixdim[3]),
            (quatern[3], quatern[4], quatern[5]),
        )
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return NiftiHeader(
        shape=shape,
        dtype=dtype,
        affine=affine,
        vox_offset=max(vox_offset, _NIFTI2_HDR_SIZE + 4),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        byteorder=bo,
        version=2,
        pixdim=tuple(float(p) for p in pixdim),
    )


def _is_gzipped(path_or_bytes: Any) -> bool:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return path_or_bytes[:2] == b"\x1f\x8b"
    with open(path_or_bytes, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def read_header(source: TypeSource) -> NiftiHeader:
    """Read only the header of a ``.nii`` / ``.nii.gz`` file (or bytes)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
        if data[:2] == b"\x1f\x8b":
            with gzip.GzipFile(fileobj=_stdio.BytesIO(data)) as g:
                raw = g.read(_NIFTI2_HDR_SIZE)
        else:
            raw = data[:_NIFTI2_HDR_SIZE]
        return parse_header(raw)
    if hasattr(source, "read"):
        raw = source.read(_NIFTI2_HDR_SIZE)  # type: ignore[union-attr]
        if raw[:2] == b"\x1f\x8b":
            source.seek(0)  # type: ignore[union-attr]
            with gzip.GzipFile(fileobj=source) as g:  # type: ignore[arg-type]
                raw = g.read(_NIFTI2_HDR_SIZE)
        return parse_header(raw)
    path = Path(source)
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            f.seek(0)
            with gzip.GzipFile(fileobj=f) as g:
                raw = g.read(_NIFTI2_HDR_SIZE)
        else:
            f.seek(0)
            raw = f.read(_NIFTI2_HDR_SIZE)
    return parse_header(raw)


def _disk_to_cijk(arr: np.ndarray, header: NiftiHeader) -> np.ndarray:
    """Disk layout (I, J, K[, extra...]) -> canonical (C, I, J, K)."""
    if arr.ndim == 3:
        return arr[None]
    if arr.ndim == 4:
        return np.moveaxis(arr, -1, 0)
    if arr.ndim >= 5:
        # NIfTI vector images are (I, J, K, 1, V, ...): fold trailing dims.
        spatial = arr.shape[:3]
        arr = arr.reshape(spatial + (-1,))
        return np.moveaxis(arr, -1, 0)
    if arr.ndim == 2:
        return arr[None, ..., None]
    if arr.ndim == 1:
        return arr[None, :, None, None]
    raise ValueError(f"Cannot canonicalize array with ndim={arr.ndim}")


class NiftiFile:
    """Lazy handle over a NIfTI file: header metadata + region reads.

    Uncompressed files are windowed with ``np.memmap`` so a region read
    touches only the needed pages; gzipped files are decompressed once on
    first data access and cached.
    """

    def __init__(self, source: TypeSource):
        self._source = source
        self.header = read_header(source)
        self._cache: np.ndarray | None = None  # full disk-order array

    @property
    def shape_cijk(self) -> tuple[int, int, int, int]:
        h = self.header
        i, j, k = h.spatial_shape
        return (h.num_channels, i, j, k)

    @property
    def affine(self) -> np.ndarray:
        return self.header.affine

    @property
    def dtype(self) -> np.dtype:
        if self.header.needs_scaling:
            return np.dtype(np.float32)
        return self.header.dtype.newbyteorder("=")

    def _disk_array(self) -> np.ndarray:
        """Full array in disk order (I, J, K[, T]), memmap when possible."""
        if self._cache is not None:
            return self._cache
        h = self.header
        source = self._source
        if isinstance(source, (bytes, bytearray)):
            return NiftiFile.__wrap_bytes(self, bytes(source))
        if hasattr(source, "read"):
            source.seek(0)  # type: ignore[union-attr]
            data = source.read()  # type: ignore[union-attr]
            return NiftiFile.__wrap_bytes(self, data)
        path = Path(source)
        if _is_gzipped(path):
            return NiftiFile.__wrap_bytes(self, path.read_bytes())
        arr = np.memmap(
            path, dtype=h.dtype, mode="r", offset=h.vox_offset,
            shape=h.shape, order="F",
        )
        return arr  # memmaps are cheap; don't cache

    def __wrap_bytes(self, data: bytes) -> np.ndarray:
        h = self.header
        if data[:2] == b"\x1f\x8b":
            # zlib inflate into a buffer of the exact size the header gives
            expected = h.vox_offset + int(np.prod(h.shape)) * h.dtype.itemsize
            data = native.gunzip(bytes(data), expected)
        arr = np.frombuffer(
            data, dtype=h.dtype, count=int(np.prod(h.shape)),
            offset=h.vox_offset,
        ).reshape(h.shape, order="F")
        self._cache = arr
        return arr

    def read_region(
        self,
        slices: tuple[slice, slice, slice, slice],
    ) -> np.ndarray:
        """Read a (C, I, J, K)-indexed region; returns a (C, i, j, k) array."""
        sc, si, sj, sk = slices
        disk = self._disk_array()
        if disk.ndim == 3:
            region = np.asarray(disk[si, sj, sk])[None]
            region = region[sc]
        else:
            if disk.ndim > 4:
                disk = disk.reshape(disk.shape[:3] + (-1,))
            region = np.moveaxis(np.asarray(disk[si, sj, sk, sc]), -1, 0)
        return self._postprocess(region)

    def read(self) -> np.ndarray:
        """Read the full volume as a C-contiguous canonical (C, I, J, K)."""
        disk = self._disk_array()
        if disk.ndim == 3 and disk.itemsize in (1, 2, 4, 8):
            # hot path: native cache-blocked F->C layout transform (a new
            # array, so a big-endian one is swapped in place after it)
            return self._postprocess(native.f2c_transpose(disk)[None], fresh=True)
        return self._postprocess(_disk_to_cijk(np.asarray(disk), self.header))

    def _postprocess(self, arr: np.ndarray, fresh: bool = False) -> np.ndarray:
        """Native byte order (``fresh``: ``arr`` is a C-contiguous array of
        the caller's own, swapped in place), then the scaling."""
        h = self.header
        if not arr.dtype.isnative:
            if arr.itemsize not in (2, 4, 8):  # long double
                arr = arr.astype(arr.dtype.newbyteorder("="))
            else:
                if not fresh:
                    arr = np.array(arr, order="C")  # never swap the file's pages
                arr = native.byteswap_inplace(arr).view(arr.dtype.newbyteorder("="))
        elif arr.dtype.byteorder not in ("=", "|"):  # "<" on this host: a view
            arr = arr.view(arr.dtype.newbyteorder("="))
        if h.needs_scaling:
            arr = arr.astype(np.float32) * h.scl_slope + h.scl_inter
        return np.ascontiguousarray(arr)


def read_nifti(source: TypeSource) -> tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI file fully: returns ``(data_cijk, affine)``."""
    f = NiftiFile(source)
    return f.read(), f.affine.copy()


def _build_nifti1_header(
    shape: tuple[int, ...],
    dtype: np.dtype,
    affine: np.ndarray,
    pixdim0: float = 1.0,
) -> bytes:
    """Serialize a NIfTI-1 header (348 bytes + 4-byte extension flag)."""
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, _NIFTI1_HDR_SIZE)
    ndim = len(shape)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(dtype)])
    struct.pack_into("<h", hdr, 72, np.dtype(dtype).itemsize * 8)  # bitpix
    spacing = np.linalg.norm(np.asarray(affine, dtype=np.float64)[:3, :3], axis=0)
    pixdim = [pixdim0] + [float(s) for s in spacing] + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    # sform only (code 2 = aligned); qform_code 0.
    struct.pack_into("<2h", hdr, 252, 0, 2)
    aff = np.asarray(affine, dtype=np.float64)
    struct.pack_into("<12f", hdr, 280, *aff[:3].reshape(-1).astype(np.float32))
    hdr[344:348] = b"n+1\x00"
    # bytes 348-352: extension flag, all zero (no extensions)
    return bytes(hdr)


def write_nifti(
    path: str | Path,
    data: np.ndarray,
    affine: np.ndarray | None = None,
) -> None:
    """Write a (C, I, J, K) or (I, J, K) array as ``.nii`` / ``.nii.gz``."""
    path = Path(path)
    arr = _host_array(data)
    if arr.ndim == 4:
        if arr.shape[0] == 1:
            disk = arr[0]
        else:
            disk = np.moveaxis(arr, 0, -1)  # (I, J, K, C)
    elif arr.ndim == 3:
        disk = arr
    else:
        raise ValueError(f"Expected 3D or 4D array, got shape {arr.shape}")
    affine = np.eye(4) if affine is None else _host_array(affine)
    if disk.dtype == np.bool_:
        disk = disk.astype(np.uint8)
    if np.dtype(disk.dtype) not in _CODES:
        disk = disk.astype(np.float32)
    disk = np.ascontiguousarray(disk, dtype=disk.dtype.newbyteorder("="))
    hdr = _build_nifti1_header(disk.shape, disk.dtype, affine)
    payload = hdr + disk.tobytes(order="F")
    name = str(path)
    if name.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def is_nifti(path: str | Path) -> bool:
    """Cheap magic-byte sniff for NIfTI files."""
    try:
        read_header(path)
    except (ValueError, OSError):
        return False
    return True
