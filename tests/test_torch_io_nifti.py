"""Port parity: NIfTI-1/2 reading and writing against the JAX package.

Files are built by hand (both header versions, both byte orders, sform,
qform and neither, ``scl_slope``/``scl_inter``, 3D, 4D and 5D, every
datatype) or written by the JAX package's writer, as ``.nii`` and
``.nii.gz``, from paths, ``bytes`` and file objects. The port's
``read_nifti``/``read_header``/``NiftiFile`` must give the JAX package's
data, dtype and float64 affine bit for bit, region reads included; the
port's ``write_nifti`` must write the JAX package's bytes (compared
decompressed for ``.nii.gz``, whose gzip header holds a time).
"""

from __future__ import annotations

import gzip
import io
import math
import struct

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import nifti as jax_nifti
from torchio_tpu_torch.io import nifti as port_nifti

DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
SHAPES = {"3d": (5, 6, 7), "4d": (5, 6, 7, 2), "5d": (4, 5, 3, 1, 3)}


def values(dtype, shape, seed=0):
    """Seeded values across ``dtype``'s range (floats of both signs)."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 1000).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)


def build_nifti(disk, version=1, bo="<", form="sform", slope=(1.0, 0.0)):
    """A NIfTI file's bytes: ``disk`` (on-disk (I, J, K[, ...]) order) in
    byte order ``bo``, an sform, a qform (qfac -1), or neither."""
    code = {np.dtype(v): k for k, v in DTYPES.items()}[disk.dtype]
    pixdim = (-1.0 if form == "qform" else 1.0, 0.9, 1.1, 2.5, 1, 1, 1, 1)
    quatern = (0.1, -0.2, math.sqrt(0.5), 5.0, -7.0, 9.5)
    srow = (0.9, 0.1, 0.0, -40.0, -0.05, 1.1, 0.2, 30.5, 0.0, 0.0, 2.5, -12.25)
    qform, sform = {"sform": (1, 2), "qform": (1, 0), "none": (0, 0)}[form]
    dim = [disk.ndim, *disk.shape] + [1] * (7 - disk.ndim)
    if version == 1:
        hdr = bytearray(352)
        struct.pack_into(bo + "i", hdr, 0, 348)
        struct.pack_into(bo + "8h", hdr, 40, *dim)
        struct.pack_into(bo + "2h", hdr, 70, code, disk.dtype.itemsize * 8)
        struct.pack_into(bo + "8f", hdr, 76, *pixdim)
        struct.pack_into(bo + "f", hdr, 108, 352.0)
        struct.pack_into(bo + "2f", hdr, 112, *slope)
        struct.pack_into(bo + "2h", hdr, 252, qform, sform)
        struct.pack_into(bo + "6f", hdr, 256, *quatern)
        struct.pack_into(bo + "12f", hdr, 280, *srow)
        hdr[344:348] = b"n+1\x00"
    else:
        hdr = bytearray(544)
        struct.pack_into(bo + "i", hdr, 0, 540)
        struct.pack_into(bo + "8s", hdr, 4, b"n+2\x00\r\n\x1a\n")
        struct.pack_into(bo + "2h", hdr, 12, code, disk.dtype.itemsize * 8)
        struct.pack_into(bo + "8q", hdr, 16, *dim)
        struct.pack_into(bo + "8d", hdr, 104, *pixdim)
        struct.pack_into(bo + "q", hdr, 168, 544)
        struct.pack_into(bo + "2d", hdr, 176, *slope)
        struct.pack_into(bo + "2i", hdr, 344, qform, sform)
        struct.pack_into(bo + "6d", hdr, 352, *quatern)
        struct.pack_into(bo + "12d", hdr, 400, *srow)
    payload = disk.astype(disk.dtype.newbyteorder(bo)).tobytes(order="F")
    return bytes(hdr) + payload


def source(raw, kind, tmp_path, gz):
    """``raw`` as a path (``.nii`` or ``.nii.gz``), ``bytes`` or a file
    object, gzipped when ``gz``; a maker, so each package gets its own."""
    data = gzip.compress(raw, 1) if gz else raw
    if kind == "path":
        path = tmp_path / ("v.nii.gz" if gz else "v.nii")
        path.write_bytes(data)
        return lambda: path
    if kind == "bytes":
        return lambda: data
    return lambda: io.BytesIO(data)


def assert_same_read(make):
    """Header, full read and affine equal bit for bit in both packages."""
    jh, ph = jax_nifti.read_header(make()), port_nifti.read_header(make())
    assert (ph.shape, ph.dtype, ph.vox_offset, ph.byteorder, ph.version, ph.pixdim) == (
        jh.shape, jh.dtype, jh.vox_offset, jh.byteorder, jh.version, jh.pixdim)
    assert (ph.scl_slope, ph.scl_inter, ph.needs_scaling) == (jh.scl_slope, jh.scl_inter, jh.needs_scaling)
    np.testing.assert_array_equal(ph.affine, jh.affine)
    want, want_affine = jax_nifti.read_nifti(make())
    got, got_affine = port_nifti.read_nifti(make())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.dtype.byteorder in ("=", "|")
    np.testing.assert_array_equal(got, want)
    assert got_affine.dtype == np.float64
    np.testing.assert_array_equal(got_affine, want_affine)
    return got


@pytest.mark.parametrize("gz", [False, True], ids=["nii", "gz"])
@pytest.mark.parametrize("bo", ["<", ">"], ids=["le", "be"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("code", list(DTYPES), ids=lambda c: np.dtype(DTYPES[c]).name)
def test_read_every_dtype(tmp_path, code, version, bo, gz):
    disk = values(DTYPES[code], SHAPES["3d"], seed=code)
    make = source(build_nifti(disk, version, bo), "path", tmp_path, gz)
    got = assert_same_read(make)
    np.testing.assert_array_equal(got[0], disk)


@pytest.mark.parametrize("kind", ["path", "bytes", "file"])
@pytest.mark.parametrize("gz", [False, True], ids=["nii", "gz"])
@pytest.mark.parametrize("form", ["sform", "qform", "none"])
@pytest.mark.parametrize("ndim", list(SHAPES))
def test_read_forms_layouts_and_sources(tmp_path, ndim, form, gz, kind):
    disk = values(np.int16, SHAPES[ndim], seed=len(ndim))
    for version, bo in ((1, "<"), (2, ">")):
        make = source(build_nifti(disk, version, bo, form), kind, tmp_path, gz)
        assert_same_read(make)


@pytest.mark.parametrize("bo", ["<", ">"], ids=["le", "be"])
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.float32, np.uint8])
def test_read_scaled(tmp_path, dtype, version, bo):
    """``scl_slope``/``scl_inter`` give float32 in both packages."""
    disk = values(dtype, SHAPES["4d"], seed=3)
    make = source(build_nifti(disk, version, bo, slope=(2.5, -3.0)), "path", tmp_path, True)
    got = assert_same_read(make)
    assert got.dtype == np.float32
    assert port_nifti.NiftiFile(make()).dtype == np.float32


REGIONS = (
    (slice(None), slice(0, 3), slice(2, 6), slice(1, 7)),
    (slice(1, 2), slice(4, 5), slice(0, 6), slice(3, 4)),
    (slice(0, 2), slice(0, 5, 2), slice(5, 0, -2), slice(6, 2, -1)),
)


@pytest.mark.parametrize("gz", [False, True], ids=["nii", "gz"])
@pytest.mark.parametrize("bo", ["<", ">"], ids=["le", "be"])
@pytest.mark.parametrize("ndim", ["3d", "4d"])
def test_region_reads(tmp_path, ndim, bo, gz):
    disk = values(np.float32, SHAPES[ndim], seed=5)
    make = source(build_nifti(disk, 1, bo, slope=(1.5, 0.25)), "path", tmp_path, gz)
    jax_file, port_file = jax_nifti.NiftiFile(make()), port_nifti.NiftiFile(make())
    assert port_file.shape_cijk == jax_file.shape_cijk
    for region in REGIONS:
        region = (region[0] if ndim == "4d" else slice(0, 1), *region[1:])
        want = jax_file.read_region(region)
        got = port_file.read_region(region)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


WRITE_DTYPES = (
    np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
    np.uint64, np.float32, np.float64, np.bool_, np.float16,
)


def oblique_affine():
    angle = 0.3
    affine = np.eye(4)
    affine[:3, :3] = np.array(
        [[math.cos(angle), -math.sin(angle), 0.0], [math.sin(angle), math.cos(angle), 0.0], [0, 0, 1]]
    ) @ np.diag([0.9375, 0.9375, 1.2])
    affine[:3, 3] = (-90.5, 110.25, 70.0)
    return affine


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("channels", [None, 1, 3], ids=["3d", "c1", "c3"])
@pytest.mark.parametrize("dtype", WRITE_DTYPES, ids=lambda d: np.dtype(d).name)
def test_write_same_bytes(tmp_path, dtype, channels, suffix):
    """The port writes the JAX package's bytes, from numpy or a tensor
    (bool written as uint8, float16 as float32)."""
    shape = (6, 5, 4) if channels is None else (channels, 6, 5, 4)
    data = values(np.float32 if dtype == np.float16 else dtype, shape, seed=7).astype(dtype) \
        if dtype != np.bool_ else values(np.uint8, shape, seed=7) > 127
    affine = oblique_affine()
    jax_nifti.write_nifti(tmp_path / f"j{suffix}", data, affine)
    port_nifti.write_nifti(tmp_path / f"p{suffix}", data, affine)
    if dtype not in (np.uint64, np.float16, np.bool_):  # torch's tensor types
        port_nifti.write_nifti(tmp_path / f"t{suffix}", torch.from_numpy(data), torch.from_numpy(affine))
    for name in ("p", "t"):
        if (tmp_path / f"{name}{suffix}").exists():
            got, want = ((tmp_path / f"{n}{suffix}").read_bytes() for n in (name, "j"))
            if suffix == ".nii.gz":
                got, want = gzip.decompress(got), gzip.decompress(want)
            assert got == want


def test_write_rejects_other_ranks(tmp_path):
    for write in (jax_nifti.write_nifti, port_nifti.write_nifti):
        with pytest.raises(ValueError, match="Expected 3D or 4D"):
            write(tmp_path / "x.nii", np.zeros((2, 2)))


@pytest.mark.parametrize(
    "raw, message",
    [(b"\x00" * 100, "too small"), (b"\x00" * 400, "bad sizeof_hdr")],
)
def test_header_errors(raw, message):
    for module in (jax_nifti, port_nifti):
        with pytest.raises(ValueError, match=message):
            module.read_header(raw)


def test_unsupported_datatype_and_truncated_nifti2():
    raw = bytearray(build_nifti(values(np.int16, (2, 2, 2)), 2))
    struct.pack_into("<h", raw, 12, 9999)
    for module in (jax_nifti, port_nifti):
        with pytest.raises(ValueError, match="Unsupported NIfTI datatype code 9999"):
            module.parse_header(bytes(raw))
        with pytest.raises(ValueError, match="Truncated NIfTI-2"):
            module.parse_header(bytes(raw[:400]))


def test_is_nifti(tmp_path):
    good = tmp_path / "a.nii.gz"
    port_nifti.write_nifti(good, values(np.float32, (3, 3, 3)))
    bad = tmp_path / "b.nii"
    bad.write_bytes(b"not a nifti file" * 40)
    for path in (good, bad, tmp_path / "missing.nii"):
        assert port_nifti.is_nifti(path) == jax_nifti.is_nifti(path)
    assert port_nifti.is_nifti(good) and not port_nifti.is_nifti(bad)
