"""The port's native decode library against its plain numpy versions.

The library is built by ``g++`` from ``torchio_tpu_torch/native/
fastnifti.cpp`` into a temporary directory (a ``FastNifti`` of its own),
and each entry point must equal its plain version: ``gunzip`` on gzip
streams of several levels and sizes (an empty one, one past a 64-byte
block, a corrupt one, which gets the standard library's error),
``f2c_transpose`` on 1, 2, 4 and 8-byte items and shapes that do not
fill the 64 x 64 blocks, from Fortran and C order and from a read-only
memmap, ``byteswap_inplace`` on 2, 4 and 8-byte items, and the JPEG
decoders ``jpegll_decode``/``jls_decode`` on the Python encoders'
streams (their codec parity is in ``test_torch_io_jpeg.py``). A library
that cannot be built is reported (``available``/``build_error``, a
``RuntimeWarning``) and its plain versions run, the Python JPEG decoders
included. ``CALLS`` counts the calls into the library, from several
threads at once too, and the JPEG streams it declines apart.
"""

from __future__ import annotations

import gzip
import threading
import zlib

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu_torch import native


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    lib = native.FastNifti(tmp_path_factory.mktemp("native"))
    assert lib.get() is not None, lib.error
    assert lib.path().exists() and lib.path().parent == lib.build_dir
    return lib


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("size", [0, 1, 65, 4099, 1 << 18])
def test_gunzip(library, size, level):
    payload = np.random.default_rng(size).integers(0, 8, size, dtype=np.uint8).tobytes()
    stream = gzip.compress(payload, level)
    got = native.gunzip(stream, size, library)
    if size:  # an empty buffer has no room: the library refuses, the plain version reads
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert bytes(got) == native.gunzip_plain(stream, size) == payload


def test_gunzip_refusals(library):
    payload = bytes(range(256)) * 40
    stream = gzip.compress(payload)
    # a buffer too small: the library refuses, the plain version reads it all
    assert native.gunzip(stream, 100, library) == payload
    # two concatenated members: the library stops at the first, as zlib does
    assert bytes(native.gunzip(stream + stream, 2 * len(payload), library)) in (payload, payload * 2)
    # a corrupt stream: the library's zlib error sends it to the plain
    # version, whose error the caller gets
    for corrupt in (stream[:20] + bytes(len(stream) - 20), stream[:10] + b"\xff" * (len(stream) - 10)):
        with pytest.raises((OSError, EOFError, zlib.error)):
            native.gunzip(corrupt, len(payload), library)


@pytest.mark.parametrize("order", ["F", "C"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 7), (70, 3, 65), (64, 2, 129)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64])
def test_f2c_transpose(library, dtype, shape, order):
    arr = np.asarray(np.random.default_rng(1).integers(0, 200, shape), dtype=dtype, order=order)
    got = native.f2c_transpose(arr, library)
    want = native.f2c_transpose_plain(arr)
    assert got.flags.c_contiguous and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_f2c_transpose_memmap_and_errors(library, tmp_path):
    arr = np.arange(6 * 5 * 4, dtype=">i4").reshape(6, 5, 4, order="F")
    path = tmp_path / "raw"
    path.write_bytes(arr.tobytes(order="F"))
    disk = np.memmap(path, dtype=">i4", mode="r", shape=arr.shape, order="F")
    got = native.f2c_transpose(disk, library)
    assert got.dtype == np.dtype(">i4")
    np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError, match="3D array"):
        native.f2c_transpose(np.zeros((2, 2)), library)


@pytest.mark.parametrize("dtype", [">i2", "<u2", ">f4", "<i4", ">f8", "<u8"])
def test_byteswap(library, dtype):
    arr = np.random.default_rng(2).integers(0, 60000, 1001).astype(dtype)
    want = native.byteswap_plain(arr)
    got = native.byteswap_inplace(arr.copy(), library)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="C-contiguous"):
        native.byteswap_inplace(arr[::2].copy()[::2], library)


def test_missing_toolchain_is_reported(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    lib = native.FastNifti(tmp_path / "nowhere")
    assert lib.get() is None and "g++ not found" in lib.error
    stream = gzip.compress(b"payload")
    with pytest.warns(RuntimeWarning, match="g\\+\\+ not found"):
        assert native.gunzip(stream, 7, lib) == b"payload"
    arr = np.arange(24, dtype=np.int16).reshape(2, 3, 4, order="F")
    with pytest.warns(RuntimeWarning, match="numpy version"):
        np.testing.assert_array_equal(native.f2c_transpose(arr, lib), arr)


def test_package_library_and_calls():
    """The package's own library builds here (g++ and zlib are present)
    and counts its calls, from threads at once too."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    native.reset_calls()
    stream = gzip.compress(bytes(1 << 16))
    threads = [threading.Thread(target=native.gunzip, args=(stream, 1 << 16)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert native.CALLS["gunzip"] == 8
    native.reset_calls()
    assert native.CALLS == {
        "gunzip": 0,
        "f2c_transpose": 0,
        "byteswap": 0,
        "jpegll_decode": 0,
        "jpegll_declined": 0,
        "jls_decode": 0,
        "jls_declined": 0,
    }


def jpeg_streams():
    from torchio_tpu_torch.io.jpeg_lossless import encode_lossless_jpeg
    from torchio_tpu_torch.io.jpeg_ls import encode_jpeg_ls

    image = np.random.default_rng(3).integers(0, 3000, (11, 13)).astype(np.uint16)
    return image, {
        "jpegll": (native.jpegll_decode, encode_lossless_jpeg(image), encode_lossless_jpeg(image, restart_interval=20)),
        "jls": (native.jls_decode, encode_jpeg_ls(image), encode_jpeg_ls(image, restart_interval=3)),
    }


@pytest.mark.parametrize("codec", ["jpegll", "jls"])
def test_jpeg_entry_points(library, codec):
    """Each JPEG decoder decodes in the library, once a call, from threads
    at once too; a restart-interval stream is declined, counted apart, and
    read by the Python decoder."""
    image, streams = jpeg_streams()
    decode, plain, restart = streams[codec]
    assert all(hasattr(library.get(), f"fn_{codec}_{part}") for part in ("info", "decode"))
    native.reset_calls()
    results = []
    threads = [threading.Thread(target=lambda: results.append(decode(plain, library))) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 6
    for got in results:
        np.testing.assert_array_equal(got, image)
    np.testing.assert_array_equal(decode(restart, library), image)
    assert native.CALLS[f"{codec}_decode"] == 6 and native.CALLS[f"{codec}_declined"] == 1


def test_jpeg_without_the_library(tmp_path, monkeypatch):
    """A missing library is warned about; the Python decoders still read."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    lib = native.FastNifti(tmp_path / "nowhere")
    image, streams = jpeg_streams()
    native.reset_calls()
    for codec, (decode, plain, restart) in streams.items():
        for stream in (plain, restart):
            with pytest.warns(RuntimeWarning, match=f"native {codec}_decode unavailable, running its Python decoder"):
                np.testing.assert_array_equal(decode(stream, lib), image)
    assert not any(native.CALLS.values())
