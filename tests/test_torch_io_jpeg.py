"""Port parity: the JPEG Lossless and JPEG-LS codecs and their native decoders.

- The port's encoders write the JAX package's bytes (JPEG Lossless:
  predictors 1-7, with and without restart intervals, 8 and 16 bits;
  JPEG-LS: NEAR 0, 1 and 3, with and without restart intervals).
- The port's Python decoders invert them (exactly, or within NEAR) and
  equal the JAX package's decoders, and so does a multi-component
  JPEG-LS stream in interleave mode 0, built by hand.
- The port's native decoders (``native.jpegll_decode``/``jls_decode``,
  built into a temporary directory) equal the Python ones and count
  their calls; a stream with restart intervals is declined by the
  library, counted under ``*_declined`` and read by the Python decoder.
- Truncated and corrupted streams get the JAX package's outcome: the
  same array or the same exception type.

Frames are at most 24 x 31: the Python encoders take about a second for
a 512 x 512 slice.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import jpeg_lossless as jax_jll
from torchio_tpu.io import jpeg_ls as jax_jls
from torchio_tpu_torch import native
from torchio_tpu_torch.io import jpeg_lossless as port_jll
from torchio_tpu_torch.io import jpeg_ls as port_jls

SHAPE = (24, 31)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    lib = native.FastNifti(tmp_path_factory.mktemp("native_jpeg"))
    assert lib.get() is not None, lib.error
    return lib


def frame(dtype, seed=0, shape=SHAPE):
    """A smooth ramp with noise and a flat patch (JPEG-LS run mode)."""
    rng = np.random.default_rng(seed)
    top = 250 if dtype == np.uint8 else 4000
    i, j = np.mgrid[: shape[0], : shape[1]]
    values = i * 5 + j * 3 + rng.integers(0, top // 8, shape)
    values[2:9, 4:20] = top // 3
    return np.clip(values, 0, top).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("restart", [0, 37])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_jpeg_lossless_codec(library, predictor, restart, dtype):
    image = frame(dtype, seed=predictor)
    stream = port_jll.encode_lossless_jpeg(image, restart_interval=restart, predictor=predictor)
    assert stream == jax_jll.encode_lossless_jpeg(image, restart_interval=restart, predictor=predictor)
    plain = port_jll.decode_lossless_jpeg_python(stream)
    assert plain.dtype == image.dtype
    np.testing.assert_array_equal(plain, image)
    np.testing.assert_array_equal(plain, jax_jll.decode_lossless_jpeg(stream))
    native.reset_calls()
    got = native.jpegll_decode(stream, library)
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, image)
    declined = 1 if restart else 0
    assert (native.CALLS["jpegll_decode"], native.CALLS["jpegll_declined"]) == (1 - declined, declined)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("near", [0, 1, 3])
def test_jpeg_ls_codec(library, near, restart, dtype):
    image = frame(dtype, seed=10 + near)
    stream = port_jls.encode_jpeg_ls(image, near=near, restart_interval=restart)
    assert stream == jax_jls.encode_jpeg_ls(image, near=near, restart_interval=restart)
    plain = port_jls.decode_jpeg_ls_python(stream)
    assert plain.dtype == image.dtype
    assert int(np.abs(plain.astype(np.int64) - image).max()) <= near
    if near == 0:
        np.testing.assert_array_equal(plain, image)
    np.testing.assert_array_equal(plain, jax_jls.decode_jpeg_ls_python(stream))
    np.testing.assert_array_equal(plain, jax_jls.decode_jpeg_ls(stream))
    native.reset_calls()
    got = native.jls_decode(stream, library)
    assert got.dtype == image.dtype
    np.testing.assert_array_equal(got, plain)
    declined = 1 if restart else 0
    assert (native.CALLS["jls_decode"], native.CALLS["jls_declined"]) == (1 - declined, declined)


def multi_component_jpeg_ls(planes):
    """An interleave-mode-0 stream: one SOF55 of len(planes) components,
    then a scan a component, each cut from a single-component stream."""
    scans = []
    for index, plane in enumerate(planes):
        stream = jax_jls.encode_jpeg_ls(plane)
        sos = stream.index(b"\xff\xda")
        length = struct.unpack_from(">H", stream, sos + 2)[0]
        header = bytes([0xFF, 0xDA]) + struct.pack(">H", 8) + bytes([1, index + 1, 0, 0, 0, 0])
        scans.append(header + stream[sos + 2 + length : -2])
    height, width = planes[0].shape
    precision = 16 if planes[0].dtype == np.uint16 else 8
    sof = struct.pack(">BHHB", precision, height, width, len(planes))
    sof += b"".join(bytes([i + 1, 0x11, 0]) for i in range(len(planes)))
    return (
        b"\xff\xd8\xff\xf7" + struct.pack(">H", len(sof) + 2) + sof + b"".join(scans) + b"\xff\xd9"
    )


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_jpeg_ls_multi_component(library, dtype):
    planes = [frame(dtype, seed=s, shape=(9, 13)) for s in range(3)]
    stream = multi_component_jpeg_ls(planes)
    want = np.stack(planes, axis=-1)
    np.testing.assert_array_equal(port_jls.decode_jpeg_ls_python(stream), want)
    np.testing.assert_array_equal(jax_jls.decode_jpeg_ls(stream), want)
    native.reset_calls()
    got = native.jls_decode(stream, library)
    assert got.dtype == dtype and native.CALLS["jls_decode"] == 1
    np.testing.assert_array_equal(got, want)


def outcome(decode, stream):
    try:
        return "ok", decode(stream)
    except Exception as error:  # the outcome is what is compared
        return "error", type(error)


def broken_streams(stream):
    """Truncations at several points, flipped bytes in the header and in
    the entropy-coded data, a lost SOI, a stray byte between segments."""
    sos = stream.index(b"\xff\xda")
    cuts = [2, 5, 11, sos - 3, sos + 4, sos + 30, len(stream) // 2, len(stream) - 2]
    out = [stream[:n] for n in cuts]
    for at in (4, 8, 12, sos + 9, sos + 40, len(stream) - 9):
        corrupt = bytearray(stream)
        corrupt[at] ^= 0x5A
        out.append(bytes(corrupt))
    out.append(b"\x00" + stream[1:])
    out.append(stream[:2] + b"\x00" + stream[2:])
    return out


CODECS = {
    "jpeg-lossless": (
        lambda image: jax_jll.encode_lossless_jpeg(image, predictor=4),
        port_jll.decode_lossless_jpeg,
        jax_jll.decode_lossless_jpeg,
    ),
    "jpeg-lossless-restart": (
        lambda image: jax_jll.encode_lossless_jpeg(image, restart_interval=50),
        port_jll.decode_lossless_jpeg,
        jax_jll.decode_lossless_jpeg,
    ),
    "jpeg-ls": (jax_jls.encode_jpeg_ls, port_jls.decode_jpeg_ls, jax_jls.decode_jpeg_ls),
    "jpeg-ls-near": (
        lambda image: jax_jls.encode_jpeg_ls(image, near=2),
        port_jls.decode_jpeg_ls,
        jax_jls.decode_jpeg_ls,
    ),
}


@pytest.mark.parametrize("codec", list(CODECS))
def test_broken_streams_as_the_jax_package(codec):
    encode, port_decode, jax_decode = CODECS[codec]
    stream = encode(frame(np.uint16, seed=3, shape=(12, 17)))
    for broken in broken_streams(stream):
        got, want = outcome(port_decode, broken), outcome(jax_decode, broken)
        assert got[0] == want[0], (codec, broken.hex())
        if got[0] == "ok":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is want[1], (codec, broken.hex())


def test_decoder_errors():
    for decode in (port_jll.decode_lossless_jpeg_python, port_jls.decode_jpeg_ls_python):
        with pytest.raises(ValueError, match="Not a JPEG"):
            decode(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="predictor must be 1-7"):
        port_jll.encode_lossless_jpeg(frame(np.uint8), predictor=8)
    with pytest.raises(ValueError, match="2D image"):
        port_jls.encode_jpeg_ls(np.zeros((2, 3, 4), np.uint8))
    with pytest.raises(ValueError, match="NEAR"):
        port_jls.encode_jpeg_ls(frame(np.uint8), near=255)


def with_tables(stream, tables):
    """``stream`` with its DHT segment replaced by ``tables`` (one DHT
    segment of (id, counts, values) entries)."""
    at = stream.index(b"\xff\xc4")
    length = struct.unpack_from(">H", stream, at + 2)[0]
    payload = b"".join(bytes([table_id, *counts, *values]) for table_id, counts, values in tables)
    return stream[:at] + b"\xff\xc4" + struct.pack(">H", len(payload) + 2) + payload + stream[at + 2 + length :]


def test_scan_reads_its_own_table(library, monkeypatch):
    """The native decoder builds the table the scan header names, anew for
    each stream. ROADMAP.md, Known faults in the reference: the JAX
    package's ``fn_jpegll_decode`` keeps its lookup across calls and takes
    the last DHT table whatever the scan names, so these streams are held
    to the JAX package's Python decoder, not to its ``decode_lossless_jpeg``."""
    monkeypatch.setattr("torchio_tpu.native.jpegll_decode", lambda stream: None)
    image = frame(np.uint16, seed=4, shape=(12, 17))
    stream = jax_jll.encode_lossless_jpeg(image)
    at = stream.index(b"\xff\xc4")
    table = (0, tuple(stream[at + 5 : at + 21]), tuple(stream[at + 21 : at + 21 + 17]))
    only_zero = (0, (0, 1) + (0,) * 14, (0,))
    # a table without the codes the scan uses, read after a stream that has them
    native.jpegll_decode(stream, library)
    broken = with_tables(stream, [only_zero])
    for decode in (lambda s: native.jpegll_decode(s, library), jax_jll.decode_lossless_jpeg):
        with pytest.raises(KeyError):
            decode(broken)
    # the scan's table 0 before an unrelated table 1
    two = with_tables(stream, [table, (1,) + only_zero[1:]])
    native.reset_calls()
    np.testing.assert_array_equal(native.jpegll_decode(two, library), image)
    np.testing.assert_array_equal(jax_jll.decode_lossless_jpeg(two), image)
    assert native.CALLS["jpegll_decode"] == 1
