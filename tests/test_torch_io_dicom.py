"""Port parity: the DICOM reader and writer against the JAX package.

Reader: the repo's fixture series (``tests/image_data_dicom``, int16
(1, 88, 128, 17)); files written by the JAX package's writer in every
syntax it writes (explicit VR little endian, RLE, JPEG Lossless SV1,
JPEG-LS lossless), as series and multi-frame files, in uint8, int8,
int16 and uint16 and as rescaled floats; and hand-built files: implicit
VR little endian (with and without the file preamble), explicit VR big
endian, JPEG Lossless process 14 with predictor 4, JPEG-LS near-lossless,
RGB interleaved and planar, RGB in RLE and in JPEG-LS, YBR_FULL, a
rescale slope/intercept, a single slice; JPEG baseline and JPEG 2000
through Pillow (skipped without it). The port's ``read_dicom_dir``/
``read_dicom_file`` and a lazy ``ScalarImage`` give the JAX package's
data and dtype bit for bit and its float64 affine exactly (both parse
the same decimal strings).

Writer: with the random UIDs made deterministic in both packages, the
port's ``write_dicom``/``write_dicom_series`` write the JAX package's
bytes, file for file, in every compression and dtype; the JAX reader
reads the port's files back. Malformed files are refused with the JAX
package's exception and message.
"""

from __future__ import annotations

import io
import itertools
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import dicom as jax_dicom
from torchio_tpu.io import jpeg_lossless as jax_jll
from torchio_tpu.io import jpeg_ls as jax_jls
import torchio_tpu_torch as tt
from torchio_tpu_torch import native
from torchio_tpu_torch.io import dicom as port_dicom
from torchio_tpu_torch.io import write as port_write

FIXTURE = Path(__file__).parent / "image_data_dicom"
COMPRESSIONS = (None, "rle", "jpeg-lossless", "jpeg-ls")
_el = jax_dicom._el


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture
def fixed_uids(monkeypatch):
    """Both packages' writers draw the same UIDs."""
    for module in (jax_dicom, port_dicom):
        counter = itertools.count(1)
        monkeypatch.setattr(module, "_new_uid", lambda counter=counter: f"2.25.{next(counter)}")


def oblique_affine():
    """A RAS affine with a tilted slice axis and sub-millimetre pixels."""
    out = np.eye(4)
    angle = 0.07
    out[:3, :3] = np.array(
        [[np.cos(angle), 0.0, np.sin(angle)], [0.0, 1.0, 0.0], [-np.sin(angle), 0.0, np.cos(angle)]]
    ) @ np.diag([0.703125, 0.703125, 1.25])
    out[:3, 3] = (-179.6484375, -191.2, -312.5)
    return out


def volume(dtype, shape=(1, 9, 7, 3), seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 300 - 50).astype(dtype)
    info = np.iinfo(dtype)
    low, high = max(info.min, -1024), min(info.max, 3000)
    return rng.integers(low, high, shape, endpoint=True).astype(dtype)


def assert_same_read(path):
    """The port reads ``path`` as the JAX package does, through its reader
    and through a lazy ScalarImage; returns the data."""
    reader = "read_dicom_dir" if path.is_dir() else "read_dicom_file"
    want_data, want_affine = getattr(jax_dicom, reader)(path)
    got_data, got_affine = getattr(port_dicom, reader)(path)
    assert got_data.dtype == want_data.dtype and got_affine.dtype == np.float64
    np.testing.assert_array_equal(got_data, want_data)
    np.testing.assert_array_equal(got_affine, want_affine)
    image = tt.ScalarImage(path)
    assert not image.is_loaded and image.path == path
    assert image.shape == want_data.shape
    np.testing.assert_array_equal(image.affine.data, want_affine)
    np.testing.assert_array_equal(image.numpy(), want_data)
    return got_data


def test_fixture_series():
    data = assert_same_read(FIXTURE)
    assert data.shape == (1, 88, 128, 17) and data.dtype == np.int16
    assert port_dicom.is_dicom(next(FIXTURE.iterdir())) and not port_dicom.is_dicom(FIXTURE)
    backend = port_dicom.DicomBackend(FIXTURE)
    region = (slice(0, 1), slice(3, 9), slice(0, 128, 5), slice(16, 17))
    np.testing.assert_array_equal(backend[region], jax_dicom.DicomBackend(FIXTURE)[region])
    assert backend.dtype == np.int16


@pytest.mark.parametrize("layout", ["series", "file"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint16, np.float32])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_reads_the_jax_writer(tmp_path, compression, dtype, layout):
    data = volume(dtype, seed=3)
    if layout == "series":
        path = tmp_path / "series"
        jax_dicom.write_dicom_series(path, data, oblique_affine(), compression=compression)
    else:
        path = tmp_path / "volume.dcm"
        jax_dicom.write_dicom(path, data, oblique_affine(), compression=compression)
    got = assert_same_read(path)
    if dtype != np.float32:  # integers are stored as they are; floats rescaled
        np.testing.assert_array_equal(got, data)


def encapsulated_file(
    path, syntax, frames, rows, cols, *, bits=16, signed=0, spp=1, photometric=None, n_frames=None
):
    """A hand-built DICOM file whose PixelData holds ``frames`` (encoded
    bytes), one fragment a frame (NumberOfFrames says ``n_frames``)."""
    n_frames = len(frames) if n_frames is None else n_frames
    meta_body = _el(0x0002, 0x0010, b"UI", syntax.encode())
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    elements = [
        _el(0x0020, 0x0032, b"DS", b"-10.5\\20\\-3.25"),
        _el(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\0.8\\-0.6"),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", spp)),
    ]
    if photometric:
        elements.append(_el(0x0028, 0x0004, b"CS", photometric.encode()))
    if n_frames > 1:
        elements.append(_el(0x0028, 0x0008, b"IS", str(n_frames).encode()))
    elements += [
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0030, b"DS", b"0.5\\0.75"),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", signed)),
    ]
    pixel = (
        struct.pack("<HH", 0x7FE0, 0x0010)
        + b"OB\x00\x00"
        + struct.pack("<I", 0xFFFFFFFF)
        + jax_dicom._encapsulate(frames)
    )
    path.write_bytes(b"\x00" * 128 + b"DICM" + meta + b"".join(elements) + pixel)
    return path


def native_file(path, syntax, pixels, *, elements=(), preamble=True, big=False):
    """A hand-built uncompressed DICOM file: ``pixels`` (frames, rows,
    cols[, spp]) after the given extra elements, in ``syntax``."""
    order = ">" if big else "<"

    def element(group, number, vr, value):
        if syntax == jax_dicom.IMPLICIT_LITTLE:
            value = value + b"\x00" if len(value) % 2 else value
            return struct.pack("<HHI", group, number, len(value)) + value
        if not big:
            return _el(group, number, vr, value)
        value = value + b"\x00" if len(value) % 2 else value
        head = struct.pack(">HH", group, number) + vr
        if vr in (b"OB", b"OW"):
            return head + b"\x00\x00" + struct.pack(">I", len(value)) + value
        return head + struct.pack(">H", len(value)) + value

    frames, rows, cols = pixels.shape[:3]
    spp = pixels.shape[3] if pixels.ndim == 4 else 1
    bits = pixels.dtype.itemsize * 8
    signed = int(np.issubdtype(pixels.dtype, np.signedinteger))
    body = [element(*e[:3], e[3] if isinstance(e[3], bytes) else struct.pack(order + "H", e[3])) for e in elements]
    body += [
        element(0x0028, 0x0002, b"US", struct.pack(order + "H", spp)),
        element(0x0028, 0x0008, b"IS", str(frames).encode()),
        element(0x0028, 0x0010, b"US", struct.pack(order + "H", rows)),
        element(0x0028, 0x0011, b"US", struct.pack(order + "H", cols)),
        element(0x0028, 0x0100, b"US", struct.pack(order + "H", bits)),
        element(0x0028, 0x0103, b"US", struct.pack(order + "H", signed)),
        element(0x7FE0, 0x0010, b"OW", pixels.astype(pixels.dtype.newbyteorder(order)).tobytes()),
    ]
    if not preamble:
        path.write_bytes(b"".join(body))
        return path
    meta_body = _el(0x0002, 0x0010, b"UI", syntax.encode())
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body
    path.write_bytes(b"\x00" * 128 + b"DICM" + meta + b"".join(body))
    return path


def rgb(rows=5, cols=7, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (rows, cols, 3)).astype(np.uint8)


def rle_rgb_frame(pixels):
    """An RLE frame of 3 one-byte segments (one a channel)."""
    planes = [jax_dicom._packbits_encode(pixels[..., c].tobytes()) for c in range(3)]
    planes = [p + b"\x00" if len(p) % 2 else p for p in planes]
    offsets = list(itertools.accumulate([64] + [len(p) for p in planes[:-1]]))
    return struct.pack("<16I", 3, *offsets, *([0] * 12)) + b"".join(planes)


def crafted(name, tmp_path):
    """The hand-built file (or series directory) ``name``."""
    rng = np.random.default_rng(7)
    path = tmp_path / f"{name}.dcm"
    u16 = rng.integers(0, 4000, (2, 6, 5)).astype(np.uint16)
    position = ((0x0020, 0x0032, b"DS", b"1.5\\-2\\30"),)
    if name == "implicit-little":
        return native_file(path, jax_dicom.IMPLICIT_LITTLE, u16.astype(np.int16), elements=position)
    if name == "implicit-headerless":
        return native_file(path, jax_dicom.IMPLICIT_LITTLE, u16[:1], elements=position, preamble=False)
    if name == "explicit-big":
        return native_file(path, jax_dicom.EXPLICIT_BIG, u16, elements=position, big=True)
    if name == "rescale":
        rescale = ((0x0028, 0x1052, b"DS", b"-1024"), (0x0028, 0x1053, b"DS", b"2.5"))
        return native_file(path, jax_dicom.EXPLICIT_LITTLE, u16, elements=position + rescale)
    if name in ("rgb-interleaved", "rgb-planar"):
        planar = name.endswith("planar")
        pixels = rgb()[None]
        elements = ((0x0028, 0x0004, b"CS", b"RGB"), (0x0028, 0x0006, b"US", int(planar)))
        if planar:  # stored channel by channel: write the bytes in that order
            stored = np.moveaxis(pixels, -1, 1).reshape(pixels.shape)
            return native_file(path, jax_dicom.EXPLICIT_LITTLE, stored, elements=elements)
        return native_file(path, jax_dicom.EXPLICIT_LITTLE, pixels, elements=elements)
    if name == "ybr-full":
        elements = ((0x0028, 0x0004, b"CS", b"YBR_FULL"),)
        return native_file(path, jax_dicom.EXPLICIT_LITTLE, rgb(seed=2)[None], elements=elements)
    if name == "rgb-rle":
        return encapsulated_file(path, jax_dicom.RLE_LOSSLESS, [rle_rgb_frame(rgb(seed=3))], 5, 7,
                                 bits=8, spp=3, photometric="RGB")
    if name == "jpeg-lossless-p14":
        frames = [jax_jll.encode_lossless_jpeg(f, predictor=4) for f in u16]
        return encapsulated_file(path, jax_dicom.JPEG_LOSSLESS_P14, frames, 6, 5)
    if name == "jpeg-ls-near":
        frames = [jax_jls.encode_jpeg_ls(f, near=3) for f in u16]
        return encapsulated_file(path, jax_dicom.JPEG_LS_NEAR, frames, 6, 5)
    if name == "jpeg-ls-rgb":
        from test_torch_io_jpeg import multi_component_jpeg_ls

        pixels = rgb(seed=4)
        stream = multi_component_jpeg_ls([pixels[..., c] for c in range(3)])
        return encapsulated_file(path, jax_dicom.JPEG_LS_LOSSLESS, [stream], 5, 7, bits=8, spp=3,
                                 photometric="RGB")
    if name == "single-slice":
        series = tmp_path / "single"
        jax_dicom.write_dicom_series(series, volume(np.int16, (1, 6, 5, 1)), oblique_affine())
        return series
    raise KeyError(name)


CRAFTED = (
    "implicit-little", "implicit-headerless", "explicit-big", "rescale", "rgb-interleaved",
    "rgb-planar", "ybr-full", "rgb-rle", "jpeg-lossless-p14", "jpeg-ls-near", "jpeg-ls-rgb",
    "single-slice",
)


@pytest.mark.parametrize("name", CRAFTED)
def test_crafted_syntaxes(tmp_path, name):
    native.reset_calls()
    data = assert_same_read(crafted(name, tmp_path))
    if name.startswith(("jpeg-lossless", "jpeg-ls")):
        key = "jpegll_decode" if name.startswith("jpeg-lossless") else "jls_decode"
        # each frame decoded by the library, once by the port's reader and
        # once by its lazy image (the JAX package has its own library)
        assert native.CALLS[key] == 2 * data.shape[-1]
    if name == "rescale":
        assert data.dtype == np.float32


def pillow_frame(kind):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    buffer = io.BytesIO()
    if kind == "jpeg-gray":
        pixels = rng.integers(100, 120, (8, 8)).astype(np.uint8)
        pil.fromarray(pixels, "L").save(buffer, "JPEG", quality=100)
        return jax_dicom.JPEG_BASELINE, buffer.getvalue(), 8, 8, 8, 1, None
    if kind == "jpeg-rgb":
        pixels = rng.integers(0, 255, (8, 16, 3)).astype(np.uint8)
        pil.fromarray(pixels, "RGB").save(buffer, "JPEG", quality=95)
        return jax_dicom.JPEG_BASELINE, buffer.getvalue(), 8, 16, 8, 3, "YBR_FULL_422"
    pixels = rng.integers(0, 4000, (6, 10)).astype(np.uint16)
    pil.fromarray(pixels, "I;16").save(buffer, "JPEG2000", irreversible=False)
    return jax_dicom.J2K_LOSSLESS, buffer.getvalue(), 6, 10, 16, 1, None


@pytest.mark.parametrize("kind", ["jpeg-gray", "jpeg-rgb", "j2k-16bit"])
def test_pillow_syntaxes(tmp_path, kind):
    syntax, frame, rows, cols, bits, spp, photometric = pillow_frame(kind)
    path = encapsulated_file(tmp_path / "pil.dcm", syntax, [frame], rows, cols, bits=bits, spp=spp,
                             photometric=photometric)
    assert assert_same_read(path).shape == (spp, cols, rows, 1)


def test_pillow_missing_is_reported(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    for module in (jax_dicom, port_dicom):
        with pytest.raises(ImportError, match="requires Pillow"):
            module._decode_pil_frame(b"\xff\xd8", np.uint8)


REFUSED = {
    "unsupported-syntax": lambda p: encapsulated_file(p, "1.2.840.10008.1.2.4.100", [b"\x00\x00"], 2, 2),
    "fragments-for-frames": lambda p: encapsulated_file(
        p, jax_dicom.RLE_LOSSLESS, [b"\x00" * 64] * 3, 2, 2, n_frames=2
    ),
    "rle-segments": lambda p: encapsulated_file(p, jax_dicom.RLE_LOSSLESS, [struct.pack("<16I", 3, *([64] * 15))], 2, 2),
    "jpeg-lossless-color": lambda p: encapsulated_file(
        p, jax_dicom.JPEG_LOSSLESS_SV1, [jax_jll.encode_lossless_jpeg(np.zeros((2, 2), np.uint8))], 2, 2,
        bits=8, spp=3,
    ),
    "ybr-422-uncompressed": lambda p: native_file(
        p, jax_dicom.EXPLICIT_LITTLE, rgb()[None], elements=((0x0028, 0x0004, b"CS", b"YBR_FULL_422"),)
    ),
    "jpeg-ls-components": lambda p: encapsulated_file(
        p, jax_dicom.JPEG_LS_LOSSLESS, [jax_jls.encode_jpeg_ls(np.zeros((2, 2), np.uint8))], 2, 2,
        bits=8, spp=3,
    ),
}


def refusal(read, path):
    try:
        read(path)
    except Exception as error:  # the refusal is what is compared
        return type(error), str(error)
    return None


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusals_as_the_jax_package(tmp_path, name):
    path = REFUSED[name](tmp_path / f"{name}.dcm")
    want = refusal(jax_dicom.read_dicom_file, path)
    assert want is not None
    assert refusal(port_dicom.read_dicom_file, path) == want


def test_series_skips_unreadable_files(tmp_path):
    series = tmp_path / "series"
    jax_dicom.write_dicom_series(series, volume(np.int16), oblique_affine())
    (series / "README").write_text("not a DICOM file")
    (series / "IMG0002.dcm").write_bytes((series / "IMG0002.dcm").read_bytes()[:300])
    assert_same_read(series)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "junk").write_bytes(b"junk")
    for module in (jax_dicom, port_dicom):
        with pytest.raises(ValueError, match="No readable DICOM slices"):
            module.read_dicom_dir(empty)


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.uint16, np.int32, np.float32])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_writer_gives_the_jax_bytes(tmp_path, fixed_uids, compression, dtype):
    data = volume(dtype, seed=11)
    for name, module in (("jax", jax_dicom), ("port", port_dicom)):
        module.write_dicom_series(tmp_path / f"{name}_series", data, oblique_affine(), compression=compression)
        module.write_dicom(tmp_path / f"{name}.dcm", data, oblique_affine(), compression=compression)
    assert (tmp_path / "port.dcm").read_bytes() == (tmp_path / "jax.dcm").read_bytes()
    names = sorted(p.name for p in (tmp_path / "port_series").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax_series").iterdir())
    for file in names:
        assert (tmp_path / "port_series" / file).read_bytes() == (tmp_path / "jax_series" / file).read_bytes()
    for path in (tmp_path / "port_series", tmp_path / "port.dcm"):
        got = (jax_dicom.read_dicom_dir if path.is_dir() else jax_dicom.read_dicom_file)(path)
        np.testing.assert_allclose(got[1], oblique_affine(), atol=1e-6)
        if dtype != np.float32:
            np.testing.assert_array_equal(got[0], data)


def test_writer_takes_tensors_and_refuses_as_the_jax_package(tmp_path):
    data = volume(np.int16, seed=12)
    port_dicom.write_dicom(tmp_path / "t.dcm", torch.from_numpy(data), tt.AffineMatrix(oblique_affine()))
    np.testing.assert_array_equal(jax_dicom.read_dicom_file(tmp_path / "t.dcm")[0], data)
    for module in (jax_dicom, port_dicom):
        with pytest.raises(ValueError, match="single-channel"):
            module.write_dicom(tmp_path / "x.dcm", np.zeros((2, 3, 3, 3), np.int16))
        with pytest.raises(ValueError, match="Unsupported DICOM compression"):
            module.write_dicom(tmp_path / "x.dcm", np.zeros((1, 3, 3, 3), np.int16), compression="zip")


def test_image_save_routes_to_dicom(tmp_path):
    """``Image.save``/``write_image``: a ``.dcm`` path writes one
    multi-frame file, a directory a series; both read back."""
    data = volume(np.int16, seed=13)
    image = tt.ScalarImage(data, affine=oblique_affine())
    image.save(tmp_path / "volume.dcm")
    (tmp_path / "series").mkdir()
    image.save(tmp_path / "series")
    port_write.write_image(f"{tmp_path}/other/", data, oblique_affine())
    for path in (tmp_path / "volume.dcm", tmp_path / "series", tmp_path / "other"):
        np.testing.assert_array_equal(assert_same_read(path), data)
