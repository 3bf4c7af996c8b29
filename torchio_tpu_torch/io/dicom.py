"""DICOM reader and writer on the host (numpy, no pydicom or GDCM).

The port's copy of ``torchio_tpu/io/dicom.py``, read for read and byte
for byte:

- implicit/explicit VR little endian and explicit VR big endian parsing,
- encapsulated (compressed) PixelData: RLE Lossless, JPEG Lossless
  (processes 14 and SV1) and JPEG-LS (lossless and near-lossless),
  decoded here and in the package's native library (:mod:`..native`);
  JPEG baseline/extended and JPEG 2000 through Pillow when it is
  installed,
- single- and multi-frame files, grayscale and RGB (SamplesPerPixel 3,
  interleaved or planar, YBR_FULL converted); series directories sorted
  by ImagePositionPatient along the slice normal,
- the LPS -> RAS affine and the rescale slope/intercept (integer pixels
  stay integers unless a rescale is stored).

:func:`write_dicom` (one multi-frame file) and :func:`write_dicom_series`
(one file a slice) write explicit VR little endian, RLE, JPEG Lossless
SV1 or JPEG-LS Lossless. Voxels stay numpy here;
:class:`..data.image.Image` turns them into a tensor on its device.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .nifti import _host_array

_TAGS = {
    (0x0002, 0x0010): "transfer_syntax",
    (0x0020, 0x0032): "position",  # ImagePositionPatient
    (0x0020, 0x0037): "orientation",  # ImageOrientationPatient
    (0x0028, 0x0002): "samples_per_pixel",
    (0x0028, 0x0006): "planar_configuration",
    (0x0028, 0x0004): "photometric",
    (0x0028, 0x0008): "num_frames",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "cols",
    (0x0028, 0x0030): "pixel_spacing",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
    (0x0018, 0x0050): "slice_thickness",
    (0x0018, 0x0088): "spacing_between_slices",
    (0x7FE0, 0x0010): "pixel_data",
}

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}

IMPLICIT_LITTLE = "1.2.840.10008.1.2"
EXPLICIT_LITTLE = "1.2.840.10008.1.2.1"
EXPLICIT_BIG = "1.2.840.10008.1.2.2"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_P14 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR = "1.2.840.10008.1.2.4.81"
J2K_LOSSLESS = "1.2.840.10008.1.2.4.90"
J2K = "1.2.840.10008.1.2.4.91"

#: Syntaxes whose PixelData is encapsulated in item fragments.
_ENCAPSULATED = {
    RLE_LOSSLESS, JPEG_BASELINE, JPEG_EXTENDED,
    JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS, JPEG_LS_NEAR, J2K_LOSSLESS, J2K,
}
_PIL_SYNTAXES = {JPEG_BASELINE, JPEG_EXTENDED, J2K_LOSSLESS, J2K}
_NATIVE_JPEG_SYNTAXES = {JPEG_LOSSLESS_P14, JPEG_LOSSLESS_SV1}
_JPEG_LS_SYNTAXES = {JPEG_LS_LOSSLESS, JPEG_LS_NEAR}

_SUPPORTED_SYNTAXES = {IMPLICIT_LITTLE, EXPLICIT_LITTLE, EXPLICIT_BIG} | _ENCAPSULATED

_ITEM = (0xFFFE, 0xE000)
_ITEM_DELIMITER = (0xFFFE, 0xE00D)
_SEQUENCE_DELIMITER = (0xFFFE, 0xE0DD)
_UNDEFINED = 0xFFFFFFFF


class _ElementParser:
    """Minimal streaming parser over one top-level DICOM dataset."""

    def __init__(self, raw: bytes, explicit: bool, big: bool):
        self.raw = raw
        self.explicit = explicit
        self.e = ">" if big else "<"

    def _header(self, pos: int) -> tuple[tuple[int, int], bytes, int, int]:
        """((group, element), vr, value length, position of value)."""
        raw = self.raw
        group, element = struct.unpack_from(self.e + "HH", raw, pos)
        pos += 4
        if self.explicit and group != 0xFFFE:
            vr = raw[pos : pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from(self.e + "I", raw, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from(self.e + "H", raw, pos + 2)[0]
                pos += 4
        else:
            vr = b""
            length = struct.unpack_from(self.e + "I", raw, pos)[0]
            pos += 4
        return (group, element), vr, length, pos

    def parse(self, pos: int, stop: tuple[int, int] | None = None) -> tuple[dict, int]:
        """Collect the tags we need until end-of-data or ``stop`` tag."""
        out: dict = {}
        n = len(self.raw)
        while pos + 8 <= n:
            key, vr, length, pos = self._header(pos)
            if stop is not None and key == stop:
                return out, pos
            if length == _UNDEFINED:
                if key == (0x7FE0, 0x0010):
                    out["pixel_fragments"], pos = self._fragments(pos)
                    break
                # undefined-length sequence: walk its items and discard
                pos = self._skip_sequence(pos)
                continue
            if key in _TAGS:
                out[_TAGS[key]] = self.raw[pos : pos + length]
            if key == (0x7FE0, 0x0010):
                break  # pixel data is last for our purposes
            pos += length
        return out, pos

    def _skip_sequence(self, pos: int) -> int:
        """Skip an undefined-length SQ: items until the sequence delimiter."""
        n = len(self.raw)
        while pos + 8 <= n:
            key, _vr, length, pos = self._header(pos)
            if key == _SEQUENCE_DELIMITER:
                return pos
            if key != _ITEM:
                raise ValueError(f"Malformed sequence: unexpected tag {key}")
            if length == _UNDEFINED:
                _, pos = self.parse(pos, stop=_ITEM_DELIMITER)
            else:
                pos += length
        return pos

    def _fragments(self, pos: int) -> tuple[list[bytes], int]:
        """Encapsulated PixelData: basic offset table + fragment items.

        Item tags inside encapsulated pixel data are always little
        endian (encapsulation only occurs with little-endian syntaxes).
        """
        raw = self.raw
        fragments: list[bytes] = []
        first = True
        while pos + 8 <= len(raw):
            group, element = struct.unpack_from("<HH", raw, pos)
            length = struct.unpack_from("<I", raw, pos + 4)[0]
            pos += 8
            if (group, element) == _SEQUENCE_DELIMITER:
                break
            if (group, element) != _ITEM:
                raise ValueError("Malformed encapsulated pixel data")
            if first:
                first = False  # basic offset table — ignored
            else:
                fragments.append(raw[pos : pos + length])
            pos += length
        return fragments, pos


def _decode_ds(value: bytes) -> list[float]:
    return [float(v) for v in value.decode("ascii", "ignore").strip("\x00 ").split("\\") if v]


def _decode_us(value: bytes | None, big: bool, default: int = 0) -> int:
    """Binary US value. NEVER sniffed as text: a 2-byte US whose bytes
    happen to be ASCII digits (e.g. Rows=49 stored as b'1\\x00') must
    decode as the binary 49, not the text 1. ``default`` is an INT so
    absent tags decode identically under either endianness."""
    if value is None or len(value) < 2:
        return default
    return struct.unpack((">" if big else "<") + "H", value[:2])[0]


def _decode_is(value: bytes) -> int:
    """ASCII IS value (e.g. NumberOfFrames)."""
    text = value.decode("ascii", "ignore").strip("\x00 ")
    try:
        return int(text)
    except ValueError:
        return 0


# --------------------------------------------------------------------------
# Frame codecs
# --------------------------------------------------------------------------


def _packbits_decode(data: bytes, expected: int) -> bytes:
    """PackBits (DICOM RLE segment) decoding."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        control = data[i]
        i += 1
        if control < 128:
            run = control + 1
            out += data[i : i + run]
            i += run
        elif control > 128:
            out += bytes([data[i]]) * (257 - control)
            i += 1
        # 128: no-op
    if len(out) < expected:
        out += bytes(expected - len(out))
    return bytes(out[:expected])


def _packbits_encode(data: bytes) -> bytes:
    """PackBits encoding (for RLE writing and round-trip tests)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find run length at i
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal stretch: until the next >=3 run or 128 bytes
        start = i
        i += 1
        while i < n and i - start < 128:
            if i + 2 < n and data[i] == data[i + 1] == data[i + 2]:
                break
            i += 1
        out.append(i - start - 1)
        out += data[start:i]
    return bytes(out)


def _decode_rle_frame(
    frame: bytes, rows: int, cols: int, dtype, spp: int = 1
) -> np.ndarray:
    """DICOM RLE Lossless: 64-byte header (segment count + offsets), one
    PackBits-coded byte plane per segment — itemsize planes per sample
    channel, most significant plane first, channels in order."""
    header = struct.unpack_from("<16I", frame, 0)
    nseg = header[0]
    offsets = list(header[1 : 1 + nseg])
    itemsize = np.dtype(dtype).itemsize
    if nseg != itemsize * spp:
        raise ValueError(
            f"RLE frame has {nseg} segments for itemsize {itemsize} x"
            f" {spp} samples/pixel"
        )
    count = rows * cols
    planes = []
    for i, off in enumerate(offsets):
        end = offsets[i + 1] if i + 1 < nseg else len(frame)
        planes.append(
            np.frombuffer(_packbits_decode(frame[off:end], count), np.uint8)
        )
    channels = []
    for ch in range(spp):
        chunk = planes[ch * itemsize : (ch + 1) * itemsize]
        if itemsize == 1:
            channels.append(chunk[0].astype(dtype).reshape(rows, cols))
            continue
        value = np.zeros(count, np.uint32)
        for k, plane in enumerate(chunk):  # MSB first
            value |= plane.astype(np.uint32) << (8 * (itemsize - 1 - k))
        channels.append(
            value.astype(f"<u{itemsize}").view(dtype).reshape(rows, cols)
        )
    return np.stack(channels, axis=-1)


def _encode_rle_frame(pixels: np.ndarray) -> bytes:
    """Inverse of :func:`_decode_rle_frame` for one (rows, cols) frame."""
    arr = np.ascontiguousarray(pixels)
    itemsize = arr.dtype.itemsize
    flat = arr.reshape(-1).view(f"u{itemsize}".encode().decode())
    segments = []
    for k in range(itemsize):  # MSB first
        plane = ((flat >> (8 * (itemsize - 1 - k))) & 0xFF).astype(np.uint8)
        seg = _packbits_encode(plane.tobytes())
        if len(seg) % 2:
            seg += b"\x00"
        segments.append(seg)
    offsets = []
    pos = 64
    for seg in segments:
        offsets.append(pos)
        pos += len(seg)
    header = struct.pack(
        "<16I", len(segments), *offsets, *([0] * (15 - len(offsets)))
    )
    return header + b"".join(segments)


def _ybr_full_to_rgb(frames: np.ndarray) -> np.ndarray:
    """Full-range YCbCr -> RGB (DICOM PS3.3 C.7.6.3.1.2), uint8."""
    f = frames.astype(np.float64)
    y, cb, cr = f[..., 0], f[..., 1] - 128.0, f[..., 2] - 128.0
    rgb = np.stack(
        [
            y + 1.402 * cr,
            y - 0.344136 * cb - 0.714136 * cr,
            y + 1.772 * cb,
        ],
        axis=-1,
    )
    return np.clip(np.round(rgb), 0, 255).astype(frames.dtype)


def _decode_pil_frame(frame: bytes, dtype, spp: int = 1) -> np.ndarray:
    """JPEG baseline/extended and JPEG 2000 frames via Pillow."""
    try:
        import io as _io

        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            "Decoding JPEG/JPEG2000 DICOM requires Pillow: pip install pillow"
        ) from e
    img = PILImage.open(_io.BytesIO(frame))
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] > spp:  # e.g. RGB-coded grayscale: keep spp channels
        arr = arr[..., :spp]
    return arr.astype(dtype, copy=False)


def _decode_frames(
    tags: dict, syntax: str, rows, cols, n_frames, dtype, big, spp=1, planar=0
):
    """(n_frames, rows, cols, spp) pixel array from raw or encapsulated
    data (``spp`` = SamplesPerPixel; RGB ultrasound/secondary captures
    carry 3)."""
    if "pixel_fragments" in tags:
        fragments = tags["pixel_fragments"]
        if n_frames == 1 and len(fragments) > 1:
            # a single frame split across fragments: concatenating is
            # correct for JPEG streams and RLE alike
            fragments = [b"".join(fragments)]
        elif n_frames > 1 and len(fragments) != n_frames:
            raise ValueError(
                f"{len(fragments)} fragments for {n_frames} frames"
                " is not supported"
            )
        if syntax == RLE_LOSSLESS:
            frames = [
                _decode_rle_frame(f, rows, cols, dtype, spp) for f in fragments
            ]
        elif syntax in _NATIVE_JPEG_SYNTAXES:
            if spp != 1:
                raise ValueError(
                    "JPEG Lossless color (SamplesPerPixel > 1) is not"
                    " supported"
                )
            from .jpeg_lossless import decode_lossless_jpeg

            frames = [
                decode_lossless_jpeg(f).astype(dtype, copy=False)[..., None]
                for f in fragments
            ]
        elif syntax in _JPEG_LS_SYNTAXES:
            from .jpeg_ls import decode_jpeg_ls

            frames = []
            for f in fragments:
                plane = decode_jpeg_ls(f).astype(dtype, copy=False)
                if plane.ndim == 2:
                    plane = plane[..., None]
                if plane.shape[-1] != spp:
                    raise ValueError(
                        f"JPEG-LS frame has {plane.shape[-1]} components,"
                        f" SamplesPerPixel says {spp}"
                    )
                frames.append(plane)
        else:
            frames = [_decode_pil_frame(f, dtype, spp) for f in fragments]
        return np.stack(frames)
    count = rows * cols * n_frames * spp
    byte_order = ">" if big else "<"
    pixels = np.frombuffer(
        tags["pixel_data"],
        dtype=np.dtype(dtype).newbyteorder(byte_order),
        count=count,
    ).astype(np.dtype(dtype).newbyteorder("="), copy=False)
    if planar and spp > 1:
        # planar configuration 1: all of channel 0, then channel 1, ...
        frames = pixels.reshape(n_frames, spp, rows, cols)
        return np.moveaxis(frames, 1, -1)
    return pixels.reshape(n_frames, rows, cols, spp)


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------


class DicomSlice:
    """One parsed DICOM file (single- or multi-frame)."""

    def __init__(self, path: Path):
        raw = Path(path).read_bytes()
        syntax = ""
        if raw[128:132] == b"DICM":
            # Walk ONLY the file-meta group (always explicit VR little
            # endian) — the main dataset may use another encoding, so
            # parsing past group 0x0002 with the meta parser would
            # misread lengths and can reject valid files.
            parser = _ElementParser(raw, True, False)
            pos = 132
            transfer_syntax = b""
            while pos + 8 <= len(raw):
                key, _vr, length, value_pos = parser._header(pos)
                if key[0] != 0x0002:
                    break
                if key == (0x0002, 0x0010):
                    transfer_syntax = raw[value_pos : value_pos + length]
                pos = value_pos + length
            syntax = transfer_syntax.decode("ascii", "ignore").strip("\x00 ")
            if syntax and syntax not in _SUPPORTED_SYNTAXES:
                raise ValueError(
                    f"Unsupported DICOM transfer syntax {syntax!r} (supported:"
                    " little/big endian, RLE, JPEG lossless, JPEG-LS,"
                    " JPEG baseline, JPEG 2000)"
                )
            explicit = syntax != IMPLICIT_LITTLE
            big = syntax == EXPLICIT_BIG
            tags, _ = _ElementParser(raw, explicit, big).parse(pos)
        else:
            big = False
            tags, _ = _ElementParser(raw, False, False).parse(0)
        self.syntax = syntax
        self.rows = _decode_us(tags["rows"], big)
        self.cols = _decode_us(tags["cols"], big)
        self.num_frames = max(_decode_is(tags.get("num_frames", b"1")), 1)
        bits = _decode_us(tags.get("bits_allocated"), big, 16)
        signed = _decode_us(tags.get("pixel_representation"), big, 0)
        self.position = np.array(
            _decode_ds(tags.get("position", b"0\\0\\0")), np.float64
        )
        orient = _decode_ds(tags.get("orientation", b"1\\0\\0\\0\\1\\0"))
        self.row_dir = np.array(orient[:3], np.float64)
        self.col_dir = np.array(orient[3:6], np.float64)
        spacing = _decode_ds(tags.get("pixel_spacing", b"1\\1"))
        self.spacing_rc = (spacing[0], spacing[1])  # (row, col) in mm
        self.slope = _decode_ds(tags.get("rescale_slope", b"1"))[0]
        self.intercept = _decode_ds(tags.get("rescale_intercept", b"0"))[0]
        between = tags.get("spacing_between_slices") or tags.get(
            "slice_thickness"
        )
        self.slice_spacing = _decode_ds(between)[0] if between else 1.0
        dtype = {
            (8, 0): np.uint8, (8, 1): np.int8,
            (16, 0): np.uint16, (16, 1): np.int16,
            (32, 0): np.uint32, (32, 1): np.int32,
        }[(bits, signed)]
        self.samples_per_pixel = max(
            _decode_us(tags.get("samples_per_pixel"), big, 1), 1
        )
        planar = _decode_us(tags.get("planar_configuration"), big, 0)
        self.photometric = (
            tags.get("photometric", b"").decode("ascii", "ignore").strip("\x00 ")
        )
        self.frames = _decode_frames(
            tags, syntax, self.rows, self.cols, self.num_frames, dtype, big,
            self.samples_per_pixel, planar,
        )  # (n_frames, rows, cols, samples_per_pixel)
        if self.samples_per_pixel == 3 and self.photometric.startswith("YBR"):
            if syntax in _PIL_SYNTAXES:
                pass  # Pillow already outputs RGB for YCbCr JPEG streams
            elif self.photometric == "YBR_FULL":
                self.frames = _ybr_full_to_rgb(self.frames)
            else:
                raise ValueError(
                    f"Unsupported color space {self.photometric!r} for"
                    " uncompressed/RLE pixel data (RGB and YBR_FULL are"
                    " supported)"
                )

    @property
    def pixels(self) -> np.ndarray:
        """(rows, cols) first frame, first channel (series files are
        single-frame; RGB series go through ``channels``)."""
        return self.frames[0, :, :, 0]

    @property
    def channels(self) -> np.ndarray:
        """(samples_per_pixel, rows, cols) — first frame, all channels."""
        return np.moveaxis(self.frames[0], -1, 0)

    def lps_affine(self) -> np.ndarray:
        """4x4 voxel (i=col, j=row, k=frame) -> LPS world map."""
        normal = np.cross(self.row_dir, self.col_dir)
        affine = np.eye(4)
        affine[:3, 0] = self.row_dir * self.spacing_rc[1]
        affine[:3, 1] = self.col_dir * self.spacing_rc[0]
        affine[:3, 2] = normal * self.slice_spacing
        affine[:3, 3] = self.position
        return affine


_LPS_TO_RAS = np.diag([-1.0, -1.0, 1.0, 1.0])


def read_dicom_dir(directory) -> tuple[np.ndarray, np.ndarray]:
    """Read a directory of single-frame DICOM files as one volume.

    Returns ``(data_cijk, affine)`` where voxel axes are
    (i=column, j=row, k=slice) and the affine maps to RAS+ world mm.
    """
    directory = Path(directory)
    paths = sorted(
        p for p in directory.iterdir()
        if p.is_file() and not p.name.startswith(".")
    )
    slices = []
    for p in paths:
        try:
            slices.append(DicomSlice(p))
        except (KeyError, ValueError, struct.error):
            continue
    if not slices:
        raise ValueError(f"No readable DICOM slices found in {directory}")
    normal = np.cross(slices[0].row_dir, slices[0].col_dir)
    slices.sort(key=lambda s: float(np.dot(s.position, normal)))
    volume = np.stack([s.channels for s in slices])  # (k, spp, row=j, col=i)
    data = np.transpose(volume, (1, 3, 2, 0))  # (spp, i, j, k)
    first = slices[0]
    affine = first.lps_affine()
    if len(slices) > 1:
        affine[:3, 2] = slices[1].position - first.position
    affine = _LPS_TO_RAS @ affine
    arr = data
    if first.slope != 1.0 or first.intercept != 0.0:
        arr = data.astype(np.float32) * first.slope + first.intercept
    return np.ascontiguousarray(arr), affine


def read_dicom_file(path) -> tuple[np.ndarray, np.ndarray]:
    """Read one (possibly multi-frame) DICOM file.

    Returns ``(data_cijk, affine)`` with frames along k.
    """
    s = DicomSlice(Path(path))
    # (n_frames, rows, cols, spp) -> (spp, i=col, j=row, k=frame)
    data = np.transpose(s.frames, (3, 2, 1, 0))
    if s.slope != 1.0 or s.intercept != 0.0:
        data = data.astype(np.float32) * s.slope + s.intercept
    affine = _LPS_TO_RAS @ s.lps_affine()
    return np.ascontiguousarray(data), affine


def is_dicom(path) -> bool:
    path = Path(path)
    try:
        with open(path, "rb") as f:
            head = f.read(132)
        return head[128:132] == b"DICM"
    except (OSError, IsADirectoryError):
        return False


class DicomBackend:
    """Eager backend over a DICOM series directory (or single file)."""

    def __init__(self, source):
        source = Path(source)
        if source.is_dir():
            self._data, self._affine = read_dicom_dir(source)
        else:
            self._data, self._affine = read_dicom_file(source)

    @property
    def shape(self):
        return self._data.shape

    @property
    def affine(self):
        return self._affine

    @property
    def dtype(self):
        return self._data.dtype

    def __getitem__(self, slices):
        return np.asarray(self._data[slices])

    def to_array(self):
        return self._data

    to_tensor = to_array


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

_SC_SINGLE = "1.2.840.10008.5.1.4.1.1.7"  # Secondary Capture
_SC_MULTI_WORD = "1.2.840.10008.5.1.4.1.1.7.4"  # Multi-frame True Color.. SC word
_IMPLEMENTATION_UID = "2.25.307515210676871896743818217742251628250"


def _new_uid() -> str:
    """UUID-derived UID under the 2.25 root (ITU-T X.667)."""
    import uuid

    return f"2.25.{uuid.uuid4().int}"


def _pad_even(value: bytes, pad: bytes = b"\x00") -> bytes:
    return value + pad if len(value) % 2 else value


def _el(group: int, element: int, vr: bytes, value: bytes) -> bytes:
    """One explicit-VR little-endian data element."""
    value = _pad_even(value, b" " if vr in (b"DS", b"IS", b"CS", b"LO") else b"\x00")
    head = struct.pack("<HH", group, element) + vr
    if vr in _EXPLICIT_LONG_VRS:
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def _ds(*values: float) -> bytes:
    return "\\".join(f"{v:.10g}" for v in values).encode("ascii")


def _quantize(data: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Map array data to storable int16/uint16 + rescale slope/intercept."""
    if data.dtype in (np.uint8, np.int8, np.uint16, np.int16):
        return data, 1.0, 0.0
    if np.issubdtype(data.dtype, np.integer):
        lo, hi = float(data.min()), float(data.max())
        if -32768 <= lo and hi <= 32767:
            return data.astype(np.int16), 1.0, 0.0
        if 0 <= lo and hi <= 65535:
            return data.astype(np.uint16), 1.0, 0.0
    lo, hi = float(data.min()), float(data.max())
    if hi == lo:
        return np.zeros(data.shape, np.uint16), 1.0, lo
    slope = (hi - lo) / 65535.0
    stored = np.round((data.astype(np.float64) - lo) / slope).astype(np.uint16)
    return stored, slope, lo


def _encapsulate(frames: list[bytes]) -> bytes:
    """Wrap encoded frames as encapsulated PixelData item fragments."""
    parts = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]  # empty offset table
    for frame in frames:
        frame = _pad_even(frame)
        parts.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frame)) + frame)
    parts.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    return b"".join(parts)


def _write_dicom_file(
    path: Path,
    frames: np.ndarray,  # (n_frames, rows, cols), int16/uint16/uint8/int8
    *,
    lps_position: np.ndarray,
    row_dir: np.ndarray,
    col_dir: np.ndarray,
    spacing_rc: tuple[float, float],
    slice_spacing: float,
    slope: float,
    intercept: float,
    series_uid: str,
    study_uid: str,
    instance_number: int,
    compression: str | None,
) -> None:
    n_frames, rows, cols = frames.shape
    bits = frames.dtype.itemsize * 8
    signed = 1 if np.issubdtype(frames.dtype, np.signedinteger) else 0
    sop_class = _SC_SINGLE if n_frames == 1 else _SC_MULTI_WORD
    sop_uid = _new_uid()

    if compression is None:
        syntax = EXPLICIT_LITTLE
        pixel_bytes = np.ascontiguousarray(frames).astype(
            frames.dtype.newbyteorder("<")
        ).tobytes()
        pixel_element = _el(0x7FE0, 0x0010, b"OW", pixel_bytes)
    elif compression in ("rle", "jpeg-lossless", "jpeg-ls"):
        if compression == "rle":
            syntax = RLE_LOSSLESS
            encoded = [_encode_rle_frame(f) for f in frames]
        elif compression == "jpeg-ls":
            from .jpeg_ls import encode_jpeg_ls

            syntax = JPEG_LS_LOSSLESS
            encoded = [
                encode_jpeg_ls(np.ascontiguousarray(f).view(f"u{f.dtype.itemsize}"))
                for f in frames
            ]
        else:
            from .jpeg_lossless import encode_lossless_jpeg

            syntax = JPEG_LOSSLESS_SV1
            encoded = [
                encode_lossless_jpeg(np.ascontiguousarray(f).view(f"u{f.dtype.itemsize}"))
                for f in frames
            ]
        body = _encapsulate(encoded)
        head = struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack(
            "<I", _UNDEFINED
        )
        pixel_element = head + body
    else:
        raise ValueError(
            f"Unsupported DICOM compression {compression!r}"
            " (None, 'rle', 'jpeg-lossless', or 'jpeg-ls')"
        )

    meta_body = b"".join(
        [
            _el(0x0002, 0x0001, b"OB", b"\x00\x01"),
            _el(0x0002, 0x0002, b"UI", sop_class.encode()),
            _el(0x0002, 0x0003, b"UI", sop_uid.encode()),
            _el(0x0002, 0x0010, b"UI", syntax.encode()),
            _el(0x0002, 0x0012, b"UI", _IMPLEMENTATION_UID.encode()),
        ]
    )
    meta = _el(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body))) + meta_body

    elements = [
        _el(0x0008, 0x0016, b"UI", sop_class.encode()),
        _el(0x0008, 0x0018, b"UI", sop_uid.encode()),
        _el(0x0008, 0x0060, b"CS", b"OT"),
        _el(0x0020, 0x000D, b"UI", study_uid.encode()),
        _el(0x0020, 0x000E, b"UI", series_uid.encode()),
        _el(0x0020, 0x0013, b"IS", str(instance_number).encode()),
        _el(0x0020, 0x0032, b"DS", _ds(*lps_position)),
        _el(0x0020, 0x0037, b"DS", _ds(*row_dir, *col_dir)),
        _el(0x0018, 0x0050, b"DS", _ds(slice_spacing)),
        _el(0x0018, 0x0088, b"DS", _ds(slice_spacing)),
        _el(0x0028, 0x0002, b"US", struct.pack("<H", 1)),
        _el(0x0028, 0x0004, b"CS", b"MONOCHROME2"),
    ]
    if n_frames > 1:
        elements.append(_el(0x0028, 0x0008, b"IS", str(n_frames).encode()))
    elements += [
        _el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _el(0x0028, 0x0030, b"DS", _ds(*spacing_rc)),
        _el(0x0028, 0x0100, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0101, b"US", struct.pack("<H", bits)),
        _el(0x0028, 0x0102, b"US", struct.pack("<H", bits - 1)),
        _el(0x0028, 0x0103, b"US", struct.pack("<H", signed)),
    ]
    if slope != 1.0 or intercept != 0.0:
        elements += [
            _el(0x0028, 0x1052, b"DS", _ds(intercept)),
            _el(0x0028, 0x1053, b"DS", _ds(slope)),
        ]
    elements.append(pixel_element)

    path.write_bytes(b"\x00" * 128 + b"DICM" + meta + b"".join(elements))


def _geometry_from_affine(affine: np.ndarray):
    """RAS affine -> (LPS affine, row_dir, col_dir, spacing, slice step)."""
    lps = np.asarray(_LPS_TO_RAS @ np.asarray(affine, np.float64))
    col_spacing = float(np.linalg.norm(lps[:3, 0]))
    row_spacing = float(np.linalg.norm(lps[:3, 1]))
    slice_spacing = float(np.linalg.norm(lps[:3, 2]))
    row_dir = lps[:3, 0] / (col_spacing or 1.0)  # direction of columns (i)
    col_dir = lps[:3, 1] / (row_spacing or 1.0)  # direction of rows (j)
    return lps, row_dir, col_dir, (row_spacing, col_spacing), slice_spacing


def _as_frames(data: np.ndarray) -> np.ndarray:
    """(C, I, J, K) -> (K, rows=J, cols=I); single channel only."""
    data = _host_array(data)
    if data.ndim == 3:
        data = data[None]
    if data.shape[0] != 1:
        raise ValueError(
            f"DICOM writing supports single-channel volumes, got C={data.shape[0]}"
        )
    return np.transpose(data[0], (2, 1, 0))


def write_dicom(path, data, affine=None, *, compression: str | None = None) -> None:
    """Write (C, I, J, K) data (numpy or a tensor on any device) and its
    RAS affine as ONE multi-frame DICOM file. ``compression`` picks the
    transfer syntax: None (explicit VR little endian), ``'rle'`` (RLE
    Lossless), ``'jpeg-lossless'`` (process 14, SV1) or ``'jpeg-ls'``
    (JPEG-LS Lossless, T.87).
    """
    path = Path(path)
    affine = np.eye(4) if affine is None else np.asarray(_host_array(affine), np.float64)
    frames = _as_frames(data)
    stored, slope, intercept = _quantize(frames)
    lps, row_dir, col_dir, spacing_rc, slice_spacing = _geometry_from_affine(affine)
    _write_dicom_file(
        path,
        stored,
        lps_position=lps[:3, 3],
        row_dir=row_dir,
        col_dir=col_dir,
        spacing_rc=spacing_rc,
        slice_spacing=slice_spacing,
        slope=slope,
        intercept=intercept,
        series_uid=_new_uid(),
        study_uid=_new_uid(),
        instance_number=1,
        compression=compression,
    )


def write_dicom_series(
    directory, data, affine=None, *, compression: str | None = None
) -> None:
    """Write (C, I, J, K) data + RAS affine as one-file-per-slice series."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    affine = np.eye(4) if affine is None else np.asarray(_host_array(affine), np.float64)
    frames = _as_frames(data)  # (K, rows, cols)
    stored, slope, intercept = _quantize(frames)
    lps, row_dir, col_dir, spacing_rc, slice_spacing = _geometry_from_affine(affine)
    series_uid = _new_uid()
    study_uid = _new_uid()
    width = max(4, len(str(len(stored))))
    for k, frame in enumerate(stored):
        _write_dicom_file(
            directory / f"IMG{k + 1:0{width}d}.dcm",
            frame[None],
            lps_position=lps[:3, 3] + k * lps[:3, 2],
            row_dir=row_dir,
            col_dir=col_dir,
            spacing_rc=spacing_rc,
            slice_spacing=slice_spacing,
            slope=slope,
            intercept=intercept,
            series_uid=series_uid,
            study_uid=study_uid,
            instance_number=k + 1,
            compression=compression,
        )
