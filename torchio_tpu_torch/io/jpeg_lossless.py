"""JPEG Lossless (ITU T.81 process 14) codec on the host.

The port's copy of ``torchio_tpu/io/jpeg_lossless.py``. The DICOM
transfer syntaxes 1.2.840.10008.1.2.4.57 (process 14) and .70 (process
14, first-order selection value 1), the usual compressed syntax of
clinical CT archives, encapsulate this format.

- :func:`decode_lossless_jpeg` decodes through the package's native
  library (``native.jpegll_decode``, ``fastnifti.cpp``); a stream with
  restart intervals, which that decoder declines by design, and any
  stream it refuses go to :func:`decode_lossless_jpeg_python`, the plain
  version: single-component scans, predictors 1-7, point transform,
  restart intervals (the scan splits at RSTn markers into independent
  segments, the prediction reset to the T.81 default in each) and byte
  stuffing.
- :func:`encode_lossless_jpeg` writes single-component streams with any
  predictor 1-7 and optional restart intervals, and a canonical
  per-category Huffman table (the DICOM writer's
  ``compression="jpeg-lossless"``).
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

# marker bytes
SOI, EOI = 0xD8, 0xD9
SOF3 = 0xC3
DHT, SOS, DRI = 0xC4, 0xDA, 0xDD


class _BitReader:
    __slots__ = ("data", "pos", "bitbuf", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bitbuf = 0
        self.nbits = 0

    def _fill(self):
        while self.nbits <= 24:
            if self.pos >= len(self.data):
                self.bitbuf <<= 8
                self.nbits += 8
                continue
            byte = self.data[self.pos]
            self.pos += 1
            if byte == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 1  # stuffed
                else:
                    # a marker ends the data: zeros from here on
                    self.pos -= 1
                    self.bitbuf <<= 8
                    self.nbits += 8
                    continue
            self.bitbuf = (self.bitbuf << 8) | byte
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        value = (self.bitbuf >> self.nbits) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.nbits) - 1
        return value

    def peek16(self) -> int:
        if self.nbits < 16:
            self._fill()
        return (self.bitbuf >> (self.nbits - 16)) & 0xFFFF


def _build_huffman(bits: list[int], values: list[int]) -> dict[int, tuple[int, int]]:
    """Canonical codes as a 16-bit lookup: every 16-bit window that starts
    with a code maps to (code length, value)."""
    fast = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            prefix = code << (16 - length)
            for tail in range(1 << (16 - length)):
                fast[prefix | tail] = (length, values[k])
            code += 1
            k += 1
        code <<= 1
    return fast


def _extend(value: int, ssss: int) -> int:
    """T.81 EXTEND: map magnitude bits to signed difference."""
    if ssss == 0:
        return 0
    if ssss == 16:
        return 32768
    if value < (1 << (ssss - 1)):
        return value - (1 << ssss) + 1
    return value


def decode_lossless_jpeg(stream: bytes) -> np.ndarray:
    """Decode a single-component JPEG lossless (SOF3) stream to a
    (height, width) uint8 (precision <= 8) or uint16 array, through the
    native decoder (see the module docstring for what it declines)."""
    return native.jpegll_decode(stream)


def decode_lossless_jpeg_python(stream: bytes) -> np.ndarray:
    """The plain decoder: :func:`decode_lossless_jpeg` in Python."""
    if stream[:2] != bytes([0xFF, SOI]):
        raise ValueError("Not a JPEG stream")
    pos = 2
    precision = height = width = None
    tables = {}
    predictor = 1
    point_transform = 0
    restart_interval = 0
    scan_start = None
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            raise ValueError(f"Bad marker at {pos}")
        marker = stream[pos + 1]
        pos += 2
        if marker == EOI:
            break
        length = struct.unpack_from(">H", stream, pos)[0]
        seg = stream[pos + 2 : pos + length]
        if marker == SOF3:
            precision, height, width, ncomp = struct.unpack_from(">BHHB", seg, 0)
            if ncomp != 1:
                raise ValueError(f"Only single-component lossless JPEG supported, got {ncomp}")
        elif marker == DHT:
            off = 0
            while off < len(seg):
                table_id = seg[off]
                bits = list(seg[off + 1 : off + 17])
                n = sum(bits)
                values = list(seg[off + 17 : off + 17 + n])
                tables[table_id & 0x0F] = _build_huffman(bits, values)
                off += 17 + n
        elif marker == DRI:
            restart_interval = struct.unpack_from(">H", seg, 0)[0]
        elif marker == SOS:
            ns = seg[0]
            if ns != 1:
                raise ValueError("Only one scan component supported")
            table_id = seg[2] >> 4
            predictor = seg[1 + 2 * ns]
            point_transform = seg[3 + 2 * ns] & 0x0F
            scan_start = pos + length
            break
        pos += length
    if scan_start is None or precision is None:
        raise ValueError("Missing SOF3/SOS segments")
    table = tables[table_id]
    scan = stream[scan_start:]
    # Restart intervals: the entropy-coded data between RSTn markers are
    # independent segments (T.81 H.1.2.2), split before the bits are read
    # so that one segment's lookahead never swallows the marker or leaks
    # padding into the next; the prediction restarts at the default.
    segments = _split_restart_segments(scan) if restart_interval else [scan]
    out = np.zeros((height, width), np.int32)
    default = 1 << (precision - point_transform - 1)

    def predict(r, c, fresh):
        if fresh:  # first sample of the scan or of a restart interval
            return default
        if r == 0:
            return int(out[r, c - 1])
        if c == 0:
            return int(out[r - 1, c])
        a = int(out[r, c - 1])
        b = int(out[r - 1, c])
        cc = int(out[r - 1, c - 1])
        if predictor == 1:
            return a
        if predictor == 2:
            return b
        if predictor == 3:
            return cc
        if predictor == 4:
            return a + b - cc
        if predictor == 5:
            return a + ((b - cc) >> 1)
        if predictor == 6:
            return b + ((a - cc) >> 1)
        if predictor == 7:
            return (a + b) >> 1
        raise ValueError(f"Unsupported predictor {predictor}")

    reader = _BitReader(segments[0])
    segment_index = 0
    count = 0
    for r in range(height):
        for c in range(width):
            fresh = count == 0
            if restart_interval and count and count % restart_interval == 0:
                segment_index += 1
                if segment_index >= len(segments):
                    raise ValueError("Truncated restart-interval stream")
                reader = _BitReader(segments[segment_index])
                fresh = True
            length, ssss = table[reader.peek16()]
            reader.read(length)
            diff = _extend(reader.read(ssss) if ssss < 16 else 0, ssss)
            out[r, c] = (predict(r, c, fresh) + diff) & 0xFFFF
            count += 1
    out &= (1 << precision) - 1
    return (out << point_transform).astype(np.uint16 if precision > 8 else np.uint8)


def _split_restart_segments(scan: bytes) -> list[bytes]:
    """Split entropy-coded data at RSTn markers (0xFFD0-0xFFD7),
    respecting byte stuffing (0xFF 0x00 stays inside a segment)."""
    segments: list[bytes] = []
    start = 0
    i = 0
    n = len(scan)
    while i + 1 < n:
        if scan[i] == 0xFF:
            nxt = scan[i + 1]
            if 0xD0 <= nxt <= 0xD7:
                segments.append(scan[start:i])
                i += 2
                start = i
                continue
            if nxt == 0x00:
                i += 2
                continue
        i += 1
    segments.append(scan[start:])
    return segments


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, bits: int):
        for i in range(bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0x00)
                self.acc = 0
                self.n = 0

    def flush(self) -> bytes:
        while self.n:
            self.write(1, 1)  # pad with ones per T.81
        return bytes(self.out)


def _predict(image: np.ndarray, r: int, c: int, predictor: int) -> int:
    """T.81 H.1.2.1 prediction of sample (r, c) away from the first row and
    column."""
    a = int(image[r, c - 1])
    b = int(image[r - 1, c])
    cc = int(image[r - 1, c - 1])
    return {
        1: a,
        2: b,
        3: cc,
        4: a + b - cc,
        5: a + ((b - cc) >> 1),
        6: b + ((a - cc) >> 1),
        7: (a + b) >> 1,
    }[predictor]


def encode_lossless_jpeg(
    image: np.ndarray,
    precision: int | None = None,
    restart_interval: int = 0,
    predictor: int = 1,
) -> bytes:
    """Encode a 2D uint8/uint16 array as JPEG lossless (process 14).

    ``predictor`` selects the T.81 H.1.2.1 prediction (1-7; the DICOM
    transfer syntax 1.2.840.10008.1.2.4.70 pins selection value 1, the
    default). ``restart_interval`` emits a DRI segment and RSTn markers
    every that many samples (DICOM writers leave it 0).
    """
    image = np.asarray(image)
    if not 1 <= predictor <= 7:
        raise ValueError(f"predictor must be 1-7, got {predictor}")
    if precision is None:
        precision = 16 if image.dtype.itemsize == 2 else 8
    height, width = image.shape
    # A canonical Huffman table for categories 0-16: category v gets
    # length v + 2 (at most 16), so the Kraft sum stays below 1 and the
    # all-ones codeword, which T.81 Annex C reserves, is never assigned.
    lengths = {v: min(v + 2, 16) for v in range(17)}
    bits = [0] * 16
    for ln in lengths.values():
        bits[ln - 1] += 1
    ordered = sorted(lengths, key=lambda v: (lengths[v], v))
    codes = {}
    code = 0
    prev_len = 0
    for v in ordered:
        ln = lengths[v]
        code <<= ln - prev_len
        codes[v] = (ln, code)
        code += 1
        prev_len = ln

    writer = _BitWriter()
    default = 1 << (precision - 1)
    rst_index = 0
    count = 0
    for r in range(height):
        for c in range(width):
            if restart_interval and count and count % restart_interval == 0:
                writer.out = bytearray(writer.flush())
                writer.acc = writer.n = 0
                writer.out += bytes([0xFF, 0xD0 + rst_index])
                rst_index = (rst_index + 1) % 8
            fresh = count == 0 or (restart_interval and count % restart_interval == 0)
            if fresh:
                pred = default
            elif r == 0:
                pred = int(image[r, c - 1])
            elif c == 0:
                pred = int(image[r - 1, c])
            else:
                pred = _predict(image, r, c, predictor)
            count += 1
            diff = (int(image[r, c]) - pred) & 0xFFFF
            if diff >= 32768:
                diff -= 65536
            ssss = 0 if diff == 0 else max(diff.bit_length(), (-diff).bit_length())
            if diff in (32768, -32768):
                ssss = 16
            ln, code_val = codes[ssss]
            writer.write(code_val, ln)
            if ssss and ssss < 16:
                magnitude = diff if diff >= 0 else diff + (1 << ssss) - 1
                writer.write(magnitude & ((1 << ssss) - 1), ssss)
    scan = writer.flush()

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    sof = struct.pack(">BHHB", precision, height, width, 1) + bytes([0x00, 0x11, 0x00])
    dht_payload = bytes([0x00]) + bytes(bits) + bytes(ordered)
    # one component, table 0; Ss carries the predictor's selection value
    sos = bytes([1, 0x00, 0x00, predictor, 0, 0])
    dri = seg(DRI, struct.pack(">H", restart_interval)) if restart_interval else b""
    return (
        bytes([0xFF, SOI])
        + seg(SOF3, sof)
        + seg(DHT, dht_payload)
        + dri
        + seg(SOS, sos)
        + scan
        + bytes([0xFF, EOI])
    )
