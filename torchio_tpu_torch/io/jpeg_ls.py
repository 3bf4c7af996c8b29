"""JPEG-LS (ITU-T T.87 / ISO 14495-1, LOCO-I) codec on the host.

The port's copy of ``torchio_tpu/io/jpeg_ls.py``. The DICOM transfer
syntaxes 1.2.840.10008.1.2.4.80 (JPEG-LS Lossless) and .81 (JPEG-LS
Near-Lossless) encapsulate this format.

- :func:`decode_jpeg_ls` decodes through the package's native library
  (``native.jls_decode``, ``fastnifti.cpp``); a stream with restart
  intervals, LSE mapping tables or an interleaved multi-component scan,
  which that decoder declines by design, and any stream it refuses go to
  :func:`decode_jpeg_ls_python`, the plain version: regular
  (context-modelled Golomb) and run modes, LSE preset parameters,
  near-lossless (``NEAR > 0``), restart intervals (the state reset every
  DRI lines) and multi-component scans in interleave mode 0.
- :func:`encode_jpeg_ls` writes single-component scans, lossless or
  near-lossless (the DICOM writer's ``compression="jpeg-ls"``).

The run-interruption sign follows T.87 A.7.2 (``SIGN = -1`` when
``RItype == 0`` and ``Ra > Rb``) in both directions and in the native
decoder.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import native

SOI, EOI = 0xD8, 0xD9
SOF55 = 0xF7  # JPEG-LS frame header
LSE = 0xF8  # JPEG-LS preset parameters
SOS, DRI = 0xDA, 0xDD

# run-length code order (T.87 table A.2)
_J = [
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15,
]
_MIN_C, _MAX_C = -128, 127


class _Params:
    """Derived coding parameters (T.87 A.1, C.2.4.1.1)."""

    __slots__ = ("maxval", "near", "t1", "t2", "t3", "reset",
                 "range", "qbpp", "bpp", "limit")

    def __init__(self, maxval: int, near: int = 0,
                 t1: int | None = None, t2: int | None = None,
                 t3: int | None = None, reset: int = 64):
        if maxval < 1:
            raise ValueError(f"MAXVAL must be >= 1, got {maxval}")
        if near < 0 or near >= maxval:
            raise ValueError(f"NEAR must be in [0, MAXVAL), got {near}")
        self.maxval = maxval
        self.near = near
        dt1, dt2, dt3 = _default_thresholds(maxval, near)
        self.t1 = dt1 if t1 is None else t1
        self.t2 = dt2 if t2 is None else t2
        self.t3 = dt3 if t3 is None else t3
        self.reset = reset
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = (self.range - 1).bit_length()
        self.bpp = max(2, maxval.bit_length())
        self.limit = 2 * (self.bpp + max(8, self.bpp))


def _default_thresholds(maxval: int, near: int) -> tuple[int, int, int]:
    """T1..T3 defaults (T.87 C.2.4.1.1.1)."""

    def clamp(x, lo):
        return lo if (x > maxval or x < lo) else x

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor + 2 + 3 * near, near + 1)
        t2 = clamp(4 * factor + 3 + 5 * near, t1)
        t3 = clamp(17 * factor + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3


class _BitReader:
    """MSB-first reader with JPEG-LS marker stuffing: a byte following a
    0xFF data byte carries only 7 payload bits (its MSB is the stuffed
    0); 0xFF followed by a byte >= 0x80 is a marker and ends the scan
    (reads past it return zero bits)."""

    __slots__ = ("data", "pos", "acc", "n", "prev_ff")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.n = 0
        self.prev_ff = False

    def _fill(self):
        data, n_total = self.data, len(self.data)
        while self.n <= 24:
            if self.pos >= n_total:
                self.acc <<= 8
                self.n += 8
                continue
            b = data[self.pos]
            if self.prev_ff:
                self.acc = (self.acc << 7) | (b & 0x7F)
                self.n += 7
                self.prev_ff = False
                self.pos += 1
                continue
            if b == 0xFF:
                nxt = data[self.pos + 1] if self.pos + 1 < n_total else 0xD9
                if nxt & 0x80:  # marker: stop, zero-pad from here
                    self.pos = n_total
                    continue
                self.acc = (self.acc << 8) | 0xFF
                self.n += 8
                self.prev_ff = True
                self.pos += 1
                continue
            self.acc = (self.acc << 8) | b
            self.n += 8
            self.pos += 1

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self.n < nbits:
            self._fill()
        self.n -= nbits
        value = (self.acc >> self.n) & ((1 << nbits) - 1)
        self.acc &= (1 << self.n) - 1
        return value

    def read_unary(self) -> int:
        """Count of 0 bits before the next 1 bit (consumes the 1)."""
        count = 0
        while True:
            if self.n < 16:
                self._fill()
            window = (self.acc >> (self.n - 16)) & 0xFFFF
            if window == 0:
                self.n -= 16
                self.acc &= (1 << self.n) - 1
                count += 16
                if count > 4096:
                    raise ValueError("Corrupt JPEG-LS stream (runaway unary)")
                continue
            lead = 16 - window.bit_length()
            self.n -= lead + 1
            self.acc &= (1 << self.n) - 1
            return count + lead


class _BitWriter:
    """MSB-first writer emitting JPEG-LS stuffing (7 payload bits in the
    byte after any 0xFF)."""

    __slots__ = ("out", "acc", "n", "last_ff")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
        self.last_ff = False

    def write(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while True:
            width = 7 if self.last_ff else 8
            if self.n < width:
                return
            self.n -= width
            byte = (self.acc >> self.n) & ((1 << width) - 1)
            self.acc &= (1 << self.n) - 1
            self.out.append(byte)
            self.last_ff = byte == 0xFF

    def flush(self) -> bytes:
        if self.n:
            width = 7 if self.last_ff else 8
            self.out.append((self.acc << (width - self.n)) & ((1 << width) - 1))
            self.acc = 0
            self.n = 0
            self.last_ff = False
        return bytes(self.out)


class _ScanState:
    """Per-scan adaptive context variables (T.87 A.2.1, A.7)."""

    __slots__ = ("p", "A", "B", "C", "N", "A_run", "N_run", "Nn", "run_index")

    def __init__(self, p: _Params):
        self.p = p
        a_init = max(2, (p.range + 32) >> 6)
        self.A = [a_init] * 365
        self.B = [0] * 365
        self.C = [0] * 365
        self.N = [1] * 365
        self.A_run = [a_init, a_init]  # contexts 365, 366
        self.N_run = [1, 1]
        self.Nn = [0, 0]
        self.run_index = 0

    # -- context quantization -------------------------------------------
    def quantize(self, d: int) -> int:
        p = self.p
        if d <= -p.t3:
            return -4
        if d <= -p.t2:
            return -3
        if d <= -p.t1:
            return -2
        if d < -p.near:
            return -1
        if d <= p.near:
            return 0
        if d < p.t1:
            return 1
        if d < p.t2:
            return 2
        if d < p.t3:
            return 3
        return 4

    # -- regular mode shared pieces -------------------------------------
    def golomb_k(self, q: int) -> int:
        a, n = self.A[q], self.N[q]
        k = 0
        while (n << k) < a:
            k += 1
        return k

    def update_regular(self, q: int, errval: int):
        p = self.p
        self.B[q] += errval * (2 * p.near + 1)
        self.A[q] += abs(errval)
        if self.N[q] == p.reset:
            self.A[q] >>= 1
            b = self.B[q]
            self.B[q] = b >> 1 if b >= 0 else -((1 - b) >> 1)
            self.N[q] >>= 1
        self.N[q] += 1
        # bias computation (T.87 A.6.3)
        n = self.N[q]
        if self.B[q] <= -n:
            self.B[q] += n
            if self.C[q] > _MIN_C:
                self.C[q] -= 1
            if self.B[q] <= -n:
                self.B[q] = -n + 1
        elif self.B[q] > 0:
            self.B[q] -= n
            if self.C[q] < _MAX_C:
                self.C[q] += 1
            if self.B[q] > 0:
                self.B[q] = 0


def _med(a: int, b: int, c: int) -> int:
    """Median edge detector prediction (T.87 A.4.2)."""
    if c >= (a if a > b else b):
        return a if a < b else b
    if c <= (a if a < b else b):
        return a if a > b else b
    return a + b - c


def _clamp(x: int, maxval: int) -> int:
    return 0 if x < 0 else (maxval if x > maxval else x)


def _reconstruct(px: int, sign_err: int, p: _Params) -> int:
    """Dequantized error -> sample value (decoder reconstruction,
    T.87 A.4.5 modulo correction + clamp)."""
    rx = px + sign_err
    span = p.range * (2 * p.near + 1)
    if rx < -p.near:
        rx += span
    elif rx > p.maxval + p.near:
        rx -= span
    return _clamp(rx, p.maxval)


# ---------------------------------------------------------------------------
# Scan decoding
# ---------------------------------------------------------------------------


def _decode_limited(reader: _BitReader, k: int, limit: int, qbpp: int) -> int:
    u = reader.read_unary()
    if u < limit - qbpp - 1:
        return (u << k) | reader.read(k)
    if u == limit - qbpp - 1:
        return reader.read(qbpp) + 1
    raise ValueError("Corrupt JPEG-LS stream (over-long code)")


def _decode_scan_lines(reader, out, row0, nrows, prev, cur, state):
    """Decode ``nrows`` lines starting at ``row0`` into ``out``,
    threading the two line buffers (index i+1 = column i)."""
    p = state.p
    width = out.shape[1]
    near = p.near
    for row in range(row0, row0 + nrows):
        prev, cur = cur, prev
        cur[0] = prev[1]
        prev[width + 1] = prev[width]
        col = 0
        while col < width:
            a = cur[col]
            c = prev[col]
            b = prev[col + 1]
            d = prev[col + 2]
            d1, d2, d3 = d - b, b - c, c - a
            if (abs(d1) <= near and abs(d2) <= near and abs(d3) <= near):
                col = _decode_run(reader, cur, prev, col, width, state)
                continue
            q1 = state.quantize(d1)
            q2 = state.quantize(d2)
            q3 = state.quantize(d3)
            q = 81 * q1 + 9 * q2 + q3
            if q < 0:
                sign, q = -1, -q
            else:
                sign = 1
            px = _med(a, b, c)
            px = _clamp(px + sign * state.C[q], p.maxval)
            k = state.golomb_k(q)
            merr = _decode_limited(reader, k, p.limit, p.qbpp)
            if merr & 1:
                errval = -((merr + 1) >> 1)
            else:
                errval = merr >> 1
            if k == 0 and near == 0 and 2 * state.B[q] <= -state.N[q]:
                errval = -errval - 1  # undo the low-entropy map inversion
            state.update_regular(q, errval)
            cur[col + 1] = _reconstruct(
                px, sign * errval * (2 * near + 1), p
            )
            col += 1
        out[row] = cur[1 : width + 1]
    return prev, cur


def _decode_run(reader, cur, prev, col, width, state):
    runval = cur[col]
    while True:
        if reader.read(1) == 1:
            seg = 1 << _J[state.run_index]
            fill = min(seg, width - col)
            for i in range(col + 1, col + 1 + fill):
                cur[i] = runval
            col += fill
            if fill == seg and state.run_index < 31:
                state.run_index += 1
            if col >= width:
                return col
        else:
            jbits = _J[state.run_index]
            cnt = reader.read(jbits) if jbits else 0
            if cnt > width - col - 1:
                raise ValueError("Corrupt JPEG-LS stream (run past line end)")
            for i in range(col + 1, col + 1 + cnt):
                cur[i] = runval
            col += cnt
            cur[col + 1] = _decode_run_interruption(reader, cur, prev, col, state)
            if state.run_index > 0:
                state.run_index -= 1
            return col + 1


def _decode_run_interruption(reader, cur, prev, col, state) -> int:
    p = state.p
    a = cur[col]
    b = prev[col + 1]
    ritype = 1 if abs(a - b) <= p.near else 0
    px = a if ritype else b
    temp = state.A_run[ritype] + ((state.N_run[ritype] >> 1) if ritype else 0)
    n = state.N_run[ritype]
    k = 0
    while (n << k) < temp:
        k += 1
    limit = p.limit - _J[state.run_index] - 1
    emap = _decode_limited(reader, k, limit, p.qbpp)
    tmp2 = emap + ritype
    map_bit = tmp2 & 1
    eabs = (tmp2 + map_bit) >> 1
    if (k != 0 or 2 * state.Nn[ritype] >= n) == bool(map_bit):
        errval = -eabs
    else:
        errval = eabs
    # update (T.87 A.23)
    if errval < 0:
        state.Nn[ritype] += 1
    state.A_run[ritype] += (emap + 1 - ritype) >> 1
    if state.N_run[ritype] == p.reset:
        state.A_run[ritype] >>= 1
        state.N_run[ritype] >>= 1
        state.Nn[ritype] >>= 1
    state.N_run[ritype] += 1
    sign = -1 if (ritype == 0 and a > b) else 1
    return _reconstruct(px, sign * errval * (2 * p.near + 1), p)


# ---------------------------------------------------------------------------
# Stream-level decoding
# ---------------------------------------------------------------------------


def _find_scan_end(stream: bytes, start: int) -> int:
    """Index just past the entropy-coded data: the first 0xFF followed
    by a non-RSTn marker byte (>= 0x80 excludes stuffed-bit bytes)."""
    i = start
    n = len(stream)
    while True:
        i = stream.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            return n
        nxt = stream[i + 1]
        if nxt & 0x80 and not (0xD0 <= nxt <= 0xD7):
            return i
        i += 1


def _split_restart_segments(scan: bytes) -> list[bytes]:
    segments = []
    start = i = 0
    n = len(scan)
    while i + 1 < n:
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
            segments.append(scan[start:i])
            i += 2
            start = i
            continue
        i += 1
    segments.append(scan[start:])
    return segments


def decode_jpeg_ls(stream: bytes) -> np.ndarray:
    """Decode a JPEG-LS stream to ``(H, W)`` (single component) or
    ``(H, W, C)`` (interleave-mode-0 multi-scan) uint8/uint16, through the
    native decoder (see the module docstring for what it declines)."""
    return native.jls_decode(stream)


def decode_jpeg_ls_python(stream: bytes) -> np.ndarray:
    """The plain decoder: :func:`decode_jpeg_ls` in Python."""
    if stream[:2] != bytes([0xFF, SOI]):
        raise ValueError("Not a JPEG-LS stream")
    pos = 2
    precision = height = width = ncomp = None
    preset = {}
    restart_interval = 0
    planes: list[np.ndarray] = []
    maxval = None
    while pos + 2 <= len(stream):
        if stream[pos] != 0xFF:
            raise ValueError(f"Bad marker at byte {pos}")
        marker = stream[pos + 1]
        pos += 2
        if marker == EOI:
            break
        if 0xD0 <= marker <= 0xD7:  # stray RSTn between scans
            continue
        length = struct.unpack_from(">H", stream, pos)[0]
        seg = stream[pos + 2 : pos + length]
        if marker == SOF55:
            precision, height, width, ncomp = struct.unpack_from(">BHHB", seg, 0)
            maxval = (1 << precision) - 1
        elif marker == LSE:
            if seg[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack_from(">HHHHH", seg, 1)
                preset = {"t1": t1 or None, "t2": t2 or None,
                          "t3": t3 or None, "reset": reset or 64}
                if not maxval:
                    maxval = (1 << precision) - 1
            else:
                raise ValueError(
                    f"JPEG-LS LSE ID {seg[0]} (mapping tables) not supported"
                )
        elif marker == DRI:
            restart_interval = struct.unpack_from(">H", seg, 0)[0]
        elif marker == SOS:
            if precision is None:
                raise ValueError("JPEG-LS SOS before SOF55")
            ns = seg[0]
            near = seg[1 + 2 * ns]
            ilv = seg[2 + 2 * ns]
            if ns != 1 or (ilv != 0 and ncomp > 1):
                raise ValueError(
                    "Only interleave mode 0 (one component per scan) is"
                    f" supported, got Ns={ns} ILV={ilv}"
                )
            params = _Params(maxval, near, **preset)
            scan_end = _find_scan_end(stream, pos + length)
            scan = stream[pos + length : scan_end]
            planes.append(
                _decode_one_scan(scan, width, height, params, restart_interval)
            )
            pos = scan_end
            if len(planes) == ncomp:
                break
            continue
        pos += length
    if not planes or precision is None:
        raise ValueError("Missing SOF55/SOS segments")
    dtype = np.uint8 if precision <= 8 else np.uint16
    if len(planes) == 1:
        return planes[0].astype(dtype)
    return np.stack(planes, axis=-1).astype(dtype)


def _decode_one_scan(scan, width, height, params, restart_interval):
    out = np.empty((height, width), np.int32)
    if restart_interval:
        segments = _split_restart_segments(scan)
        row = 0
        seg_idx = 0
        while row < height:
            if seg_idx >= len(segments):
                raise ValueError("Truncated JPEG-LS restart stream")
            nrows = min(restart_interval, height - row)
            reader = _BitReader(segments[seg_idx])
            state = _ScanState(params)
            prev = [0] * (width + 2)
            cur = [0] * (width + 2)
            _decode_scan_lines(reader, out, row, nrows, prev, cur, state)
            row += nrows
            seg_idx += 1
    else:
        reader = _BitReader(scan)
        state = _ScanState(params)
        prev = [0] * (width + 2)
        cur = [0] * (width + 2)
        _decode_scan_lines(reader, out, 0, height, prev, cur, state)
    return out


# ---------------------------------------------------------------------------
# Encoding (single component)
# ---------------------------------------------------------------------------


def _encode_limited(writer: _BitWriter, value: int, k: int, limit: int,
                    qbpp: int):
    high = value >> k
    if high < limit - qbpp - 1:
        writer.write(1, high + 1)  # `high` zeros then a one
        if k:
            writer.write(value & ((1 << k) - 1), k)
    else:
        writer.write(1, limit - qbpp)
        writer.write(value - 1, qbpp)


def _encode_scan_lines(writer, image, row0, nrows, prev, cur, state):
    p = state.p
    near = p.near
    height, width = image.shape
    for row in range(row0, row0 + nrows):
        prev, cur = cur, prev
        cur[0] = prev[1]
        prev[width + 1] = prev[width]
        line = image[row]
        col = 0
        while col < width:
            a = cur[col]
            c = prev[col]
            b = prev[col + 1]
            d = prev[col + 2]
            d1, d2, d3 = d - b, b - c, c - a
            if (abs(d1) <= near and abs(d2) <= near and abs(d3) <= near):
                col = _encode_run(writer, line, cur, prev, col, width, state)
                continue
            q1 = state.quantize(d1)
            q2 = state.quantize(d2)
            q3 = state.quantize(d3)
            q = 81 * q1 + 9 * q2 + q3
            if q < 0:
                sign, q = -1, -q
            else:
                sign = 1
            px = _med(a, b, c)
            px = _clamp(px + sign * state.C[q], p.maxval)
            errval = sign * (int(line[col]) - px)
            if near:
                if errval > 0:
                    errval = (near + errval) // (2 * near + 1)
                else:
                    errval = -((near - errval) // (2 * near + 1))
                cur[col + 1] = _clamp(px + sign * errval * (2 * near + 1),
                                      p.maxval)
            else:
                cur[col + 1] = int(line[col])
            # modulo reduction (T.87 A.4.5)
            if errval < 0:
                errval += p.range
            if errval >= (p.range + 1) >> 1:
                errval -= p.range
            k = state.golomb_k(q)
            if k == 0 and near == 0 and 2 * state.B[q] <= -state.N[q]:
                merr = 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
            else:
                merr = 2 * errval if errval >= 0 else -2 * errval - 1
            _encode_limited(writer, merr, k, p.limit, p.qbpp)
            state.update_regular(q, errval)
            col += 1
    return prev, cur


def _encode_run(writer, line, cur, prev, col, width, state):
    p = state.p
    runval = cur[col]
    start = col
    while col < width and abs(int(line[col]) - runval) <= p.near:
        cur[col + 1] = runval
        col += 1
    runcnt = col - start
    while runcnt >= (1 << _J[state.run_index]):
        writer.write(1, 1)
        runcnt -= 1 << _J[state.run_index]
        if state.run_index < 31:
            state.run_index += 1
    if col >= width:  # run broken by end of line
        if runcnt > 0:
            writer.write(1, 1)
        return col
    writer.write(0, 1)
    jbits = _J[state.run_index]
    if jbits:
        writer.write(runcnt, jbits)
    _encode_run_interruption(writer, line, cur, prev, col, state)
    if state.run_index > 0:
        state.run_index -= 1
    return col + 1


def _encode_run_interruption(writer, line, cur, prev, col, state):
    p = state.p
    a = cur[col]
    b = prev[col + 1]
    x = int(line[col])
    ritype = 1 if abs(a - b) <= p.near else 0
    px = a if ritype else b
    errval = x - px
    sign = -1 if (ritype == 0 and a > b) else 1
    errval *= sign
    if p.near:
        if errval > 0:
            errval = (p.near + errval) // (2 * p.near + 1)
        else:
            errval = -((p.near - errval) // (2 * p.near + 1))
        cur[col + 1] = _clamp(px + sign * errval * (2 * p.near + 1), p.maxval)
    else:
        cur[col + 1] = x
    # modulo reduction
    if errval < 0:
        errval += p.range
    if errval >= (p.range + 1) >> 1:
        errval -= p.range
    n = state.N_run[ritype]
    temp = state.A_run[ritype] + ((n >> 1) if ritype else 0)
    k = 0
    while (n << k) < temp:
        k += 1
    if k == 0 and errval > 0 and 2 * state.Nn[ritype] < n:
        map_bit = 1
    elif errval < 0 and 2 * state.Nn[ritype] >= n:
        map_bit = 1
    elif errval < 0 and k != 0:
        map_bit = 1
    else:
        map_bit = 0
    emap = 2 * abs(errval) - ritype - map_bit
    limit = p.limit - _J[state.run_index] - 1
    _encode_limited(writer, emap, k, limit, p.qbpp)
    if errval < 0:
        state.Nn[ritype] += 1
    state.A_run[ritype] += (emap + 1 - ritype) >> 1
    if state.N_run[ritype] == p.reset:
        state.A_run[ritype] >>= 1
        state.N_run[ritype] >>= 1
        state.Nn[ritype] >>= 1
    state.N_run[ritype] += 1


def encode_jpeg_ls(
    image: np.ndarray,
    near: int = 0,
    precision: int | None = None,
    restart_interval: int = 0,
) -> bytes:
    """Encode a 2D uint8/uint16 array as a JPEG-LS stream.

    ``near`` is the T.87 NEAR parameter (0 = lossless; otherwise the
    reconstruction differs from the input by at most ``near`` per
    sample).  ``restart_interval`` emits a DRI segment and RSTn markers
    every that many LINES, with a full state reset (used to test the
    decoder's restart path; DICOM writers leave it 0).
    """
    image = np.ascontiguousarray(image)
    if image.ndim != 2:
        raise ValueError(f"Expected a 2D image, got shape {image.shape}")
    if precision is None:
        precision = 16 if image.dtype.itemsize == 2 else 8
    maxval = (1 << precision) - 1
    height, width = image.shape
    params = _Params(maxval, near)
    image = image.astype(np.int64, copy=False)

    chunks: list[bytes] = []
    row = 0
    rst = 0
    nrows_per = restart_interval or height
    while row < height:
        writer = _BitWriter()
        state = _ScanState(params)
        prev = [0] * (width + 2)
        cur = [0] * (width + 2)
        nrows = min(nrows_per, height - row)
        _encode_scan_lines(writer, image, row, nrows, prev, cur, state)
        chunks.append(writer.flush())
        row += nrows
        if restart_interval and row < height:
            chunks.append(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
    scan = b"".join(chunks)

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    sof = struct.pack(">BHHB", precision, height, width, 1) + bytes(
        [0x01, 0x11, 0x00]
    )
    lse = bytes([1]) + struct.pack(
        ">HHHHH", maxval, params.t1, params.t2, params.t3, params.reset
    )
    sos = bytes([1, 0x01, 0x00, near, 0, 0])
    dri = (
        seg(DRI, struct.pack(">H", restart_interval)) if restart_interval else b""
    )
    return (
        bytes([0xFF, SOI])
        + seg(SOF55, sof)
        + seg(LSE, lse)
        + dri
        + seg(SOS, sos)
        + scan
        + bytes([0xFF, EOI])
    )
