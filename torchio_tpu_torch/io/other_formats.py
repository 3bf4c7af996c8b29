"""NRRD and MetaImage (MHA/MHD) readers and writers on the host (numpy).

The port's copy of ``torchio_tpu/io/other_formats.py``: text headers and
raw, gzip or zlib payloads; the files' space conventions (NRRD's
``space`` field, MetaImage's LPS) become RAS+ when read, and the writers
emit LPS, as ITK and Slicer do. Data comes back as (C, I, J, K) numpy.
"""

from __future__ import annotations

import gzip
import zlib
from pathlib import Path

import numpy as np

from .nifti import _host_array

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}

_SPACE_SIGNS = {
    "left-posterior-superior": (-1.0, -1.0, 1.0),
    "lps": (-1.0, -1.0, 1.0),
    "right-anterior-superior": (1.0, 1.0, 1.0),
    "ras": (1.0, 1.0, 1.0),
    "left-anterior-superior": (-1.0, 1.0, 1.0),
    "las": (-1.0, 1.0, 1.0),
}


def _parse_vector(text: str) -> list[float]:
    return [float(v) for v in text.strip().lstrip("(").rstrip(")").split(",")]


def read_nrrd(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a .nrrd / .nhdr file; returns ((C, I, J, K) data, RAS affine)."""
    path = Path(path)
    raw = path.read_bytes()
    if not raw.startswith(b"NRRD"):
        raise ValueError(f"{path} is not a NRRD file")
    header_end = raw.find(b"\n\n")
    if header_end < 0:
        header_end = raw.find(b"\r\n\r\n")
    header_text = raw[:header_end].decode("ascii", "ignore")
    fields: dict[str, str] = {}
    for line in header_text.splitlines()[1:]:
        if line.startswith("#") or ":" not in line:
            continue
        key, _, value = line.partition(":")
        fields[key.strip().lower()] = value.lstrip("=").strip()

    dtype = np.dtype(_NRRD_TYPES[fields["type"].strip()])
    sizes = [int(v) for v in fields["sizes"].split()]
    dim = int(fields.get("dimension", len(sizes)))
    encoding = fields.get("encoding", "raw").lower()
    endian = fields.get("endian", "little")
    if dtype.itemsize > 1:
        dtype = dtype.newbyteorder("<" if endian == "little" else ">")

    payload = raw[header_end:].lstrip(b"\r\n")
    datafile = fields.get("data file") or fields.get("datafile")
    if datafile:  # detached header (.nhdr)
        payload = (path.parent / datafile.split()[0]).read_bytes()
    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding in ("zlib",):
        payload = zlib.decompress(payload)
    elif encoding not in ("raw",):
        raise ValueError(f"Unsupported NRRD encoding: {encoding}")
    count = int(np.prod(sizes))
    arr = np.frombuffer(payload, dtype=dtype, count=count).reshape(
        sizes, order="F"
    )

    # space handling: NRRD axes are (fastest..slowest); vector/channel
    # axes have 'none' space directions
    signs = np.asarray(
        _SPACE_SIGNS.get(fields.get("space", "lps").lower(), (-1.0, -1.0, 1.0))
    )
    directions = []
    spatial_axes = []
    if "space directions" in fields:
        import re

        tokens = re.findall(r"none|\([^)]*\)", fields["space directions"])
        for axis, token in enumerate(tokens):
            if token == "none":
                continue
            directions.append(_parse_vector(token))
            spatial_axes.append(axis)
    else:
        directions = np.eye(3).tolist()
        spatial_axes = list(range(min(3, dim)))
    origin = (
        _parse_vector(fields["space origin"])
        if "space origin" in fields
        else [0.0, 0.0, 0.0]
    )
    affine = np.eye(4)
    for col, d in enumerate(directions[:3]):
        affine[:3, col] = np.asarray(d) * signs
    affine[:3, 3] = np.asarray(origin) * signs

    # move channel axes (non-spatial) to the front
    if arr.ndim == 3:
        data = arr[None]
    else:
        channel_axes = [a for a in range(arr.ndim) if a not in spatial_axes]
        order = channel_axes + spatial_axes
        data = np.transpose(arr, order)
        data = data.reshape((-1,) + data.shape[len(channel_axes):])
    if data.dtype.byteorder not in ("=", "|"):
        data = data.astype(data.dtype.newbyteorder("="))
    return np.ascontiguousarray(data), affine


def read_meta_image(path) -> tuple[np.ndarray, np.ndarray]:
    """Read a .mha / .mhd MetaImage; returns ((C, I, J, K) data, RAS affine)."""
    path = Path(path)
    raw = path.read_bytes()
    fields: dict[str, str] = {}
    pos = 0
    while True:
        nl = raw.find(b"\n", pos)
        line = raw[pos:nl].decode("ascii", "ignore").strip()
        pos = nl + 1
        if "=" not in line:
            break
        key, _, value = line.partition("=")
        fields[key.strip().lower()] = value.strip()
        if key.strip().lower() == "elementdatafile":
            break
    types = {
        "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
        "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
        "MET_INT": np.int32, "MET_UINT": np.uint32,
        "MET_LONG": np.int64, "MET_ULONG": np.uint64,
        "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
    }
    dtype = np.dtype(types[fields["elementtype"]])
    sizes = [int(v) for v in fields["dimsize"].split()]
    channels = int(fields.get("elementnumberofchannels", "1"))
    spacing = [float(v) for v in fields.get("elementspacing", "1 1 1").split()]
    offset = [float(v) for v in fields.get("offset", fields.get("position", "0 0 0")).split()]
    tmatrix = [
        float(v)
        for v in fields.get(
            "transformmatrix", fields.get("orientation", "1 0 0 0 1 0 0 0 1")
        ).split()
    ]
    compressed = fields.get("compresseddata", "false").lower() == "true"
    datafile = fields.get("elementdatafile", "LOCAL")
    payload = (
        raw[pos:] if datafile == "LOCAL" else (path.parent / datafile).read_bytes()
    )
    if compressed:
        payload = zlib.decompress(payload)
    count = channels * int(np.prod(sizes))
    arr = np.frombuffer(payload, dtype=dtype.newbyteorder("<"), count=count)
    if channels > 1:
        # channel-interleaved per voxel: C is the fastest axis on disk
        data = arr.reshape([channels] + sizes, order="F")
    else:
        data = arr.reshape(sizes, order="F")[None]
    rotation = np.asarray(tmatrix, np.float64).reshape(3, 3).T
    lps = np.eye(4)
    lps[:3, :3] = rotation * np.asarray(spacing)
    lps[:3, 3] = offset
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    affine = flip @ lps
    out = np.asarray(data)
    if out.dtype.byteorder not in ("=", "|"):
        out = out.astype(out.dtype.newbyteorder("="))
    return np.ascontiguousarray(out), affine


# --- Writers -----------------------------------------------------------

_NRRD_TYPE_NAMES = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}

_MET_TYPE_NAMES = {
    np.dtype(np.int8): "MET_CHAR", np.dtype(np.uint8): "MET_UCHAR",
    np.dtype(np.int16): "MET_SHORT", np.dtype(np.uint16): "MET_USHORT",
    np.dtype(np.int32): "MET_INT", np.dtype(np.uint32): "MET_UINT",
    np.dtype(np.int64): "MET_LONG", np.dtype(np.uint64): "MET_ULONG",
    np.dtype(np.float32): "MET_FLOAT", np.dtype(np.float64): "MET_DOUBLE",
}


def _prepare_cijk(data: np.ndarray) -> np.ndarray:
    arr = _host_array(data)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4:
        raise ValueError(f"Expected (C, I, J, K) or (I, J, K) data, got {arr.shape}")
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    dtype = arr.dtype.newbyteorder("<")
    if dtype.newbyteorder("=") not in _NRRD_TYPE_NAMES:
        dtype = np.dtype("<f4")
    return np.ascontiguousarray(arr.astype(dtype, copy=False))


def write_nrrd(path, data, affine=None, *, encoding: str = "gzip") -> None:
    """Write (C, I, J, K) data + RAS affine as ``.nrrd`` (attached) or
    ``.nhdr`` (detached header + ``.raw``/``.raw.gz`` payload).

    Space is written as left-posterior-superior, matching what the
    reference's SimpleITK writer emits, so files round-trip through
    ITK/Slicer. A (1, I, J, K) volume is written 3D.
    """
    path = Path(path)
    arr = _prepare_cijk(data)
    affine = np.eye(4) if affine is None else _host_array(affine).astype(np.float64)
    signs = np.asarray([-1.0, -1.0, 1.0])  # RAS -> LPS

    c = arr.shape[0]
    spatial_dirs = [
        "(" + ",".join(repr(float(v)) for v in affine[:3, col] * signs) + ")"
        for col in range(3)
    ]
    origin = "(" + ",".join(repr(float(v)) for v in affine[:3, 3] * signs) + ")"

    if c == 1:
        sizes = arr.shape[1:]
        kinds = "domain domain domain"
        dirs = " ".join(spatial_dirs)
        payload_arr = arr[0]
    else:
        sizes = arr.shape  # C fastest on disk (F order, C listed first)
        kinds = "list domain domain domain"
        dirs = "none " + " ".join(spatial_dirs)
        payload_arr = arr

    if encoding not in ("gzip", "raw"):
        raise ValueError(f"Unsupported NRRD encoding: {encoding}")
    detached = path.name.lower().endswith(".nhdr")
    payload = payload_arr.tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload, 1)

    lines = [
        "NRRD0005",
        "# written by torchio_tpu",
        f"type: {_NRRD_TYPE_NAMES[payload_arr.dtype.newbyteorder('=')]}",
        f"dimension: {payload_arr.ndim}",
        "space: left-posterior-superior",
        f"sizes: {' '.join(str(s) for s in sizes)}",
        f"space directions: {dirs}",
        f"kinds: {kinds}",
        "endian: little",
        f"encoding: {encoding}",
        f"space origin: {origin}",
    ]
    if detached:
        dataname = path.name[: -len(".nhdr")] + (
            ".raw.gz" if encoding == "gzip" else ".raw"
        )
        lines.append(f"data file: {dataname}")
        header = ("\n".join(lines) + "\n").encode("ascii")
        path.write_bytes(header)
        (path.parent / dataname).write_bytes(payload)
    else:
        header = ("\n".join(lines) + "\n\n").encode("ascii")
        path.write_bytes(header + payload)


def write_meta_image(path, data, affine=None, *, compressed: bool | None = None) -> None:
    """Write (C, I, J, K) data + RAS affine as ``.mha`` (attached) or
    ``.mhd`` (detached header + ``.raw``/``.zraw`` payload)."""
    path = Path(path)
    arr = _prepare_cijk(data)
    affine = np.eye(4) if affine is None else _host_array(affine).astype(np.float64)
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    lps = flip @ affine
    spacing = np.linalg.norm(lps[:3, :3], axis=0)
    spacing[spacing == 0] = 1.0
    direction = lps[:3, :3] / spacing  # columns are direction cosines
    # read_meta_image does reshape(3, 3).T, so the file stores direction.T
    tmatrix = direction.T.reshape(-1)

    detached = path.name.lower().endswith(".mhd")
    if compressed is None:
        compressed = not detached
    c = arr.shape[0]
    payload = arr.tobytes(order="F")  # C fastest (channel-interleaved)
    if compressed:
        payload = zlib.compress(payload, 1)

    lines = [
        "ObjectType = Image",
        "NDims = 3",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(payload)}")
    lines += [
        "TransformMatrix = " + " ".join(repr(float(v)) for v in tmatrix),
        "Offset = " + " ".join(repr(float(v)) for v in lps[:3, 3]),
        "CenterOfRotation = 0 0 0",
        "AnatomicalOrientation = ???",
        "ElementSpacing = " + " ".join(repr(float(v)) for v in spacing),
        f"DimSize = {' '.join(str(s) for s in arr.shape[1:])}",
        f"ElementNumberOfChannels = {c}",
        f"ElementType = {_MET_TYPE_NAMES[arr.dtype.newbyteorder('=')]}",
    ]
    if detached:
        dataname = path.name[: -len(".mhd")] + (".zraw" if compressed else ".raw")
        lines.append(f"ElementDataFile = {dataname}")
        path.write_bytes(("\n".join(lines) + "\n").encode("ascii"))
        (path.parent / dataname).write_bytes(payload)
    else:
        lines.append("ElementDataFile = LOCAL")
        path.write_bytes(("\n".join(lines) + "\n").encode("ascii") + payload)
