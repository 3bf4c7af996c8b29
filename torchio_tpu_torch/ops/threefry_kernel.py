"""Wrappers of the hand-written threefry kernel (``csrc/threefry.cu``).

``jax.random``'s draws on the card, element for element as the JAX
package draws them, for a list of draws (segments) in one launch (the
source file's head says what the kernel computes and what bounds it):

- :func:`threefry_segments_cuda`: the segments' float32 standard normals,
  each times its scale (or their raw words), one after the other in one
  flat tensor (BiasField's per-element fields, Noise's Rician pair); its
  plain version is :func:`torchio_tpu_torch.random.normals_plain`;
- :func:`threefry_normal_cuda` and :func:`threefry_bits_cuda`: one draw of
  normals or of raw 32-bit words (``jax.random.bits``), one segment; their
  plain versions are :func:`~torchio_tpu_torch.random.normal_of_bits` of
  :func:`~torchio_tpu_torch.random.bits_plain`, and ``bits_plain``.

:func:`segment_plan` lays the segments out on the host: each one's offset,
its key and the ten words its key schedule injects, and its scale; a list
longer than a launch's table is split into launches. The kernel finds
each segment's scalar head before its first 16-byte aligned element from
the segment's address. :mod:`.kernel_lib` builds and loads
the library and counts the launches (``LAUNCHES["threefry_normal"]``,
``LAUNCHES["threefry_bits"]``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from .. import random as tio_random
from .kernel_lib import I32, P, KernelLibrary, stream

THREEFRY = KernelLibrary(
    "threefry.cu",
    {"tio_threefry_segments": [P, P, I32, I32, P]},
    kernels=("threefry_normal", "threefry_bits"),
)

#: segments a launch takes (``csrc/threefry.cu``'s ``kMaxSegments``)
MAX_SEGMENTS = 48


@dataclass(frozen=True)
class Segment:
    """One draw of a launch: ``count`` elements at ``offset`` of the
    output, counters from 0, under ``key``, each normal times ``scale``."""

    key: tio_random.Key
    inject: tuple[int, ...]
    offset: int
    count: int
    scale: float


class _Row(ctypes.Structure):
    """``csrc/threefry.cu``'s ``Segment`` (80 bytes)."""

    _fields_ = [
        ("k0", ctypes.c_uint32),
        ("k1", ctypes.c_uint32),
        ("inject", ctypes.c_uint32 * 10),
        ("offset", ctypes.c_longlong),
        ("count", ctypes.c_longlong),
        ("scale", ctypes.c_float),
        ("first_block", ctypes.c_int),
        ("blocks", ctypes.c_int),
    ]


def segment_plan(
    keys: Sequence[tio_random.Key],
    counts: Sequence[int],
    scales: Sequence[float] | None,
) -> list[list[Segment]]:
    """The launches that draw ``counts[s]`` elements under ``keys[s]``,
    one segment after the other: at most :data:`MAX_SEGMENTS` segments a
    launch, empty draws left out."""
    if len(keys) != len(counts) or (scales is not None and len(scales) != len(keys)):
        raise ValueError("keys, counts and scales must have one entry a draw")
    segments, offset = [], 0
    for s, (key, count) in enumerate(zip(keys, counts)):
        k0, k1 = (int(k) for k in key)
        if not (0 <= k0 <= 0xFFFFFFFF and 0 <= k1 <= 0xFFFFFFFF):
            raise ValueError(f"a key is two 32-bit words, got {key}")
        if count < 0:
            raise ValueError(f"a draw has at least 0 elements, got {count}")
        if count:
            segments.append(
                Segment(
                    key=(k0, k1),
                    inject=tio_random.key_injections((k0, k1)),
                    offset=offset,
                    count=int(count),
                    scale=1.0 if scales is None else float(scales[s]),
                )
            )
        offset += int(count)
    return [segments[i : i + MAX_SEGMENTS] for i in range(0, len(segments), MAX_SEGMENTS)]


def _rows(segments: list[Segment]):
    rows = (_Row * len(segments))()
    for row, seg in zip(rows, segments):
        row.k0, row.k1 = seg.key
        row.inject[:] = seg.inject
        row.offset, row.count, row.scale = seg.offset, seg.count, seg.scale
    return rows


def threefry_segments_cuda(
    keys: Sequence[tio_random.Key],
    counts: Sequence[int],
    scales: Sequence[float] | None,
    device,
    normal: bool = True,
) -> torch.Tensor:
    """``jax.random.normal(keys[s], (counts[s],)) * scales[s]`` for every
    ``s`` (``normal``; the normals as drawn where ``scales`` is None, which
    the kernel multiplies by 1, exactly), or ``jax.random.bits`` of the
    keys (int32), one after the other in one flat tensor on a CUDA
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on a CUDA device, got {device}")
    if not normal and scales is not None:
        raise ValueError("raw words take no scale")
    out = torch.empty(sum(int(c) for c in counts),
                      dtype=torch.float32 if normal else torch.int32, device=device)
    kernel = "threefry_normal" if normal else "threefry_bits"
    launches = segment_plan(keys, counts, scales)
    if launches:
        with torch.cuda.device(device):
            st = stream(device)
            for segments in launches:
                rows = _rows(segments)
                THREEFRY.launch(kernel, "tio_threefry_segments", out.data_ptr(),
                                ctypes.addressof(rows), len(segments), int(normal), st)
    return out


def threefry_normal_cuda(key, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on a CUDA device."""
    shape = tuple(shape)
    return threefry_segments_cuda([key], [math.prod(shape)], None, device).reshape(shape)


def threefry_bits_cuda(key, shape: tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) on a CUDA device."""
    shape = tuple(shape)
    words = threefry_segments_cuda([key], [math.prod(shape)], None, device, normal=False)
    return words.reshape(shape).view(torch.uint32)
