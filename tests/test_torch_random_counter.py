"""The threefry counter base: a rank's rows of a global draw.

``random.normals(..., starts=...)`` draws the elements ``[start, start + n)`` of a larger draw under its
key: a rank of a (data, space) mesh draws only its batch rows of
``jax.random.normal(key, (B, C, I, J, K))``, which are the counters from
``b0 * C * I * J * K``. On the CPU (the plain version) the rows are
equal bit for bit to the same rows of the whole draw, their words to
``jax.random.bits``' and their normals within 1e-6 of
``jax.random.normal``'s (``log1p`` rounds differently in XLA). The
kernel's segment record (``csrc/threefry.cu``'s ``Segment``, mirrored by
``ops/threefry_kernel.py``'s ``_Row``) carries the base.
"""

from __future__ import annotations

import ctypes
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu_torch import random as tr
from torchio_tpu_torch.ops import threefry_kernel as tk

NORMAL_ATOL = 1e-6
CU = Path(tk.__file__).resolve().parent.parent / "csrc" / "threefry.cu"
GLOBAL = (4, 2, 6, 16, 5)


def layouts():
    """(data, space) layouts and each rank's rows of a GLOBAL batch."""
    for data, space in ((2, 2), (4, 1), (1, 4)):
        bl = GLOBAL[0] // data
        for rank in range(data * space):
            yield data, space, (rank // space) * bl, bl


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_rows_of_a_global_draw(seed):
    key = tr.prng_key(seed)
    per_row = math.prod(GLOBAL[1:])
    whole = tr.normal(key, GLOBAL, "cpu")
    jax_whole = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), GLOBAL, jnp.float32))
    jax_bits = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), GLOBAL)).reshape(-1)
    for data, space, b0, bl in layouts():
        shape = (bl, *GLOBAL[1:])
        rows = tr.normals([key], [shape], None, "cpu", starts=[b0 * per_row]).reshape(shape)
        assert torch.equal(rows, whole[b0:b0 + bl]), (data, space, b0)
        np.testing.assert_allclose(rows.numpy(), jax_whole[b0:b0 + bl], rtol=0, atol=NORMAL_ATOL)
        words = tr.as_uint32(tr.bits_plain(key, b0 * per_row, bl * per_row, "cpu"))
        np.testing.assert_array_equal(
            words.numpy(), jax_bits[b0 * per_row:(b0 + bl) * per_row]
        )


def test_segments_with_starts_and_scales():
    """Several draws in one call, each from its own base, each times its
    scale: the slices of the separate whole draws times their scales."""
    keys = tr.split(tr.prng_key(3), 3)
    shapes = [(2, 1, 3, 4, 5), (1, 7), (3, 3)]
    starts = [60, 0, 2**32 - 4]  # the last one carries into the counter's high word
    scales = [0.5, -2.0, 1.0]
    got = tr.normals(keys, shapes, scales, "cpu", starts=starts)
    parts, offset = [], 0
    for key, shape, start, scale in zip(keys, shapes, starts, scales):
        n = math.prod(shape)
        words = tr.bits_plain(key, start, n, "cpu")
        parts.append(tr.normal_of_bits(words) * torch.tensor(scale, dtype=torch.float32))
        np.testing.assert_array_equal(got[offset:offset + n].numpy(), parts[-1].numpy())
        offset += n
    with pytest.raises(ValueError, match="starts"):
        tr.normals(keys, shapes, scales, "cpu", starts=[0])


def test_segment_record_matches_the_kernel():
    """``_Row`` is the kernel's ``Segment`` byte for byte, with the 64-bit
    counter base after the count and the strided segment's run and pitch
    after it, and a launch's table of MAX_SEGMENTS records stays a kernel
    parameter (4 KB): the cap follows from the record's size on both
    sides."""
    source = CU.read_text()
    size = int(re.search(r"static_assert\(sizeof\(Segment\) == (\d+)", source).group(1))
    assert ctypes.sizeof(tk._Row) == size == 104
    table = int(re.search(r"constexpr int kTableBytes = (\d+);", source).group(1))
    assert re.search(
        r"constexpr int kMaxSegments = \(int\)\(\(kTableBytes - 8\) / sizeof\(Segment\)\);",
        source,
    )
    cap = (table - 8) // size
    assert cap == tk.MAX_SEGMENTS == 39
    assert 8 + cap * size <= 4096 < 8 + (cap + 1) * size
    body = re.search(r"struct Segment \{(.*?)\};", source, re.S).group(1)
    code = " ".join(line.split("//")[0] for line in body.splitlines())
    names = [
        name
        for decl in code.split(";")
        for name in re.findall(r"(\w+)(?:\[\d+\])?\s*(?:,|$)", decl.strip())
    ]
    assert names == ["k0", "k1", "inject", "offset", "count", "start", "run", "pitch", "scale",
                     "first_block", "blocks"]
    assert [f[0] for f in tk._Row._fields_] == names
    assert tk._Row.start.offset == 64 and tk._Row.run.offset == 72
    assert tk._Row.pitch.offset == 80 and tk._Row.scale.offset == 88


def test_segment_plan_carries_the_base():
    keys = tr.split(tr.prng_key(1), 3)
    (launch,) = tk.segment_plan(keys, [5, 0, 7], [1.0, 2.0, 3.0], [100, 9, 2**33])
    assert [(s.offset, s.count, s.start, s.scale) for s in launch] == [
        (0, 5, 100, 1.0), (5, 7, 2**33, 3.0)
    ]
    (launch,) = tk.segment_plan(keys[:1], [4], None)
    assert launch[0].start == 0
    rows = tk._rows(launch)
    assert rows[0].start == 0 and rows[0].count == 4
    with pytest.raises(ValueError, match="counter base"):
        tk.segment_plan(keys[:1], [4], None, [-1])
    with pytest.raises(ValueError, match="starts"):
        tk.segment_plan(keys[:2], [4, 4], None, [0])
