"""Host-side plan of the B-spline kernels (``ops/bspline_kernel.py``).

The CUDA kernels run only on the card; what they are told on the host
is plain Python and is held here:

- :func:`prefilter_plan` picks the path of an axis pass (rows of
  interleaved lines staged in shared memory, slabs of columns, or device
  memory for lines too long), how many lines a block takes, at what
  pitch, and its shared memory; the blocks it plans take every line once;
- :func:`prefilter_steps` lays out the three passes: a multi-channel
  batch comes out channels-last, the i pass moving the channels. Run with
  the plain one-axis filter on the same memory views, the steps give the
  plain prefilter's coefficients;
- the spline wrappers read channels-last coefficients, four channels a
  load when the channels allow it.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu_torch.ops import bspline as bs
from torchio_tpu_torch.ops import bspline_kernel as bk


@pytest.mark.parametrize(
    "n,stride,want",
    [
        # brats k lines: 64 lines of 155 floats (39.7 KB), 155 already odd
        (155, 1, bk.PrefilterPlan("lines", 64, 155, 64 * 155 * 4)),
        # an even length gets an odd pitch
        (240, 1, bk.PrefilterPlan("lines", 64, 241, 64 * 241 * 4)),
        # brats j and i lines: a 240 x 32 slab (30.7 KB)
        (240, 155, bk.PrefilterPlan("columns", 32, 32, 240 * 32 * 4)),
        (240, 240 * 155, bk.PrefilterPlan("columns", 32, 32, 240 * 32 * 4)),
        # long lines take smaller blocks
        (2100, 1, bk.PrefilterPlan("lines", 16, 2101, 16 * 2101 * 4)),
        # a short stride: rows of 7 interleaved lines, 2 rows a block
        (2100, 7, bk.PrefilterPlan("lines", 14, 2101, 14 * 2101 * 4)),
        (7000, 3, bk.PrefilterPlan("lines", 6, 7001, 6 * 7001 * 4)),
        (7000, 40, bk.PrefilterPlan("columns", 8, 8, 7000 * 8 * 4)),
        # longer than shared memory holds: device memory
        (7300, 1, bk.PrefilterPlan("global", 0, 0, 0)),
        (7300, 32, bk.PrefilterPlan("global", 0, 0, 0)),
        # a size-1 axis is a (copied) line of one sample
        (1, 1, bk.PrefilterPlan("lines", 64, 1, 64 * 4)),
        (1, 19, bk.PrefilterPlan("lines", 57, 1, 57 * 4)),
        # brats k lines of channels-last coefficients: 16 rows of 4
        (155, 4, bk.PrefilterPlan("lines", 64, 155, 64 * 155 * 4)),
    ],
)
def test_prefilter_plan(n, stride, want):
    assert bk.prefilter_plan(n, stride) == want


@pytest.mark.parametrize(
    "n,stride,channels,want",
    [
        # the brats i pass: 8 positions x 4 channels a block
        (240, 240 * 155, 4, bk.PrefilterPlan("columns", 32, 32, 240 * 32 * 4)),
        (240, 155, 3, bk.PrefilterPlan("columns", 30, 30, 240 * 30 * 4)),
        # more channels than a warp: one position a block
        (50, 10, 100, bk.PrefilterPlan("columns", 100, 100, 50 * 100 * 4)),
        # long lines: fewer positions
        (2100, 15, 2, bk.PrefilterPlan("columns", 16, 16, 2100 * 16 * 4)),
        # one position of every channel does not fit: no channel-moving pass
        (400, 10, 200, bk.GLOBAL),
        (10, 10, 2000, bk.GLOBAL),
    ],
)
def test_prefilter_plan_channels(n, stride, channels, want):
    assert bk.prefilter_plan(n, stride, channels) == want


@given(n=st.integers(1, 12_000), stride=st.integers(1, 100_000))
@settings(max_examples=200, deadline=None)
def test_prefilter_plan_fits_and_prefers_shared_memory(n, stride):
    plan = bk.prefilter_plan(n, stride)
    lines = stride < bk.LINE_STRIDE_LIMIT
    if lines:
        sizes = [max(p // stride, 1) * stride for p in bk.LINES_PER_BLOCK]
        floats = n | 1
    else:
        sizes, floats = list(bk.COLUMNS_PER_BLOCK), n
    if plan.path == "global":
        assert min(sizes) * floats * 4 > bk.MAX_SHARED_BYTES
        return
    assert plan.path == ("lines" if lines else "columns")
    assert 0 < plan.shared_bytes <= bk.MAX_SHARED_BYTES
    assert plan.per_block in sizes
    assert plan.shared_bytes == plan.per_block * floats * 4
    if lines:
        assert plan.pitch == n | 1 and plan.per_block % stride == 0
    else:
        assert plan.pitch == plan.per_block
    # the largest block that fits is taken
    assert all(p * floats * 4 > bk.MAX_SHARED_BYTES for p in sizes if p > plan.per_block)


def _lines_of_blocks(step):
    """The lines each block of ``step``'s plan takes, as the kernels index
    them (``csrc/bspline.cu``: prefilter_lines_kernel,
    prefilter_columns_kernel): (outer, channel, position) triples."""
    plan, outer, stride, channels = step.plan, step.outer, step.stride, step.channels
    if plan.path == "lines":  # block b: rows [b R, b R + R), stride lines a row
        rows = plan.per_block // stride
        return [
            [(r, 0, lane) for r in range(b * rows, min(outer, (b + 1) * rows))
             for lane in range(stride)]
            for b in range(-(-outer // rows))
        ]
    width = plan.per_block // channels  # positions a block, every channel
    slabs = -(-stride // width)  # block b: outer b // slabs, slab b % slabs
    return [
        [
            (b // slabs, t % channels, s0 + t // channels)
            for t in range(plan.per_block)
            if (s0 := (b % slabs) * width) + t // channels < stride
        ]
        for b in range(outer * slabs)
    ]


SHAPES = [
    (2, 3, 37, 45, 51), (1, 1, 3, 5, 40), (2, 1, 23, 19, 1), (1, 2, 130, 3, 65),
    (1, 1, 1, 1, 1), (2, 4, 9, 10, 11), (3, 5, 7), (2, 2, 3, 4, 5, 6),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_prefilter_blocks_take_every_line_once(shape):
    """Every line of every axis pass lies in exactly one block, and each
    block's lines fit its shared memory."""
    _, steps = bk.prefilter_steps(shape)
    for step in steps:
        assert step.plan.path in ("lines", "columns")
        assert step.outer * step.n * step.stride * step.channels == math.prod(shape)
        blocks = _lines_of_blocks(step)
        taken = [line for block in blocks for line in block]
        want = step.outer * step.channels * step.stride
        assert len(taken) == len(set(taken)) == want
        for block in blocks:
            assert 0 < len(block) <= step.plan.per_block
            floats = step.plan.pitch if step.plan.path == "lines" else step.n
            assert len(block) * floats * 4 <= step.plan.shared_bytes <= bk.MAX_SHARED_BYTES


@pytest.mark.parametrize(
    "shape,channels_last",
    [
        ((4, 4, 240, 240, 155), True),  # brats
        ((2, 1, 240, 240, 155), False),  # one channel: both layouts are one
        ((240, 240, 155), False),
        ((1, 300, 400, 3, 3), False),  # the i pass cannot move 300 channels
    ],
)
def test_prefilter_steps_layout(shape, channels_last):
    got, steps = bk.prefilter_steps(shape)
    assert got == channels_last
    if shape == (4, 4, 240, 240, 155):
        assert [s[:4] for s in steps] == [
            (4, 240, 240 * 155, 4), (4 * 240, 240, 155 * 4, 1), (4 * 240 * 240, 155, 4, 1),
        ]
        assert [(s.plan.path, s.plan.per_block) for s in steps] == [
            ("columns", 32), ("columns", 32), ("lines", 64),
        ]


@pytest.mark.parametrize("shape", SHAPES[:6])
@pytest.mark.parametrize("order", [2, 3, 5])
def test_prefilter_steps_give_the_plain_coefficients(shape, order):
    """The steps' memory views, each filtered along its n axis by the
    plain one-axis prefilter, give the plain prefilter of the volume in
    the layout the steps announce."""
    vol = torch.as_tensor(np.random.default_rng(3).random(shape, np.float32))
    channels_last, steps = bk.prefilter_steps(shape)
    out = torch.empty(vol.numel(), dtype=torch.float32)
    src = vol.reshape(-1)
    for step in steps:
        if step.channels > 1:
            x = src.reshape(step.outer, step.channels, step.n, step.stride)
            x = bs._prefilter_axis(x, 2, order).permute(0, 2, 3, 1)
        else:
            x = bs._prefilter_axis(src.reshape(step.outer, step.n, step.stride), 1, order)
        out.copy_(x.reshape(-1))
        src = out
    if channels_last:
        b, c, *spatial = shape
        got = out.reshape(b, *spatial, c).permute(0, 4, 1, 2, 3)
    else:
        got = out.reshape(shape)
    want = bs.prefilter_plain(vol, order)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize(
    "channels,vec", [(1, 1), (2, 1), (3, 1), (4, 4), (8, 4), (12, 4)]
)
def test_spline_reads_channels_last(channels, vec):
    """The spline wrappers hand the kernel channels-last coefficients
    (copying only other layouts) and read four channels a load when C
    is a multiple of 4."""
    planar = torch.rand(2, channels, 3, 4, 5)
    coeffs, got_vec = bk._channels_last(planar)
    assert got_vec == vec
    assert coeffs.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(coeffs, planar)
    again, _ = bk._channels_last(coeffs)
    assert again.data_ptr() == coeffs.data_ptr()
