"""Host-side plan of the dense-coordinate spline kernel (``csrc/bspline.cu``'s
``SplineCoords`` on ``csrc/row_tiles.cuh``; ``ops/bspline_kernel.py``) and
the arithmetic of its k-tap window form (``probes/spline_coords_layout.cu``).

The CUDA kernels run only on the card; what the host tells them, and the
arithmetic they do to pick their taps, is plain and is held here:

- :func:`coords_launch_plan` keeps every grid dimension inside CUDA's
  limits and, with the kernel's loops and the lane layout the source
  ships (``DenseSplineLayout``), serves every output voxel exactly once
  (emulated with numpy, as ``tests/test_torch_resample_plan.py`` does for
  the trilinear kernels); it picks 64-bit offsets exactly when one
  element's I J K C channels-last coefficients reach 2^31 floats;
- ``spline_taps``' interior path (``kInterior``: a coordinate in [0, n-1]
  skips the fold, a run of taps inside the volume the reflection),
  mirrored in torch, gives ``_spline_taps``' indices and weights bit for
  bit, -0.0 and each edge included;
- the k-tap window (the probe's ``window_sum``, which reads a row's k
  taps as the aligned float4s that cover them; it lost to one scalar
  load a tap in the shipped layout, ``PERF.md`` §6), mirrored in torch:
  it is taken exactly where no k tap reflects (its test ``k[T-1] - k[0]
  == order``), the float4s it loads hold every tap, and its two steps of
  select pick ``_spline_taps``' taps, on axes of 1, 2 and 256 samples
  with coordinates inside, at and past each edge, orders 2-7;
- the whole evaluation at one channel, mirrored with those windows (the
  element's coefficients starting off a 16-byte boundary too), equals
  ``bspline_coords_plain`` bit for bit.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from test_torch_resample_plan import BIG, assert_plan_covers, emulate_plan, within_limits
from torchio_tpu_torch import config
from torchio_tpu_torch.ops import bspline as bs
from torchio_tpu_torch.ops import bspline_kernel as bk

ORDERS = range(2, 8)


def shipped_layout() -> str:
    """The lane layout of the package's dense spline, read from the
    source (``using DenseSplineLayout = CoordsLayout<kConsecutive, ...>``)."""
    text = (config.CSRC_DIR / "bspline.cu").read_text()
    found = re.search(r"using DenseSplineLayout = CoordsLayout<(true|false),", text)
    assert found, "bspline.cu names no DenseSplineLayout"
    return "consecutive" if found.group(1) == "true" else "strided"


@pytest.mark.parametrize(
    "coeffs_shape,out_shape",
    [
        ((1, 1, 256, 256, 256), (256, 256, 256)),  # the dense entry's B=1
        ((1, 1, 1, 1, 1), (1, 1, 1)),
        ((2, 1, 12, 14, 20), (4, 5, 155)),  # brats' Ko: two k tiles, one cut
        ((2, 4, 12, 14, 150), (3, 4, 1100)),  # rows past a block's two tiles
        ((2, 2, 12, 14, 20), (9, 10, 3)),  # rows shorter than a lane's 4 voxels
        ((2, 1, 12, 14, 20), (70000, 1, 2)),  # io past grid z's cap
        ((2, 1, 12, 14, 20), (40000, 1, 2)),  # io x b past it, io under it
        ((2, 1, 12, 14, 20), (1, 600000, 1)),  # j tiles past grid y's cap
    ],
)
def test_plan_serves_every_voxel_once(coeffs_shape, out_shape):
    plan = bk.coords_launch_plan(coeffs_shape, out_shape)
    b = coeffs_shape[0]
    assert within_limits(plan) and plan.field_smem == 0
    assert_plan_covers(plan, b, *out_shape)
    counts = emulate_plan(plan, b, *out_shape, layout=shipped_layout())
    assert counts.shape == (b, *out_shape) and (counts == 1).all()


@pytest.mark.parametrize(
    "coeffs_shape,wide",
    [
        ((1, 1, 256, 256, 256), False),
        ((4, 4, 240, 240, 155), False),
        ((1, 1, 1290, 1290, 1290), False),  # 2,146,689,000 floats
        ((1, 1, 1291, 1291, 1291), True),  # 2,151,685,171: chip_smoke's wide case
        ((1, 1, BIG, 1, 1), False),  # 2^31 - 1: the last offset is 2^31 - 2
        ((1, 1, 2**16, 2**15, 1), True),  # 2^31
        ((1, 2, 2**15, 2**15, 1), True),  # 2^31 over two channels
        ((1, 2, 2**15, 2**15 - 1, 1), False),  # 2^31 - 2^16
        ((3, 4, 1024, 1024, 512), True),  # 2^31 over four channels
        ((3, 4, 1024, 1024, 511), False),
    ],
)
def test_plan_offset_width(coeffs_shape, wide):
    plan = bk.coords_launch_plan(coeffs_shape, (8, 8, 8))
    assert plan.wide is wide
    _, c, si, sj, sk = coeffs_shape
    if not wide:  # the largest 32-bit offset, ((I-1)JK + (J-1)K + K-1)C + C-1, fits
        assert (((si - 1) * sj + sj - 1) * sk + sk - 1) * c + c - 1 < 2**31
    else:
        assert si * sj * sk * c >= 2**31


def window_loads(order: int) -> int:
    """window_sum's float4 loads: enough for T taps from any shift."""
    return (order + 1 + 6) // 4


def window_picks(memory: torch.Tensor, first: torch.Tensor, order: int) -> list:
    """window_sum's T taps from ``memory`` (flat float32, zero-padded past
    its end) at float offsets ``first``: the aligned float4s from
    first - shift, then odd shifts, then shifts of two, selected."""
    t = order + 1
    shift = first & 3
    aligned = first - shift
    used = (shift + t + 3) >> 2
    assert bool((shift + t <= 4 * used).all()) and bool((used <= window_loads(order)).all())
    w = [memory[aligned + e] for e in range(4 * window_loads(order))]
    m = [torch.where((shift & 1) == 1, w[e + 1], w[e]) for e in range(t + 2)]
    return [torch.where((shift & 2) == 2, m[d + 2], m[d]) for d in range(t)]


def taps_reflect(c: torch.Tensor, n: int, order: int) -> torch.Tensor:
    """Whether any of the coordinate's taps lies outside [0, n-1] before
    its reflection (the start as ``spline_taps`` computes it)."""
    cf = bs._fold_coord(c, n)
    base = torch.floor(cf + 0.5) if order % 2 == 0 else torch.floor(cf)
    start = (base - float(order // 2)).long()
    return (start < 0) | (start + order > n - 1)


def edge_coords(n: int) -> torch.Tensor:
    """Coordinates inside, at and past each edge of an axis of n samples."""
    near = [-7.3, -2.0, -1.5, -1.0, -0.51, -0.5, -0.2, 0.0, 0.2, 0.5, 0.99, 1.0, 1.5,
            2.0, 2.49, 2.5, 3.0]
    values = near + [n - 1 - x for x in near] + [(n - 1) / 2, (n - 1) / 3 + 0.25, 2.0 * n]
    return torch.tensor(values, dtype=torch.float32)


def interior_taps(c: torch.Tensor, n: int, order: int):
    """``spline_taps<order, true>``: a coordinate in [0, n-1] taken as it
    is (-0.0 too), else folded; a run of taps inside [0, n-1] taken as it
    is, else reflected; the weights from the same expressions."""
    inside = (c >= 0.0) & (c <= float(n - 1))
    cf = torch.where(inside, c, bs._fold_coord(c, n))
    base = torch.floor(cf + 0.5) if order % 2 == 0 else torch.floor(cf)
    start_f = base - float(order // 2)
    t = cf - start_f
    start = start_f.long()
    if order == 2:
        d0, u1, d2 = t - 1.5, t - 1.0, t - 0.5
        weights = [d0 * d0 * 0.5, 0.75 - u1 * u1, d2 * d2 * 0.5]
    elif order == 3:
        r = t - 1.0
        a0, u2, a3 = 2.0 - (r + 1.0), 1.0 - r, 2.0 - (2.0 - r)
        sixth = 1.0 / 6.0
        weights = [
            a0 * a0 * a0 * sixth,
            (4.0 - 6.0 * r * r + 3.0 * r * r * r) * sixth,
            (4.0 - 6.0 * u2 * u2 + 3.0 * u2 * u2 * u2) * sixth,
            a3 * a3 * a3 * sixth,
        ]
    else:
        weights = [bs._bspline_kernel(t - float(o), order) for o in range(order + 1)]
    run = (start >= 0) & (start + order <= n - 1)
    idx = [torch.where(run, start + d, bs._reflect_index(start + d, n)) for d in range(order + 1)]
    return idx, weights


@pytest.mark.parametrize("n", [1, 2, 256])
@pytest.mark.parametrize("order", ORDERS)
def test_interior_taps_equal_the_plain_taps(order, n):
    c = torch.cat([edge_coords(n), torch.tensor([-0.0, float(n - 1), float(n) - 1.0001])])
    idx, weights = interior_taps(c, n, order)
    want_idx, want_weights = bs._spline_taps(c, n, order)
    for got, want in zip(idx + weights, want_idx + want_weights):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 256])
@pytest.mark.parametrize("order", ORDERS)
def test_window_taken_exactly_where_no_tap_reflects(order, n):
    c = edge_coords(n)
    idx, _ = bs._spline_taps(c, n, order)
    window = (idx[-1] - idx[0]) == order  # the kernel's test
    assert torch.equal(window, ~taps_reflect(c, n, order))
    if n == 256:
        assert bool(window.any()) and bool((~window).any())
    for d in range(order + 1):  # a window's taps are the run from its start
        assert torch.equal(idx[d][window], idx[0][window] + d)


@pytest.mark.parametrize("n", [1, 2, 256])
@pytest.mark.parametrize("order", ORDERS)
def test_window_picks_the_spline_taps(order, n):
    """The window's picks equal the taps' values wherever it is taken,
    from every alignment of the row in memory."""
    rng = np.random.default_rng(order * 10 + n)
    c = edge_coords(n)
    idx, _ = bs._spline_taps(c, n, order)
    window = (idx[-1] - idx[0]) == order
    for base in range(4):  # the row's first float at each shift of its float4
        memory = torch.zeros(base + n + 16)
        memory[base: base + n] = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        picks = window_picks(memory, base + idx[0], order)
        for d in range(order + 1):
            want = memory[base + idx[d]]
            assert torch.equal(picks[d][window], want[window])


def mirror_coords_kernel(memory, offset, shape, coords, fill, order):
    """The kernel's evaluation at one channel, in its order, on (B, 1, I,
    J, K) coefficients stored in ``memory`` (flat float32, starting on 16
    bytes) from float ``offset``: each (i, j) row's k taps by
    window_picks where no tap reflects, else one by one."""
    b_count, c, si, sj, sk = shape
    assert c == 1
    t = order + 1
    memory = torch.cat([memory, torch.zeros(16)])  # what a float4 may read past the end
    outs = []
    for b in range(b_count):
        grid = coords[b if coords.shape[0] > 1 else 0]
        ci, cj, ck = grid[..., 0], grid[..., 1], grid[..., 2]
        ti, wi = bs._spline_taps(ci, si, order)
        tj, wj = bs._spline_taps(cj, sj, order)
        tk, wk = bs._spline_taps(ck, sk, order)
        window = (tk[-1] - tk[0]) == order
        base = offset + b * si * sj * sk
        acc = torch.zeros(ci.shape)
        for a in range(t):
            for bb in range(t):
                row = base + (ti[a] * sj + tj[bb]) * sk
                picks = window_picks(memory, row + tk[0], order)
                x = [torch.where(window, picks[d], memory[row + tk[d]]) for d in range(t)]
                kv = wk[0] * x[0]
                for d in range(1, t):
                    kv = kv + wk[d] * x[d]
                acc = acc + (wi[a] * wj[bb]) * kv
        mask = bs._inbounds_mask((ci, cj, ck), (si, sj, sk))
        outs.append(torch.where(mask > 0.5, acc, fill[b, 0])[None])
    return torch.stack(outs)


def rotated_coords(in_shape, out_shape, b, seed):
    """Per-element rotated, scaled grids over the volume, jittered, whose
    borders leave it."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(b):
        angles = rng.uniform(-0.2, 0.2, 3)
        ca, sa = np.cos(angles), np.sin(angles)
        rx = np.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
        ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
        rz = np.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
        scale = np.diag([(i - 1) / max(o - 1, 1) * 1.1 for i, o in zip(in_shape, out_shape)])
        m = rx @ ry @ rz @ scale
        out_c = (np.asarray(out_shape) - 1) / 2
        shift = (np.asarray(in_shape) - 1) / 2 - m @ out_c + rng.uniform(-1.5, 1.5, 3)
        idx = np.stack(np.meshgrid(*[np.arange(n) for n in out_shape], indexing="ij"), -1)
        grid = idx @ m.T + shift + rng.uniform(-0.5, 0.5, (*out_shape, 3))
        grids.append(grid.astype(np.float32))
    return torch.as_tensor(np.stack(grids))


@pytest.mark.parametrize(
    "in_shape,out_shape",
    [((12, 14, 20), (13, 11, 22)), ((9, 7, 2), (6, 5, 7)), ((5, 6, 1), (4, 4, 3)),
     ((7, 5, 31), (3, 4, 155))],
)
@pytest.mark.parametrize("order", ORDERS)
def test_window_sums_equal_the_plain_version(order, in_shape, out_shape):
    rng = np.random.default_rng(order)
    b = 2
    # one float ahead of the elements: their rows start at every shift
    storage = torch.as_tensor(rng.random(1 + b * int(np.prod(in_shape)), np.float32))
    coeffs = storage[1:].view(b, 1, *in_shape)
    coords = rotated_coords(in_shape, out_shape, b, order)
    fill = torch.as_tensor(rng.uniform(-1.0, 2.0, (b, 1)).astype(np.float32))
    for grids in (coords, coords[:1]):  # per-element and shared
        want = bs.bspline_coords_plain(coeffs, grids, fill, order)
        got = mirror_coords_kernel(storage, 1, coeffs.shape, grids, fill, order)
        assert torch.equal(got, want)
