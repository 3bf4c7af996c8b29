"""Host-side plan and row arithmetic of the row-tiled kernels: the
trilinear resample and the label vote (``csrc/resample.cu``,
``csrc/label_resample.cu``, both on ``csrc/row_tiles.cuh``;
``ops/resample_kernel.py``).

The CUDA kernels run only on the card; what the host tells them, and
the order in which they do their arithmetic, is plain and is held here:

- :func:`resample_launch_plan` keeps every grid dimension inside CUDA's
  limits, and its blocks, with the loops that fold the axes past the
  cap and walk a row's k tiles, serve every output voxel exactly once
  (emulated with numpy, as the kernel's loops run); it picks 64-bit
  offsets exactly when one (b, c) volume holds 2^31 voxels or more, and
  stages the field's row lerps while they fit the block's shared memory;
- the row form of the sample point: the map's ``i m0 + j m1`` once a row,
  and the field's i- and j-lerps at the coarse k points once a row with
  the k-lerp a voxel, equal bit for bit to the plain version's
  ``coord_planes`` and ``upsample_field`` (so the kernel's coordinates,
  built with ``-fmad=false``, are the plain version's), and to the JAX
  package's ``upsample_field`` within its own test's tolerance;
- the label kernel's launch: the same plan with a warp's lanes on
  consecutive ko serves every voxel once (brats' Ko = 155 rows in five
  warp turns), its row-form point is the plain version's bit for bit,
  and the plain vote it is held to on the card equals the JAX package's
  "corners" vote on the row tiling's edges, off near ties.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu.config as jax_config
from test_torch_label_spline import (
    _assert_labels_match, _jax_vote, _label_case, _port_labels,
)
from torchio_tpu.ops.resample import upsample_field as jax_upsample_field
from torchio_tpu_torch.ops import resample_kernel as rk
from torchio_tpu_torch.ops.kernel_lib import field_ratio

# the ops package exports the function ``resample`` under its module's name
rs = importlib.import_module("torchio_tpu_torch.ops.resample")

#: CUDA's launch limits: gridDim.x, gridDim.y, gridDim.z
@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather: its
    opt-in float16 gather (left on for the rest of a process by importing
    ``bench.py``, as ``tests/test_parallel.py`` does) rounds the corner
    values by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


GRID_LIMITS = (2**31 - 1, 65535, 65535)
BIG = 2**31 - 1
#: the JAX package's own tolerance for upsample_field
#: (tests/test_ops_resample.py::test_upsample_field_matches_interpolate)
FIELD_RTOL, FIELD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    import torchio_tpu_torch as tt

    before = tt.config.default_device()
    tt.set_default_device("cpu")
    yield
    tt.set_default_device(before)


def within_limits(plan) -> bool:
    return all(1 <= g <= cap for g, cap in zip(plan.grid, GRID_LIMITS))


def progression_counts(starts, step: int, n: int) -> np.ndarray:
    """How many indices ``for t in range(start, n, step)`` visits, per start."""
    starts = np.asarray(starts, np.int64)
    return np.maximum(0, -(-(n - starts) // step))


def assert_progressions_cover(starts, step: int, n: int) -> None:
    """The loops ``for t in range(start, n, step)`` over ``starts`` visit
    every index of [0, n) exactly once: their counts sum to n, and the
    starts that visit anything lie in [0, step) with distinct residues,
    so no two progressions meet."""
    starts = np.asarray(starts, np.int64)
    counts = progression_counts(starts, step, n)
    assert counts.sum() == n
    live = starts[counts > 0]
    assert live.min() == 0 and live.max() < step
    assert np.unique(live % step).size == live.size


def tile_offsets(layout: str) -> np.ndarray:
    """The ko offsets inside a k tile of (lane, voxel v), as ``ko_of``
    computes them: 4 consecutive ko a lane, or a warp-width apart. A
    lane's voxels lie further on along v, so its loop's break at Ko skips
    only voxels past the row."""
    lane = np.arange(rk.LANES)[:, None]
    v = np.arange(rk.VEC)[None, :]
    offsets = (lane * rk.VEC + v) if layout == "consecutive" else (lane + v * rk.LANES)
    assert (np.diff(offsets, axis=1) > 0).all()
    return offsets


def assert_plan_covers(plan, b: int, io: int, jo: int, ko: int) -> None:
    """Every voxel of (b, Io, Jo, Ko) served exactly once by the plan's
    blocks, axis by axis (a block serves the product of its three axes'
    sets, so once on each axis is once in all)."""
    gx, gy, gz = plan.grid
    # z: block z serves b = z // z_rows stepping by gz // z_rows and
    # io = z % z_rows stepping by z_rows; the (z // z_rows, z % z_rows)
    # pairs are every pair once when z_rows divides gz
    assert gz % plan.z_rows == 0
    b_step = gz // plan.z_rows
    assert_progressions_cover(np.arange(b_step), b_step, b)
    assert_progressions_cover(np.arange(plan.z_rows), plan.z_rows, io)
    # y: block y serves j tiles y, y + gy, ...; a tile's ROWS warps take
    # rows tile * ROWS + warp below Jo
    assert_progressions_cover(np.arange(gy), gy, -(-jo // rk.ROWS))
    # x: block x serves k tiles x, x + gx, ... of TILE_K ko (below Ko);
    # a tile's lanes and voxels take each of its TILE_K offsets once
    assert_progressions_cover(np.arange(gx), gx, -(-ko // rk.TILE_K))
    for layout in ("consecutive", "strided"):
        offsets = np.sort(tile_offsets(layout).ravel())
        np.testing.assert_array_equal(offsets, np.arange(rk.TILE_K))


def emulate_plan(
    plan, b: int, io: int, jo: int, ko: int, layout: str = "consecutive"
) -> np.ndarray:
    """The number of times each (b, io, jo, ko) voxel is served, running
    the kernel's block loops with numpy (small shapes), a tile's lanes in
    ``layout``."""
    gx, gy, gz = plan.grid
    b_step = gz // plan.z_rows
    j_tiles = -(-jo // rk.ROWS)
    z_pairs, y_rows, x_cols = [], [], []
    for z in range(gz):
        bs = np.arange(z // plan.z_rows, b, b_step)
        ios = np.arange(z % plan.z_rows, io, plan.z_rows)
        z_pairs.append((bs[:, None] * io + ios[None, :]).ravel())
    for y in range(gy):
        tiles = np.arange(y, j_tiles, gy)
        rows = (tiles[:, None] * rk.ROWS + np.arange(rk.ROWS)[None, :]).ravel()
        y_rows.append(rows[rows < jo])
    for x in range(gx):
        tiles = np.arange(x, -(-ko // rk.TILE_K), gx)
        cols = (tiles[:, None] * rk.TILE_K + tile_offsets(layout).ravel()).ravel()
        x_cols.append(cols[cols < ko])
    pairs = np.bincount(np.concatenate(z_pairs), minlength=b * io)
    rows = np.bincount(np.concatenate(y_rows), minlength=jo)
    cols = np.bincount(np.concatenate(x_cols), minlength=ko)
    return pairs.reshape(b, io)[:, :, None, None] * rows[:, None] * cols


@pytest.mark.parametrize(
    "shape",
    [
        (4, 256, 256, 256),  # the headline
        (2, 9, 10, 1),  # rows shorter than a thread's run
        (2, 9, 10, 5),  # not a multiple of it
        (2, 3, 4, 1100),  # wider than a block's tile
        (2, 70000, 1, 2),  # io past grid z's cap
        (2, 40000, 1, 2),  # io x b past it, io under it
        (1, 1, 600000, 1),  # j tiles past grid y's cap
        (70000, 1, 1, 3),  # b past it
        (1, 2, 3, 5000),  # a block's k tiles a row: 40 tiles, 20 blocks
    ],
)
def test_plan_serves_every_voxel_once(shape):
    plan = rk.resample_launch_plan(*shape)
    assert within_limits(plan)
    assert_plan_covers(plan, *shape)
    counts = emulate_plan(plan, *shape)
    assert counts.shape == shape and (counts == 1).all()


@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 1, BIG), (1, 1, BIG, 1), (1, BIG, 1, 1), (BIG, 1, 1, 1),
        (BIG, BIG, BIG, BIG), (4, BIG, 8, 128), (65535, 65535, 1, 1),
        (65536, 65535, 1, 1), (3, 65536, 524281, 129),
    ],
)
def test_plan_folds_large_axes(shape):
    plan = rk.resample_launch_plan(*shape)
    assert within_limits(plan)
    assert_plan_covers(plan, *shape)


@settings(max_examples=200, deadline=None)
@given(
    st.tuples(*[st.one_of(st.integers(1, 300), st.integers(1, BIG)) for _ in range(4)])
)
def test_plan_within_limits_and_covers(shape):
    plan = rk.resample_launch_plan(*shape)
    assert within_limits(plan)
    assert_plan_covers(plan, *shape)


@settings(max_examples=40, deadline=None)
@given(
    st.integers(1, 3), st.integers(1, 70000), st.integers(1, 20), st.integers(1, 300),
)
def test_plan_emulated_on_small_shapes(b, io, jo, ko):
    if b * io * jo * ko > 2_000_000:
        io = max(1, 2_000_000 // (b * jo * ko))
    plan = rk.resample_launch_plan(b, io, jo, ko)
    counts = emulate_plan(plan, b, io, jo, ko)
    assert (counts == 1).all()


@pytest.mark.parametrize(
    "in_shape,wide",
    [
        ((256, 256, 256), False),
        ((1290, 1290, 1290), False),  # 2,146,689,000 voxels
        ((1291, 1291, 1291), True),  # 2,151,685,171
        ((BIG, 1, 1), False),  # 2^31 - 1: the last offset is 2^31 - 2
        ((2**16, 2**15, 1), True),  # 2^31
        ((1, 1, 1), False),
    ],
)
def test_plan_offset_width(in_shape, wide):
    plan = rk.resample_launch_plan(1, 8, 8, 8, in_shape)
    assert plan.wide is wide
    if not wide:  # the largest 32-bit offset, (I-1)JK + (J-1)K + K-1, fits
        si, sj, sk = in_shape
        assert (si - 1) * sj * sk + (sj - 1) * sk + sk - 1 < 2**31


@pytest.mark.parametrize(
    "coarse_k,smem",
    [(0, 0), (7, rk.ROWS * 7 * 3 * 4), (512, 48 * 1024), (513, 0), (600, 0)],
)
def test_plan_stages_fields_that_fit(coarse_k, smem):
    assert rk.resample_launch_plan(4, 256, 256, 256, (256,) * 3, coarse_k).field_smem == smem


# --------------------------------------------------------------------
# the row form of the sample point
# --------------------------------------------------------------------


def _lerp(a0, a1, f):
    return a0 * (1.0 - f) + a1 * f


def coarse_axis(n_out: int, n: int):
    """``coarse_axis`` of every output index: float32 ``o * ratio``, the
    clamped floor and its neighbour, and the fraction."""
    g = torch.arange(n_out, dtype=torch.float32) * torch.tensor(
        field_ratio(n, n_out), dtype=torch.float32
    )
    c0 = torch.floor(g).long().clamp(0, n - 1)
    return c0, (c0 + 1).clamp(max=n - 1), g - c0.to(torch.float32)


def row_form_field(cp: torch.Tensor, out_shape) -> torch.Tensor:
    """The kernel's upsample: for each row (io, jo), the i-lerp and then
    the j-lerp at each of the nk coarse k points (the row's staged
    (nk, 3) entries); for each voxel, the k-lerp of two of them."""
    ni, nj, nk = cp.shape[:3]
    io, jo, ko = out_shape
    i0, i1, fi = coarse_axis(io, ni)
    j0, j1, fj = coarse_axis(jo, nj)
    k0, k1, fk = coarse_axis(ko, nk)
    out = torch.empty((io, jo, ko, 3), dtype=torch.float32)
    for i in range(io):
        for j in range(jo):
            along_j0 = _lerp(cp[i0[i], j0[j]], cp[i1[i], j0[j]], fi[i])
            along_j1 = _lerp(cp[i0[i], j1[j]], cp[i1[i], j1[j]], fi[i])
            staged = _lerp(along_j0, along_j1, fj[j])  # (nk, 3)
            out[i, j] = _lerp(staged[k0], staged[k1], fk[:, None])
    return out


def row_form_map(map34: torch.Tensor, out_shape) -> tuple[torch.Tensor, ...]:
    """The kernel's map: ``i m0 + j m1`` once a row, then ``(row + k m2)
    + m3`` a voxel."""
    io, jo, ko = out_shape
    planes = []
    for a in range(3):
        plane = torch.empty(out_shape, dtype=torch.float32)
        fk = torch.arange(ko, dtype=torch.float32)
        for i in range(io):
            for j in range(jo):
                row = torch.tensor(float(i), dtype=torch.float32) * map34[a, 0] + torch.tensor(
                    float(j), dtype=torch.float32
                ) * map34[a, 1]
                plane[i, j] = (row + fk * map34[a, 2]) + map34[a, 3]
        planes.append(plane)
    return tuple(planes)


@pytest.mark.parametrize(
    "coarse,out_shape",
    [
        ((7, 7, 7), (16, 12, 40)),  # the headline's control grid
        ((7, 7, 7), (5, 3, 1)),  # size-1 output axis
        ((4, 9, 6), (13, 20, 29)),  # non-cubic
        ((5, 3, 11), (9, 17, 7)),  # more k points than output k
    ],
)
def test_row_form_field_is_the_plain_upsample(coarse, out_shape):
    cp = np.random.default_rng(sum(coarse)).uniform(-7.5, 7.5, (*coarse, 3)).astype(np.float32)
    got = row_form_field(torch.as_tensor(cp), out_shape)
    want = rs.upsample_field(torch.as_tensor(cp), out_shape)
    assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_upsample_field(jnp.asarray(cp), out_shape)),
        rtol=FIELD_RTOL, atol=FIELD_ATOL,
    )


@pytest.mark.parametrize("out_shape", [(9, 11, 37), (3, 1, 130)])
def test_row_form_map_is_the_plain_map(out_shape):
    rng = np.random.default_rng(3)
    map34 = torch.as_tensor(rng.uniform(-1.5, 1.5, (3, 4)).astype(np.float32))
    map34[:, 3] = torch.as_tensor(rng.uniform(-20, 20, 3).astype(np.float32))
    for got, want in zip(row_form_map(map34, out_shape), rs.coord_planes(map34, out_shape)):
        assert torch.equal(got, want)


# --------------------------------------------------------------------
# the label kernel: the same plan and row form, warp-strided lanes
# --------------------------------------------------------------------

#: brats' control grid: the elastic field the label kernel stages
BRATS_COARSE = (7, 7, 7)


def label_plan(b: int, out_shape, in_shape):
    """The plan ``resample_label_cuda`` launches a (B, 1, *in_shape) label
    batch with, under brats' control grid."""
    return rk.resample_launch_plan(b, *out_shape, in_shape, BRATS_COARSE[2])


@pytest.mark.parametrize(
    "shape",
    [
        (4, 240, 240, 155),  # brats: a row is one block's two k tiles
        (2, 9, 10, 1),  # rows of 1, 3 and 5 voxels
        (2, 9, 10, 3),
        (2, 9, 10, 5),
        (2, 3, 4, 1100),  # rows of five blocks
        (2, 70000, 1, 2),  # io past grid z's cap
        (2, 40000, 1, 2),  # io x b past it
        (1, 1, 600000, 1),  # j tiles past grid y's cap
    ],
)
def test_label_plan_serves_every_voxel_once(shape):
    plan = label_plan(shape[0], shape[1:], shape[1:])
    assert within_limits(plan)
    assert plan.field_smem == rk.ROWS * 7 * 3 * 4 and not plan.wide
    counts = emulate_plan(plan, *shape, layout="strided")
    assert counts.shape == shape and (counts == 1).all()


@pytest.mark.parametrize("layout,turns", [("strided", 5), ("consecutive", 8)])
def test_label_rows_of_155_take_five_warp_turns(layout, turns):
    """A warp's turns on a Ko = 155 row (a turn: one voxel of each lane
    whose voxel lies on the row): with the lanes on consecutive ko, four
    full turns and one of 27 lanes; with a lane's 4 consecutive ko, the
    second k tile's 7 lanes take four more."""
    ko = 155
    live = 0
    for tile in range(-(-ko // rk.TILE_K)):
        cols = tile * rk.TILE_K + tile_offsets(layout)  # (lane, v)
        live += int((cols < ko).any(axis=0).sum())
    assert live == turns


@pytest.mark.parametrize(
    "coarse,out_shape",
    [
        (BRATS_COARSE, (6, 5, 155)),  # brats' control grid, Ko = 155
        (BRATS_COARSE, (3, 2, 1)),  # rows of one voxel
        ((4, 9, 6), (13, 20, 29)),
    ],
)
def test_label_row_point_is_the_plain_point(coarse, out_shape):
    """The label kernel's point (the row's map and staged field lerps, a
    voxel's k terms) is the plain vote's point bit for bit."""
    rng = np.random.default_rng(out_shape[2])
    map34 = torch.as_tensor(rng.uniform(-1.5, 1.5, (3, 4)).astype(np.float32))
    cp = rng.uniform(-7.5, 7.5, (*coarse, 3)).astype(np.float32)
    field = row_form_field(torch.as_tensor(cp), out_shape)
    maps = map34[None].contiguous()
    fields = torch.as_tensor(cp)[None].contiguous()
    want = rs._element_coords(maps, fields, 0, out_shape)
    for a, (plane, plain) in enumerate(zip(row_form_map(map34, out_shape), want)):
        assert torch.equal(plane + field[..., a], plain)


#: the vote on the row tiling's edges: rows of 155 voxels (brats' Ko),
#: of 1, 3 and 5; int32 and float labels; labels drawn per voxel (ties)
VOTE_CASES = {
    "int32-rows-of-155": _label_case((2, 1, 12, 14, 31), out=(9, 10, 155)),
    "float-rows-of-155": _label_case((2, 1, 12, 14, 31), out=(9, 10, 155), dtype=np.float32),
    "int32-rows-of-1": _label_case((2, 1, 12, 14, 20), out=(9, 10, 1), seed=1),
    "float-rows-of-3": _label_case((2, 1, 12, 14, 20), out=(9, 10, 3), seed=2,
                                   dtype=np.float32),
    "int32-rows-of-5": _label_case((2, 1, 12, 14, 20), out=(9, 10, 5), seed=3),
    "per-voxel-labels": _label_case((2, 1, 12, 14, 31), out=(9, 10, 155), labels=5, seed=4,
                                    elastic=(True, True)),
}


@pytest.mark.parametrize("name", list(VOTE_CASES))
def test_plain_vote_matches_jax_on_row_edges(name):
    case = VOTE_CASES[name]
    _assert_labels_match(case, _port_labels(case), _jax_vote(case))
