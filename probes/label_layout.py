#!/usr/bin/env python3
"""Probe: the label vote's layout at brats-label-bspline's shape.

Builds ``probes/label_layout.cu`` (``csrc/label_resample.cu`` plus the
kernel it replaced: one thread per output voxel over the flat index,
64-bit index division, the whole sample point and the full vote a voxel)
and times, on the grid specs of one brats-label-bspline Spatial draw
(B=4 x 1 x 240x240x155 int32, elastic 7^3 field, pad 0) and two label
maps,

- ``brats``: the cell's block-structured labels {0, 1, 2, 4} (most
  voxels' 8 corners carry one label), and
- ``noisy``: labels {0, 1, 2, 4} drawn independently per voxel (almost
  none do: the vote runs for nearly every voxel),

these forms of the same vote:

- ``flat``: the replaced kernel;
- ``rows``: the package's kernel (``resample_label_cuda``): resample.cu's
  row tiles (``csrc/row_tiles.cuh``), 32-bit offsets, the row's map and
  field lerps once for the 2 k tiles of 128 voxels a block serves (a
  Ko = 155 row is one block's), a lane's voxels one at a time, a warp's
  lanes on consecutive ko, 4 blocks an SM, the full vote for every voxel;
- the same row-tiled kernel in each layout of ``LAYOUTS``: uniform
  corners (8 of one label) without the vote (``uniform``), a lane's 4
  voxels on consecutive ko (``consecutive``: a Ko = 155 row's second k
  tile keeps 7 of 32 lanes busy for 4 turns, where the package's
  warp-strided lanes take it in one), 3, 2 or 5 blocks an SM
  (``blocks3``, ``blocks2``, ``blocks5``: 80, 128 or 51 registers a
  thread);
- ``rows_x1``: the package's kernel with one k tile a block (a Ko = 155
  row's map and field lerps set up by two blocks);
- ``rows_wide`` and ``rows_unstaged``: the package's kernel with 64-bit
  offsets, and with the field upsampled whole a voxel (ablations).

It prints each map's share of voxels whose 8 corners carry one label,
checks every form equal to the package's kernel and the package's kernel
equal to the plain version, then times all of them twice in turns with
CUDA events. Needs a CUDA GPU and nvcc; run from the repository's root:

    python3 probes/label_layout.py
"""

from __future__ import annotations

import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torchio_tpu_torch as tio  # noqa: E402
from resample_layout import ptxas_report  # noqa: E402
from torchio_tpu_torch import config  # noqa: E402
from torchio_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from torchio_tpu_torch.ops import resample_kernel as rk  # noqa: E402

rs = importlib.import_module("torchio_tpu_torch.ops.resample")
I32, F32, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
HEAD = [P] * 4 + [I32] * 10 + [F32] * 4 + [I32] * 2
#: the row-tiled layouts the probe library instantiates, by variant number
LAYOUTS = {"uniform": 1, "consecutive": 2, "blocks3": 3, "blocks2": 4, "blocks5": 5}
ABLATIONS = ("rows_x1", "rows_wide", "rows_unstaged")


def build():
    """nvcc the probe library while the package builds its label library."""
    out = ROOT / "probes" / "_build" / "liblabel_layout.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [config.nvcc(), *kl.FLAGS, "-o", str(out), str(ROOT / "probes" / "label_layout.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    rk.LABEL.build()
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    lib = ctypes.CDLL(str(out))
    lib.probe_label_flat.argtypes = HEAD + [P]
    lib.probe_label_rows.argtypes = HEAD + [I32] * 7 + [P]
    for fn in (lib.probe_label_flat, lib.probe_label_rows):
        fn.restype = I32
    for line in ptxas_report(log):
        print(f"  ptxas {line}")
    return lib


def vote(lib, kind, seg, maps, fields):
    """One launch of ``kind`` at the input's own shape, pad 0."""
    b = seg.shape[0]
    out_shape = tuple(seg.shape[2:])
    coarse = tuple(fields.shape[1:4])
    g = rk.grid_args(seg, out_shape, coarse)
    out = torch.empty_like(seg)
    head = (seg.data_ptr(), maps.data_ptr(), fields.data_ptr(), out.data_ptr(), *g, 0.0, 0, 0)
    stream = kl.stream(seg.device)
    if kind == "flat":
        err = lib.probe_label_flat(*head, stream)
    else:
        plan = rk.resample_launch_plan(b, *out_shape, out_shape, coarse[2])
        grid = plan.grid
        if kind == "rows_x1":
            grid = (-(-out_shape[2] // rk.TILE_K), *grid[1:])
        err = lib.probe_label_rows(
            *head, *grid, plan.z_rows, int(plan.wide or kind == "rows_wide"),
            0 if kind == "rows_unstaged" else plan.field_smem, LAYOUTS.get(kind, 0), stream,
        )
    if err:
        raise SystemExit(f"{kind} launch failed: {err}")
    return out


def uniform_share(seg, maps, fields) -> float:
    """The share of output voxels whose in-bounds weight exceeds 0.5 and
    whose 8 corners carry one label."""
    out_shape = tuple(seg.shape[2:])
    uniform = 0
    for b in range(seg.shape[0]):
        coords = rs._element_coords(maps, fields, b, out_shape)
        floors = [torch.floor(c).long() for c in coords]
        wsum = 1.0
        for f, c, n in zip(floors, coords, out_shape):
            frac = c - f
            wsum = wsum * ((1 - frac) * ((f >= 0) & (f < n)) + frac * ((f + 1 >= 0) & (f + 1 < n)))
        labs = []
        for d in range(8):
            idx = [torch.clamp(f + o, 0, n - 1)
                   for f, o, n in zip(floors, (d >> 2, (d >> 1) & 1, d & 1), out_shape)]
            labs.append(seg[b, 0][idx[0], idx[1], idx[2]])
        same = torch.stack([lab == labs[0] for lab in labs[1:]]).all(0)
        uniform += int((same & (wsum > 0.5)).sum())
    return uniform / (seg.shape[0] * np.prod(out_shape))


def measure(lib, name, seg, maps, fields):
    kinds = ("flat", "rows", *LAYOUTS, *ABLATIONS)
    runs = {k: (lambda k=k: vote(lib, k, seg, maps, fields)) for k in kinds}
    runs["rows"] = lambda: rk.resample_label_cuda(seg, maps, fields, tuple(seg.shape[2:]), 0.0)
    want = runs["rows"]()
    plain = rs.resample_label_plain(seg, maps, fields, tuple(seg.shape[2:]), 0.0)
    print(f"{name}: package kernel vs plain: {int((want != plain).sum())} voxels differ;"
          f" uniform corners (in bounds) {uniform_share(seg, maps, fields):.4f} of voxels")
    del plain
    for kind, fn in runs.items():
        got = fn()
        print(f"  {kind}: equal to the package kernel {torch.equal(got, want)},"
              f" {int((got != want).sum())} voxels differ")
    del want, got
    order = list(runs)
    times = {kind: [] for kind in order}
    for kind in order + order[::-1]:
        times[kind].append(cs.cuda_time_ms(torch, runs[kind], 20))
    for kind, ts in times.items():
        print(f"  {kind}: {', '.join(f'{t:.3f}' for t in ts)} ms (best {min(ts):.3f})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip())
    lib = build()
    dev = torch.device("cuda")
    batch = cs.make_brats_batch(tio, torch, cs.BRATS_B, cs.BRATS_SHAPE, dev, 1)
    tio.seed(6)
    params = cs.brats_pipeline(tio).transforms[0].make_params(batch)
    maps, fields = cs.slice_grids(np, rs, params, batch.mri.affines[0], cs.BRATS_SHAPE, dev)
    seg = batch.seg.data.contiguous()
    del batch
    shape = "x".join(map(str, cs.BRATS_SHAPE))
    measure(lib, f"brats labels B={cs.BRATS_B} x 1 x {shape} int32 + elastic", seg, maps, fields)
    gen = torch.Generator(device=dev).manual_seed(3)
    noisy = torch.randint(0, 4, seg.shape, generator=gen, device=dev, dtype=torch.int32)
    noisy[noisy == 3] = 4
    measure(lib, f"noisy labels B={cs.BRATS_B} x 1 x {shape} int32 + elastic", noisy, maps,
            fields)


if __name__ == "__main__":
    main()
