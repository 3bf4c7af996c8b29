#!/usr/bin/env python3
"""Probe: the trilinear resample kernels' layout at the headline's and
kspace's shapes.

Builds ``probes/resample_layout.cu`` (``csrc/resample.cu`` plus the
kernel it replaced: one thread per output voxel over the flat index,
64-bit index division, the whole sample point a voxel) and times, on

- the grid specs of one headline Spatial draw (B=4 x 1 x 256^3, linear,
  elastic 7^3 field, the per-element minimum as fill), and
- the per-element grids of one Motion draw at kspace's shape (B=4 x
  256^3, linear, no fill),

these forms of the same resample:

- ``flat``: the replaced kernel;
- ``rows``: the package's kernels (``resample_cuda`` /
  ``resample_coords_cuda``): row tiles, 32-bit offsets, the row's map and
  field lerps once for the 2 k tiles of 128 voxels a block serves, a
  lane's voxels one at a time at 4 blocks an SM, warp-strided from grid
  specs and consecutive on dense coordinates;
- the same row-tiled kernel in each layout of ``LAYOUTS``
  (``probes/resample_layout.cu``): a lane's 4 voxels of a k tile on
  consecutive ko (``consecutive``) or a warp-width apart (``strided``: a
  warp's lanes on consecutive ko); held at once (``held``: all four
  voxels' corners live across the channel loop, 16-byte stores and
  coordinate loads where consecutive), taken one at a time (``voxels``,
  the package's way), one at a time with the loop unrolled twice
  (``unrolled``), or with a lane's dk = 1 corners taken by a warp shuffle
  from the next lane's dk = 0 loads where they are the same voxel
  (``shuffled``); at 1-4 blocks an SM (``__launch_bounds__``: 255, 128,
  80 or 64 registers a thread); each with 1 or 2 k tiles of 128 voxels a
  block (``_x1``, ``_x2``: a row's map and field lerps set up once for
  each);
- ``rows_unstaged`` (headline): the package's kernel with the field
  upsampled whole a voxel, as it does for a field too fine to stage (an
  ablation of the row lerps);
- ``rows_wide``: the package's kernel with 64-bit offsets inside a
  volume (an ablation of the 32-bit ones);
- ``cross``: the package's other kernel on the same sample points: the
  dense kernel on the headline draw's coordinates (built by the plain
  version), and the grid-spec kernel on the Motion draw's rigid maps
  (whose points are the dense grid's, bit for bit). Together they split
  a path's time between where its points come from and its gathers.

Every form is first checked equal, bit for bit, to the package's kernel
and to the plain version, then all are timed twice in turns (flat, rows,
..., ..., rows, flat) with CUDA events. Needs a CUDA GPU and nvcc; run
from the repository's root:

    python3 probes/resample_layout.py
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
from torchio_tpu_torch import config  # noqa: E402
from torchio_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from torchio_tpu_torch.ops import resample_kernel as rk  # noqa: E402

rs = importlib.import_module("torchio_tpu_torch.ops.resample")
I32, I64, F32, P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p
HEAD = [P] * 4 + [I64] + [P] * 2 + [I32] * 11 + [F32] * 3 + [I32] * 2
#: the row-tiled layouts the probe library instantiates, by variant
#: number: the lane's voxels held at once (16-byte stores and coordinate
#: loads where the layout is consecutive and the row aligned), one at a
#: time, one at a time unrolled twice, or with shuffled corner pairs; on
#: consecutive ko or a warp-width apart; the blocks an SM
LAYOUTS = {
    "held_consecutive_1": 0, "held_consecutive_2": 1, "held_strided_2": 2,
    "voxels_strided_4": 3, "voxels_consecutive_4": 4, "voxels_strided_3": 5,
    "voxels_consecutive_3": 6, "voxels_strided_2": 7, "unrolled_strided_4": 8,
    "unrolled_consecutive_4": 9, "shuffled_strided_4": 10,
}
#: each layout with 1 and 2 k tiles (of 128 voxels) a block: (variant,
#: tiles a block)
VARIANTS = {
    f"{name}_x{tiles}": (variant, tiles)
    for name, variant in LAYOUTS.items() for tiles in (1, 2)
}
#: the ablations of the package's kernel
ABLATIONS = ("rows_unstaged", "rows_wide")


def build():
    """nvcc the probe library while the package builds its resample
    library."""
    out = ROOT / "probes" / "_build" / "libresample_layout.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [config.nvcc(), *kl.FLAGS, "-o", str(out), str(ROOT / "probes" / "resample_layout.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    rk.RESAMPLE.build()
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    lib = ctypes.CDLL(str(out))
    lib.probe_resample_flat.argtypes = HEAD + [P]
    lib.probe_resample_rows.argtypes = HEAD + [I32] * 7 + [P]
    for fn in (lib.probe_resample_flat, lib.probe_resample_rows):
        fn.restype = I32
    for line in ptxas_report(log):
        print(f"  ptxas {line}")
    return lib


def ptxas_report(log: str) -> list[str]:
    """Each kernel's registers, stack and spills from ``nvcc -Xptxas -v``,
    under its demangled name where ``c++filt`` is at hand."""
    lines, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and kernel is not None:
            lines.append((kernel, line.split("info    :")[-1].strip()))
    names = [k for k, _ in lines]
    try:
        demangled = subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True, text=True, check=True,
        ).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        demangled = names
    if len(demangled) == len(names):
        names = demangled
    return [f"{name}: {info}" for name, (_, info) in zip(names, lines)]


def resample(lib, kind, vol, fill, apply_fill, maps=None, fields=None, coords=None):
    """One launch of ``kind`` on grid specs (maps, fields) or coords."""
    b, c, si, sj, sk = vol.shape
    if coords is not None:
        out_shape, stride = rk.check_dense(vol, coords)
        g = (b, si, sj, sk, *out_shape, 0, 0, 0, 0.0, 0.0, 0.0)
    else:
        out_shape, coarse = rk._check_grid(vol, maps, fields, (si, sj, sk))
        stride = 0
        g = rk.grid_args(vol, out_shape, coarse)
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=vol.device)
    head = (
        vol.data_ptr(), rk._ptr(maps), rk._ptr(fields), rk._ptr(coords), stride,
        fill.data_ptr(), out.data_ptr(), g[0], c, *g[1:], 0, int(apply_fill),
    )
    stream = kl.stream(vol.device)
    if kind == "flat":
        err = lib.probe_resample_flat(*head, stream)
    else:
        plan = rk.resample_launch_plan(b, *out_shape, (si, sj, sk), g[9])
        smem = 0 if kind == "rows_unstaged" else plan.field_smem
        variant, tiles = VARIANTS.get(kind, (-1, None))
        grid = plan.grid
        if tiles is not None:
            grid = (-(-out_shape[2] // (rk.TILE_K * tiles)), *grid[1:])
        err = lib.probe_resample_rows(
            *head, *grid, plan.z_rows, int(plan.wide or kind == "rows_wide"), smem,
            variant, stream,
        )
    if err:
        raise SystemExit(f"{kind} launch failed: {err}")
    return out


def headline_inputs(dev):
    batch = cs.make_batch(tio, torch, cs.B, (cs.S,) * 3, dev, 1)
    tio.seed(5)
    params = cs.headline(tio).transforms[0].make_params(batch)
    maps, fields = cs.slice_grids(np, rs, params, batch.t1.affines[0], (cs.S,) * 3, dev)
    vol = batch.t1.data.contiguous()
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), cs.B, cs.C, dev)
    return dict(vol=vol, fill=fill, apply_fill=apply_fill, maps=maps, fields=fields)


def kspace_inputs(dev):
    from torchio_tpu_torch.transforms.intensity.motion import _rigid_voxel_matrix

    shape = (cs.S,) * 3
    batch = cs.make_kspace_batch(tio, torch, cs.B, shape, dev, 1)
    tio.seed(5)
    params = tio.Motion(degrees=5, translation=3, num_transforms=1).make_params(batch)
    matrices = [
        _rigid_voxel_matrix(t[0]["degrees"], t[0]["translation"], shape)
        for t in params["transforms"]
    ]
    coords = torch.stack([tio.ops.build_coords(shape, m, device=dev) for m in matrices])
    vol = batch.t1.data.contiguous()
    fill, apply_fill = rs._fill_bc(0.0, cs.B, cs.C, dev)
    return dict(vol=vol, fill=fill, apply_fill=apply_fill, coords=coords, matrices=matrices)


def measure(lib, name, inputs, kinds, package, plain, cross):
    runs = {"flat": lambda: resample(lib, "flat", **inputs), "rows": package}
    runs.update({k: (lambda k=k: resample(lib, k, **inputs)) for k in kinds})
    runs["cross"] = cross
    want = package()
    err = float((want - plain()).abs().max())
    print(f"{name}: package kernel vs plain max abs {err:.3g}")
    for kind, fn in runs.items():
        got = fn()
        print(f"  {kind}: equal to the package kernel {torch.equal(got, want)},"
              f" max abs {float((got - want).abs().max()):.3g}")
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
    x = headline_inputs(dev)
    grid_args = (x["vol"], x["maps"], x["fields"], x["fill"], (cs.S,) * 3, "linear",
                 x["apply_fill"])
    points = torch.stack([
        torch.stack(rs._element_coords(x["maps"], x["fields"], b, (cs.S,) * 3), dim=-1)
        for b in range(cs.B)
    ])
    dense_args = (x["vol"], points, x["fill"], "linear", x["apply_fill"])
    measure(
        lib, f"headline resample B={cs.B} x {cs.S}^3 linear + elastic", x,
        (*VARIANTS, *ABLATIONS),
        lambda: rk.resample_cuda(*grid_args), lambda: rs.resample_plain(*grid_args),
        lambda: rk.resample_coords_cuda(*dense_args),
    )
    del x, grid_args, points, dense_args
    x = kspace_inputs(dev)
    dense_args = (x["vol"], x["coords"], x["fill"], "linear", x["apply_fill"])
    maps, _ = rs._marshal_maps(x.pop("matrices"), [None] * cs.B, dev)
    grid_args = (x["vol"], maps, None, x["fill"], (cs.S,) * 3, "linear", x["apply_fill"])
    measure(
        lib, f"kspace dense resample B={cs.B} x {cs.S}^3 linear, Motion grids", x,
        (*VARIANTS, "rows_wide"),
        lambda: rk.resample_coords_cuda(*dense_args),
        lambda: rs.resample_coords_plain(*dense_args),
        lambda: rk.resample_cuda(*grid_args),
    )


if __name__ == "__main__":
    main()
