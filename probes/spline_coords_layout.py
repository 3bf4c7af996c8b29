#!/usr/bin/env python3
"""Probe: the dense-coordinate spline kernel's design, at order 3 on one
channel of 256^3.

Builds ``probes/spline_coords_layout.cu`` (``csrc/bspline.cu`` plus the
forms below) and times, on the inputs of ``chip_smoke.py``'s dense entry
(one Motion draw on B=4 x 1 x 256^3, cubic, the per-element minimum as
fill):

- B=1: the first element and its grid (the dense entry's spline call);
- B=4: all four elements on their per-element grids (the grids the dense
  resample kernel is timed on);

these forms of the same spline:

- ``old``: the kernel the row form replaced (the grid-spec body on dense
  points: a flat 1-D loop, 64-bit index division, scalar taps);
- ``package``: :func:`bspline_coords_cuda`;
- the row-tiled forms of ``VARIANTS``: a lane's voxels on consecutive or
  warp-strided ko (``consecutive``, ``strided``), each row's k taps as
  scalar loads or float4 windows (``scalar``, ``window``), at 4, 3 or 2
  blocks an SM (64, 80 or 128 registers a thread); ``pairs``: a lane's
  consecutive voxels two at a time, one window serving both where their
  rows match; ``_wide``: 64-bit offsets (an ablation of the 32-bit ones);
  ``box``: the strided form with each block's taps of a 32-ko step staged
  in shared memory; ``interior``: spline_taps' fast path for coordinates
  and taps inside the volume (no ``fmodf``, no integer modulo a tap);
  ``runs``: a C = 1 row's unreflected k taps loaded at constant offsets
  from one address;
- B=1 on a grid that is only shifted (no rotation): a warp's taps then
  lie on one (i, j) row, so its loads touch the fewest L1 lines; against
  the Motion grid this says what the rotation's extra lines cost;
- with ``--parent DIR`` (a copy of the parent tree): its library's dense
  kernel (``parent_old``, a cross-check of ``old``), and its grid-spec
  spline beside the package's on brats-label-bspline's inputs
  (B=4 x 4 x 240x240x155, elastic), which this design must leave as it
  was.

Every form is first checked equal, bit for bit, to the package's kernel,
and the package's kernel to the plain version; then all are timed twice
in turns (old, package, ..., ..., package, old) with CUDA events, 20
launches each. Needs a CUDA GPU and nvcc; run from the repository's
root:

    python3 probes/spline_coords_layout.py [--parent DIR]
"""

from __future__ import annotations

import argparse
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
from probes.resample_layout import ptxas_report  # noqa: E402
from torchio_tpu_torch import config  # noqa: E402
from torchio_tpu_torch.ops import bspline as bs  # noqa: E402
from torchio_tpu_torch.ops import bspline_kernel as bk  # noqa: E402
from torchio_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from torchio_tpu_torch.ops.resample_kernel import check_dense, grid_args  # noqa: E402

rs = importlib.import_module("torchio_tpu_torch.ops.resample")
I32, I64, P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
HEAD = [P] * 4 + [I32] * 8 + [I64]
#: the probe library's row-tiled forms, by variant number
VARIANTS = {
    "consecutive_scalar_4": 0, "consecutive_window_4": 1, "strided_scalar_4": 2,
    "strided_window_4": 3, "consecutive_window_3": 4, "strided_window_3": 5,
    "consecutive_window_2": 6, "strided_window_2": 7, "pairs_3": 8, "pairs_2": 9,
    "consecutive_scalar_4_wide": 10, "strided_scalar_4_wide": 11, "strided_scalar_3": 12,
    "strided_scalar_2": 13, "box_4": 14, "box_3": 15, "strided_interior_4": 16,
    "strided_runs_4": 17, "strided_interior_runs_4": 18, "consecutive_interior_runs_4": 19,
    "strided_interior_runs_4_wide": 20, "strided_interior_4_wide": 21,
    "consecutive_interior_4": 22,
}


def nvcc(source: Path, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [config.nvcc(), *kl.FLAGS, "-o", str(out), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def build(parent: Path | None):
    """nvcc the probe library (and the parent's spline library) while the
    package builds its own."""
    build_dir = ROOT / "probes" / "_build"
    procs = {"probe": nvcc(ROOT / "probes" / "spline_coords_layout.cu",
                           build_dir / "libspline_coords_layout.so")}
    if parent is not None:
        procs["parent"] = nvcc(parent / "torchio_tpu_torch" / "csrc" / "bspline.cu",
                               build_dir / "libbspline_parent.so")
    bk.BSPLINE.build()
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log)
        libs[name] = ctypes.CDLL(proc.args[proc.args.index("-o") + 1])
        if name == "probe":
            report(log, lambda line: any(k in line for k in ("<3,", "ILi3E")))
    probe = libs["probe"]
    probe.probe_coords_old.argtypes = HEAD + [I32, I32, P]
    probe.probe_coords_rows.argtypes = HEAD + [I32] * 5 + [P]
    for fn in (probe.probe_coords_old, probe.probe_coords_rows):
        fn.restype = I32
    if "parent" in libs:
        old = libs["parent"]
        old.tio_bspline_coords.argtypes = HEAD + [I32, I32, P]
        old.tio_bspline_resample.argtypes = bk.BSPLINE.functions["tio_bspline_resample"]
        for fn in (old.tio_bspline_coords, old.tio_bspline_resample):
            fn.restype = I32
    print("  package (every order and width):")
    report(bk.BSPLINE.build_log, lambda line: True)
    return probe, libs.get("parent")


def report(log: str, keep) -> None:
    """ptxas's registers and spills of the spline kernels in ``log``."""
    for line in ptxas_report(log):
        if any(k in line for k in ("Spline", "spline_kernel")) and keep(line):
            print(f"  ptxas {line}")


def spline(fn_kind, coeffs, coords, fill, probe, parent):
    """One launch of the form ``fn_kind`` on channels-last coefficients."""
    out_shape, stride = check_dense(coeffs, coords)
    b, c, si, sj, sk = coeffs.shape
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    head = (coeffs.data_ptr(), coords.data_ptr(), fill.data_ptr(), out.data_ptr(),
            b, c, si, sj, sk, *out_shape, stride)
    stream = kl.stream(coeffs.device)
    if fn_kind == "old":
        err = probe.probe_coords_old(*head, 3, 1, stream)
    elif fn_kind == "parent_old":
        err = parent.tio_bspline_coords(*head, 3, 1, stream)
    else:
        plan = bk.coords_launch_plan(coeffs.shape, out_shape)
        err = probe.probe_coords_rows(*head, *plan.grid, plan.z_rows, VARIANTS[fn_kind], stream)
    if err:
        raise SystemExit(f"{fn_kind} launch failed: {err}")
    return out


def in_turns(runs: dict, reps: int) -> None:
    """Time every run twice, in order and then in reverse order."""
    order = list(runs)
    times = {kind: [] for kind in order}
    for kind in order + order[::-1]:
        times[kind].append(cs.cuda_time_ms(torch, runs[kind], reps))
    for kind, ts in times.items():
        print(f"  {kind}: {', '.join(f'{t:.3f}' for t in ts)} ms (best {min(ts):.3f})")


def measure(name, coeffs, coords, fill, probe, parent):
    args = (coeffs, coords, fill, 3)
    want = bk.bspline_coords_cuda(*args)
    err = float((want - bs.bspline_coords_plain(*args)).abs().max())
    print(f"{name}: package kernel vs plain max abs {err:.3g}")
    runs = {"old": lambda: spline("old", *args[:3], probe, parent),
            "package": lambda: bk.bspline_coords_cuda(*args)}
    if parent is not None:
        runs["parent_old"] = lambda: spline("parent_old", *args[:3], probe, parent)
    runs.update({k: (lambda k=k: spline(k, *args[:3], probe, parent)) for k in VARIANTS})
    for kind, fn in runs.items():
        got = fn()
        print(f"  {kind}: equal to the package kernel {torch.equal(got, want)},"
              f" max abs {float((got - want).abs().max()):.3g}")
    del want, got
    in_turns(runs, 20)


def dense_inputs(dev):
    """chip_smoke.py's dense-entry inputs: one Motion draw's per-element
    grids on B=4 x 1 x 256^3, cubic coefficients, the minimum as fill."""
    from torchio_tpu_torch.transforms.intensity.motion import _rigid_voxel_matrix

    shape = (cs.S,) * 3
    batch = cs.make_kspace_batch(tio, torch, cs.B, shape, dev, 1)
    tio.seed(5)
    params = tio.Motion(degrees=5, translation=3, num_transforms=1).make_params(batch)
    coords = torch.stack([
        tio.ops.build_coords(
            shape, _rigid_voxel_matrix(t[0]["degrees"], t[0]["translation"], shape), device=dev
        )
        for t in params["transforms"]
    ])
    vol = batch.t1.data.contiguous()
    fill, _ = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), cs.B, cs.C, dev)
    return bk.prefilter_cuda(vol, 3), coords, fill


def brats_spline(parent, dev):
    """The grid-spec spline (brats-label-bspline's) in the package and in
    the parent's library, on one draw's inputs, timed in turns."""
    batch = cs.make_brats_batch(tio, torch, cs.BRATS_B, cs.BRATS_SHAPE, dev, 0)
    tio.seed(6)
    params = cs.brats_pipeline(tio).transforms[0].make_params(batch)
    maps, fields = cs.slice_grids(np, rs, params, batch.mri.affines[0], cs.BRATS_SHAPE, dev)
    mri = batch.mri.data.contiguous()
    del batch
    fill, _ = rs._fill_bc(torch.amin(mri, dim=(-3, -2, -1)), cs.BRATS_B, cs.BRATS_C, dev)
    coeffs = bk.prefilter_cuda(mri, 3)
    del mri
    args = (coeffs, maps, fields, fill, cs.BRATS_SHAPE, 3)
    want = bk.bspline_resample_cuda(*args)
    g = grid_args(coeffs, cs.BRATS_SHAPE, tuple(fields.shape[1:4]))
    out = torch.empty_like(want)

    def old():
        err = parent.tio_bspline_resample(
            coeffs.data_ptr(), maps.data_ptr(), fields.data_ptr(), fill.data_ptr(),
            out.data_ptr(), g[0], cs.BRATS_C, *g[1:], 3, 4, kl.stream(dev),
        )
        if err:
            raise SystemExit(f"parent spline launch failed: {err}")
        return out

    print(f"brats grid-spec spline B={cs.BRATS_B} x {cs.BRATS_C} x"
          f" {'x'.join(map(str, cs.BRATS_SHAPE))}: parent equal to the package"
          f" {torch.equal(old(), want)}")
    in_turns({"package": lambda: bk.bspline_resample_cuda(*args), "parent": old}, 10)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, help="a copy of the parent tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip())
    probe, parent = build(args.parent)
    dev = torch.device("cuda")
    coeffs, coords, fill = dense_inputs(dev)
    measure(f"dense spline B=1 x 1 x {cs.S}^3, a Motion grid", coeffs[:1], coords[:1],
            fill[:1], probe, parent)
    measure(f"dense spline B={cs.B} x 1 x {cs.S}^3, per-element Motion grids", coeffs,
            coords, fill, probe, parent)
    shifted = tio.ops.build_coords(
        (cs.S,) * 3, np.array([[1, 0, 0, 0.3], [0, 1, 0, -0.6], [0, 0, 1, 1.2], [0, 0, 0, 1]]),
        device=dev,
    )[None].contiguous()
    measure(f"dense spline B=1 x 1 x {cs.S}^3, a shifted grid (no rotation)", coeffs[:1],
            shifted, fill[:1], probe, parent)
    del coeffs, coords, fill
    if parent is not None:
        brats_spline(parent, dev)


if __name__ == "__main__":
    main()
