#!/usr/bin/env python3
"""Probe: the spline kernel's coefficient layout at the brats shape.

Builds ``probes/spline_layout.cu`` (``csrc/bspline.cu`` plus the kernel
it replaced, which reads planar (B, C, I, J, K) coefficients one channel
a load) and times, on the coefficients and grid specs of one
brats-label-bspline Spatial draw (B=4 x 4 x 240x240x155, cubic, elastic):

- ``planar``: the replaced kernel on planar coefficients;
- ``tiled``: the shared-memory design that was tried instead (4 x 16 x 16
  output tiles, each channel's coefficient box staged double-buffered),
  on planar coefficients, with boxes of up to 4,608 floats
  double-buffered; ``tiled_no_load`` skips its box loads and
  ``tiled_setup`` also its sums (ablations: what the setup, the loads and
  the sums cost);
- ``channels_last_v4``: the package's kernel on the prefilter kernel's
  channels-last coefficients, four channels a ``float4`` load;
- ``channels_last_v1``: the same kernel one channel a load;
- ``to_channels_last``: PyTorch's copy of planar coefficients to
  channels-last, the work the prefilter's layout saves.

Each full kernel is checked against the planar one (the same bits), then
all are timed twice in turns with CUDA events. Needs a CUDA GPU and nvcc;
run from the repository's root:

    python3 probes/spline_layout.py
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
from torchio_tpu_torch.ops import bspline_kernel as bk  # noqa: E402
from torchio_tpu_torch.ops import kernel_lib as kl  # noqa: E402
from torchio_tpu_torch.ops.resample_kernel import _check_grid, _ptr, grid_args  # noqa: E402

rs = importlib.import_module("torchio_tpu_torch.ops.resample")
I32, F32, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def build():
    """nvcc the probe library while the package builds its own."""
    out = ROOT / "probes" / "_build" / "libspline_layout.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [config.nvcc(), *kl.FLAGS, "-o", str(out), str(ROOT / "probes" / "spline_layout.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    kl.build_all()
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    lib = ctypes.CDLL(str(out))
    lib.probe_spline_planar.argtypes = [P] * 5 + [I32] * 11 + [F32] * 3 + [P]
    lib.probe_spline_planar.restype = I32
    lib.probe_spline_tiled.argtypes = [P] * 5 + [I32] * 11 + [F32] * 3 + [I32, I32, P, P]
    lib.probe_spline_tiled.restype = I32
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry" in line and "ILi3ELN3tio6SourceE1E" in line:
            name = "planar" if "planar" in line else "tiled" if "tile_kernel" in line else "channels-last"
            print(f"  ptxas {name}:", " ".join(x.strip() for x in lines[n + 1:n + 3]))
    return lib


#: the tiled kernel's double-buffered box budget (floats a buffer)
BOX_FLOATS = 4608
#: its ablation modes
TILED_MODES = {"tiled": 0, "tiled_no_load": 1, "tiled_setup": 2}


def spline(lib, coeffs, maps, fields, fill, out_shape, kind, branches=None):
    out_shape, coarse = _check_grid(coeffs, maps, fields, out_shape)
    b, c = coeffs.shape[:2]
    out = torch.empty((b, c, *out_shape), dtype=torch.float32, device=coeffs.device)
    g = grid_args(coeffs, out_shape, coarse)
    head = (coeffs.data_ptr(), maps.data_ptr(), _ptr(fields), fill.data_ptr(), out.data_ptr())
    stream = kl.stream(coeffs.device)
    if kind == "planar":
        assert coeffs.is_contiguous()
        err = lib.probe_spline_planar(*head, g[0], c, *g[1:], stream)
    elif kind in TILED_MODES:
        assert coeffs.is_contiguous()
        counts = None if branches is None else branches.data_ptr()
        err = lib.probe_spline_tiled(
            *head, g[0], c, *g[1:], BOX_FLOATS, TILED_MODES[kind], counts, stream
        )
    else:
        assert coeffs.is_contiguous(memory_format=torch.channels_last_3d)
        vec = 4 if kind == "channels_last_v4" else 1
        err = bk.BSPLINE.build().tio_bspline_resample(*head, g[0], c, *g[1:], 3, vec, stream)
    if err:
        raise SystemExit(f"{kind} launch failed: {err}")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip())
    lib = build()
    dev = torch.device("cuda")
    batch = cs.make_brats_batch(tio, torch, cs.BRATS_B, cs.BRATS_SHAPE, dev, 0)
    tio.seed(6)
    params = cs.brats_pipeline(tio).transforms[0].make_params(batch)
    maps, fields = cs.slice_grids(np, rs, params, batch.mri.affines[0], cs.BRATS_SHAPE, dev)
    mri = batch.mri.data.contiguous()
    del batch
    fill, _ = rs._fill_bc(torch.amin(mri, dim=(-3, -2, -1)), cs.BRATS_B, cs.BRATS_C, dev)
    channels_last = bk.prefilter_cuda(mri, 3)
    del mri
    planar = channels_last.contiguous()
    inputs = {"planar": planar, **{kind: planar for kind in TILED_MODES},
              "channels_last_v4": channels_last, "channels_last_v1": channels_last}
    runs = {
        kind: (lambda k=kind, x=x: spline(lib, x, maps, fields, fill, cs.BRATS_SHAPE, k))
        for kind, x in inputs.items()
    }
    want = runs["planar"]()
    branches = torch.zeros(3, dtype=torch.int32, device=dev)
    got = spline(lib, planar, maps, fields, fill, cs.BRATS_SHAPE, "tiled", branches)
    print(f"tiled: max abs vs planar {float((got - want).abs().max())}; tiles by branch"
          f" (device memory, single, double buffer) {branches.tolist()}")
    for kind in ("channels_last_v4", "channels_last_v1"):
        print(f"{kind}: max abs vs planar {float((runs[kind]() - want).abs().max())}")
    del want, got
    runs["to_channels_last"] = lambda: planar.contiguous(memory_format=torch.channels_last_3d)
    times = {name: [] for name in runs}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(cs.cuda_time_ms(torch, fn, 10))
    for name, ts in times.items():
        print(f"{name}: {', '.join(f'{t:.3f}' for t in ts)} ms")


if __name__ == "__main__":
    main()
