#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``torchio_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: requires CUDA; prints the card's name and power limit, and
   the torch, CUDA, nvcc and Triton versions;
2. build: compiles the resample kernel from ``torchio_tpu_torch/csrc``;
3. kernel: holds the CUDA resample kernel against its plain PyTorch
   version on the card (linear within 1e-5 max abs on inputs in [0, 1);
   nearest equal away from .5 ties);
4. slice: the headline ``Compose([Spatial, BiasField, Noise],
   fuse=True)`` on B=4 x 1 x 256^3 float32 through ``Compose.__call__``:
   2 warm-up and 5 timed calls; checks finite outputs, one kernel launch
   per call and 3 history entries; checks a small batch on the card
   against the CPU path; times the kernel against the plain resample at
   the slice's shape.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--profile PATH`` also writes a
``torch.profiler`` table of two slice calls to PATH.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

B, C, S = 4, 1, 256
DEVICE = "cuda"
WARMUP, TIMED = 2, 5
KERNEL_ATOL = 1e-5
SLICE_ATOL = 1e-4
TIE_BAND = 1e-4


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def headline(tio):
    return tio.Compose(
        [
            tio.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
            ),
            tio.BiasField(std=0.5),
            tio.Noise(std=0.1),
        ],
        fuse=True,
    )


def make_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((b, C, *shape), generator=gen, device=device)
    subjects = [tio.Subject(t1=tio.ScalarImage(data[i])) for i in range(b)]
    return tio.SubjectsBatch.from_subjects(subjects)


def cuda_time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rot(ax, ay, az, scale=1.0, shift=(0.0, 0.0, 0.0), center=None):
    import numpy as np

    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = (rx @ ry @ rz) * scale
    c = np.asarray(center, np.float64)
    m[:3, 3] = c - m[:3, :3] @ c + np.asarray(shift)
    return m


def phase_device(torch, config):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    nvcc = subprocess.run(
        [config.nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "not installed"
    print(
        f"python {sys.version.split()[0]}; torch {torch.__version__};"
        f" CUDA {torch.version.cuda}; nvcc: {nvcc}; triton {triton}"
    )
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build(rk):
    t0 = time.perf_counter()
    rk.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({rk.library_path().name})")
    for line in rk.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def tie_mask(torch, rs, maps, fields, out_shape):
    """True where no plain-version coordinate lies within TIE_BAND of a
    .5 tie (where rounding may legitimately go either way)."""
    masks = []
    for b in range(maps.shape[0]):
        coords = rs.build_coords(maps[b], out_shape)
        if fields is not None:
            disp = rs.upsample_field(fields[b], out_shape)
            coords = [coords[a] + disp[..., a] for a in range(3)]
        ok = torch.ones(out_shape, dtype=torch.bool, device=maps.device)
        for c in coords:
            ok &= (torch.abs(c - torch.floor(c) - 0.5) > TIE_BAND)
        masks.append(ok)
    return torch.stack(masks)[:, None]


#: (input spatial shape, output spatial shapes): non-aligned extents and
#: an output grid unlike the input; a size-1 axis; k past 128 (two of the
#: TPU kernel's 128-lane chunks)
KERNEL_SHAPES = (
    ((37, 45, 51), ((37, 45, 51), (41, 39, 47))),
    ((23, 19, 1), ((23, 19, 1),)),
    ((12, 14, 150), ((12, 14, 150),)),
)


def phase_kernel(torch, np, rs, rk):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    b, c = 2, 2
    field = rng.uniform(-3.0, 3.0, (7, 7, 7, 3))
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = rk.LAUNCHES
    worst = {"linear": 0.0, "nearest": 0}
    cases = 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        center = [(s - 1) / 2 for s in in_shape]
        matrices = [
            rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
            rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
        ]
        for out_shape in out_shapes:
            for cps in ([field, None], [None, None]):
                maps, fields = rs._marshal_maps(matrices, cps, dev)
                ties = tie_mask(torch, rs, maps, fields, out_shape)
                for mode in ("linear", "nearest"):
                    for fname, fill in fills.items():
                        fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                        args = (vol, maps, fields, fill_bc, out_shape, mode, apply_fill)
                        got = rk.resample_cuda(*args)
                        want = rs.resample_plain(*args)
                        torch.cuda.synchronize()
                        where = f"{mode} {in_shape}->{out_shape} fill {fname}"
                        if got.shape != (b, c, *out_shape):
                            fail(f"{where}: output shape {tuple(got.shape)}")
                        if mode == "linear":
                            err = float((got - want).abs().max())
                            worst["linear"] = max(worst["linear"], err)
                            if not err <= KERNEL_ATOL:
                                fail(f"{where}: max abs {err}")
                        else:
                            diff = int(((got != want) & ties.expand_as(got)).sum())
                            worst["nearest"] = max(worst["nearest"], diff)
                            if diff:
                                fail(f"{where}: {diff} voxels differ")
                        cases += 1
    if rk.LAUNCHES - before != cases:
        fail(f"{cases} kernel calls but LAUNCHES grew by {rk.LAUNCHES - before}")
    print(
        f"kernel vs plain: {cases} cases; linear max abs {worst['linear']:.3g}"
        f" (limit {KERNEL_ATOL}); nearest voxels differing off ties"
        f" {worst['nearest']}"
    )
    return worst["linear"]


def phase_small_slice(torch, tio, tio_random):
    """The headline on a small batch: card against the CPU path, with the
    device normals drawn on the CPU for both."""
    default = tio_random.device_normal

    def cpu_normal(seed, shape, device, index):
        return default(seed, shape, "cpu", index).to(device)

    tio_random.device_normal = cpu_normal
    try:
        outs = []
        for device in ("cpu", DEVICE):
            batch = make_batch(tio, torch, 2, (40, 44, 48), "cpu", 3).to(device)
            tio.seed(11)
            outs.append(headline(tio)(batch))
    finally:
        tio_random.device_normal = default
    cpu, gpu = outs
    if [h.params for h in cpu.applied_transforms] != [
        h.params for h in gpu.applied_transforms
    ]:
        fail("small slice: history params differ between cpu and cuda")
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    print(f"small slice (2 x 40x44x48) cuda vs cpu: max abs {err:.3g} (limit {SLICE_ATOL})")
    if not err <= SLICE_ATOL:
        fail(f"small slice differs from the CPU path by {err}")


def phase_slice(torch, tio, rk, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 0)
    pipeline = headline(tio)
    tio.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk.LAUNCHES = 0
    times, launches = [], []
    out = None
    for call in range(WARMUP + TIMED):
        before = rk.LAUNCHES
        t0 = time.perf_counter()
        out = pipeline(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(rk.LAUNCHES - before)
    total_launches = rk.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if any(n < 1 for n in launches):
        fail(f"a slice call did not launch the kernel: {launches}")
    data = out.t1.data
    if tuple(data.shape) != (B, C, S, S, S) or data.device.type != DEVICE:
        fail(f"slice output {tuple(data.shape)} on {data.device}")
    if not bool(torch.isfinite(data).all()):
        fail("slice output has non-finite values")
    names = [h.name for h in out.applied_transforms]
    if names != ["Spatial", "BiasField", "Noise"]:
        fail(f"history is {names}")
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"slice: {vps:.2f} volumes/s over {TIMED} timed calls of B={B} x {S}^3"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first);"
        f" launches per call {launches}; peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(2):
                pipeline(batch)
            torch.cuda.synchronize()
        table = p.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        path = Path(profile)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(table)
        print(f"profile: {path}")
    return total_launches, vps


def phase_kernel_timing(torch, tio, rs, rk):
    """Kernel against the plain resample at the slice's shape, on the
    grid specs of one headline Spatial draw."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 1)
    spatial = headline(tio).transforms[0]
    tio.seed(5)
    params = spatial.make_params(batch)
    affine = batch.t1.affines[0]
    grids = [
        _build_grid(
            input_affine=affine, output_shape=(S, S, S), output_affine=affine,
            affine_matrix=params["affine_matrix"][i],
            control_points=params["control_points"][i],
            max_displacement=params["max_displacement"][i], affine_first=True,
        )
        for i in range(B)
    ]
    vol = batch.t1.data.contiguous()
    maps, fields = rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], dev)
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, C, dev)
    args = (vol, maps, fields, fill, (S, S, S), "linear", apply_fill)
    err = float((rk.resample_cuda(*args) - rs.resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"kernel vs plain at {S}^3: max abs {err}")
    ms = cuda_time_ms(torch, lambda: rk.resample_cuda(*args), 20)
    plain_ms = cuda_time_ms(torch, lambda: rs.resample_plain(*args), 3)
    ms2 = cuda_time_ms(torch, lambda: rk.resample_cuda(*args), 20)
    plain_ms2 = cuda_time_ms(torch, lambda: rs.resample_plain(*args), 3)
    voxels = B * C * S**3
    print(
        f"resample B={B} x {S}^3 linear + elastic: kernel {ms:.3f} / {ms2:.3f} ms,"
        f" plain {plain_ms:.3f} / {plain_ms2:.3f} ms (kernel, plain, kernel, plain"
        f" order: k {ms:.3f}, p {plain_ms:.3f}, k {ms2:.3f}, p {plain_ms2:.3f});"
        f" kernel writes {voxels * 4 / ms2 / 1e6:.1f} GB/s of output;"
        f" max abs {err:.3g}"
    )
    return err, min(ms, ms2), min(plain_ms, plain_ms2)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="PATH", help="write a torch.profiler table to PATH"
    )
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")

    import numpy as np

    import torchio_tpu_torch as tio
    from torchio_tpu_torch import config
    from torchio_tpu_torch import random as tio_random
    from torchio_tpu_torch.ops import resample as rs
    from torchio_tpu_torch.ops import resample_kernel as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(torch, config)
    phase_build(rk)
    phase_kernel(torch, np, rs, rk)
    phase_small_slice(torch, tio, tio_random)
    launches, _ = phase_slice(torch, tio, rk, args.profile)
    err, ms, plain_ms = phase_kernel_timing(torch, tio, rs, rk)
    kernels = [
        {
            "name": "resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": [
                "torchio_tpu/ops/shear_resample.py:81",
                "torchio_tpu/ops/window_resample.py:335",
            ],
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        }
    ]
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
