#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``torchio_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: requires CUDA; prints the card's name and power limit, and
   the torch, CUDA, nvcc and Triton versions;
2. build: compiles every kernel library from ``torchio_tpu_torch/csrc``,
   one ``nvcc`` per source, all at once;
3. kernels against their plain PyTorch versions on the card:
   - resample: linear within 1e-5 max abs on inputs in [0, 1); nearest
     equal away from .5 ties;
   - label vote: equal off near ties, on int32 labels (also above 2^24)
     and float32 labels;
   - prefilter: within 1e-5 of the plain coefficients' largest magnitude,
     orders 2-7;
   - spline: within 1e-5 max abs for orders 2-7 on inputs in [0, 1);
   - dense-coordinate resample: equal, linear and nearest, shared and
     per-element grids, every fill form, points outside the volume and
     a size-1 axis;
   - dense-coordinate spline: within 1e-5 max abs for orders 2-7;
4. small batches on the card against the CPU path: the headline (1e-4),
   the labelled BraTS-style pipeline (images 1e-4, labels equal off
   near ties) and the k-space pair (1e-4, labels untouched);
5. headline: ``Compose([Spatial, BiasField, Noise], fuse=True)`` on
   B=4 x 1 x 256^3 float32 through ``Compose.__call__``, 2 warm-up and 5
   timed calls, with the launch counts read around the run;
6. brats-label-bspline: ``Compose([Spatial(image_interpolation="bspline",
   label_interpolation="label"), BiasField, Noise], fuse=True)`` on B=4
   subjects of a 4-channel 240x240x155 float32 ``mri`` and a 1-channel
   int32 ``seg`` (labels {0, 1, 2, 4}), the same way;
7. kspace-motion-ghosting: ``Compose([Motion(degrees=5, translation=3,
   num_transforms=1, p=0.5), Ghosting(intensity=(0.3, 0.7), p=0.5)])``
   on B=4 subjects of a 256^3 float32 ``t1`` and an int32 ``seg``, the
   same way; the dense resample kernel must launch in exactly the calls
   whose history keeps Motion;
8. each kernel against its plain version at its path's shape, timed
   kernel, plain, kernel, plain with CUDA events; the dense entry points
   ``ops.resample`` (B=4 x 256^3, per-element Motion grids) and
   ``ops.bspline.bspline_resample`` (cubic, B=1 of it) are called as a
   user calls them, with the launch counts zeroed around the calls.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--profile PATH`` also writes a
``torch.profiler`` table of two calls of each pipeline to PATH.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import json
import statistics
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

B, C, S = 4, 1, 256
BRATS_B, BRATS_C, BRATS_SHAPE = 4, 4, (240, 240, 155)
DEVICE = "cuda"
WARMUP, TIMED = 2, 5
KERNEL_ATOL = 1e-5
PREFILTER_RTOL = 1e-5
SLICE_ATOL = 1e-4
TIE_BAND = 1e-4
ORDERS = range(2, 8)
KERNELS = (
    "resample", "label_vote", "bspline_prefilter", "bspline_resample",
    "resample_coords", "bspline_coords",
)


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


def brats_pipeline(tio):
    return tio.Compose(
        [
            tio.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
                image_interpolation="bspline",
                label_interpolation="label",
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


def brats_labels(torch, shape, device):
    """(1, *shape) int32 block-structured labels in {0, 1, 2, 4}."""
    i, j, k = (torch.arange(n, device=device) // 24 for n in shape)
    labels = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % 4
    labels[labels == 3] = 4
    return labels.to(torch.int32)[None]


def make_brats_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    mri = torch.rand((b, BRATS_C, *shape), generator=gen, device=device)
    seg = brats_labels(torch, shape, device)
    subjects = [
        tio.Subject(mri=tio.ScalarImage(mri[i]), seg=tio.LabelMap(seg.clone()))
        for i in range(b)
    ]
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


def phase_build(kl):
    t0 = time.perf_counter()
    libraries = kl.build_all()
    print(
        f"build: {time.perf_counter() - t0:.2f} s, {len(libraries)} libraries in"
        f" parallel ({', '.join(lib.path().name for lib in libraries)})"
    )
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {lib.source.name}: {line.strip()}")


def coord_tie_mask(torch, rs, maps, fields, out_shape):
    """True where no plain-version coordinate lies within TIE_BAND of a
    .5 tie (where rounding may legitimately go either way)."""
    masks = []
    for b in range(maps.shape[0]):
        ok = torch.ones(out_shape, dtype=torch.bool, device=maps.device)
        for c in rs._element_coords(maps, fields, b, out_shape):
            ok &= (torch.abs(c - torch.floor(c) - 0.5) > TIE_BAND)
        masks.append(ok)
    return torch.stack(masks)[:, None]


def vote_ties(torch, rs, labels, maps, fields, out_shape):
    """(B, 1, *out) True where the label vote is a near tie: the top two
    label scores, or the in-bounds weight against 0.5, within TIE_BAND
    (float64 from the plain version's coordinates)."""
    ties = []
    for b in range(labels.shape[0]):
        vol = labels[b, 0]
        floors, weights = [], []
        for c, size in zip(rs._element_coords(maps, fields, b, out_shape), vol.shape):
            c = torch.zeros_like(c) if size == 1 else c.double()
            f = torch.floor(c)
            frac = c - f
            floors.append(f.long())
            weights.append(
                ((1 - frac) * ((f >= 0) & (f < size)), frac * ((f + 1 >= 0) & (f + 1 < size)))
            )
        w, labs = [], []
        for d in itertools.product((0, 1), repeat=3):
            w.append(weights[0][d[0]] * weights[1][d[1]] * weights[2][d[2]])
            ii, jj, kk = (
                torch.clamp(f + o, 0, s - 1) for f, o, s in zip(floors, d, vol.shape)
            )
            labs.append(vol[ii, jj, kk])
        w, labs = torch.stack(w, -1), torch.stack(labs, -1)
        scores = (w[..., None, :] * (labs[..., :, None] == labs[..., None, :])).sum(-1)
        top, arg = scores.max(-1)
        winner = torch.gather(labs, -1, arg[..., None])
        second = torch.where(labs != winner, scores, -1.0).max(-1).values
        wsum = w.sum(-1)
        ties.append(
            ((top - second < TIE_BAND) & (wsum > 0.5 - TIE_BAND))
            | ((wsum - 0.5).abs() < TIE_BAND)
        )
    return torch.stack(ties)[:, None]


#: (input spatial shape, output spatial shapes): non-aligned extents and
#: an output grid unlike the input; a size-1 axis; k past 128 (two of the
#: TPU kernel's 128-lane chunks)
KERNEL_SHAPES = (
    ((37, 45, 51), ((37, 45, 51), (41, 39, 47))),
    ((23, 19, 1), ((23, 19, 1),)),
    ((12, 14, 150), ((12, 14, 150),)),
)


def kernel_grids(np, rs, dev, in_shape):
    """The kernel phases' two grid specs: with and without an elastic
    field, rotated, scaled and shifted about the volume's center."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, (7, 7, 7, 3))
    center = [(s - 1) / 2 for s in in_shape]
    matrices = [
        rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
        rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
    ]
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field, None], [None, None])]


def check_launches(kl, kernel, before, calls, per_call=1):
    grown = kl.LAUNCHES[kernel] - before
    if grown != calls * per_call:
        fail(f"{calls} {kernel} calls but its launch count grew by {grown}")


def phase_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    b, c = 2, 2
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["resample"]
    worst = {"linear": 0.0, "nearest": 0}
    cases = 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            for maps, fields in kernel_grids(np, rs, dev, in_shape):
                ties = coord_tie_mask(torch, rs, maps, fields, out_shape)
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
    check_launches(kl, "resample", before, cases)
    print(
        f"resample kernel vs plain: {cases} cases; linear max abs {worst['linear']:.3g}"
        f" (limit {KERNEL_ATOL}); nearest voxels differing off ties"
        f" {worst['nearest']}"
    )
    return worst["linear"]


def label_volumes(torch, np, rng, b, in_shape, dev):
    """int32 block labels {0, 1, 2, 4}, int32 labels above 2^24 (2^24 +
    {1, 2, 3, 4}: neighbours a float32 round trip would merge) and float
    labels."""
    coarse = rng.integers(0, 4, (b, 1, *[-(-s // 3) for s in in_shape]))
    blocks = coarse.repeat(3, 2).repeat(3, 3).repeat(3, 4)
    blocks = blocks[:, :, : in_shape[0], : in_shape[1], : in_shape[2]].astype(np.int32)
    blocks[blocks == 3] = 4
    ints = torch.as_tensor(blocks, device=dev)
    return {
        "int32": ints,
        "int32>2^24": ints + (2**24 + 1),
        "float32": ints.to(torch.float32) * 0.5,
    }


def phase_label_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(2)
    before = kl.LAUNCHES["label_vote"]
    cases = differ = ties_total = voxels = 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        for kind, labels in label_volumes(torch, np, rng, 2, in_shape, dev).items():
            for out_shape in out_shapes:
                for maps, fields in kernel_grids(np, rs, dev, in_shape):
                    ties = vote_ties(torch, rs, labels, maps, fields, out_shape)
                    for pad in (0.0, 7.0):
                        got = rk.resample_label_cuda(labels, maps, fields, out_shape, pad)
                        want = rs.resample_label_plain(labels, maps, fields, out_shape, pad)
                        torch.cuda.synchronize()
                        where = f"label {kind} {in_shape}->{out_shape} pad {pad}"
                        if got.shape != want.shape or got.dtype != labels.dtype:
                            fail(f"{where}: output {tuple(got.shape)} {got.dtype}")
                        diff = got != want
                        differ += int(diff.sum())
                        off = int((diff & ~ties).sum())
                        if off:
                            fail(f"{where}: {off} voxels differ off near ties")
                        ties_total += int(ties.sum())
                        voxels += got.numel()
                        cases += 1
    check_launches(kl, "label_vote", before, cases)
    print(
        f"label vote kernel vs plain: {cases} cases (int32, int32 above 2^24,"
        f" float32); {differ} of {voxels} voxels differ, all at near ties"
        f" ({ties_total} near-tie voxels)"
    )
    return differ


#: prefilter volumes: non-aligned, short axes (periodic start), a size-1 axis
PREFILTER_SHAPES = ((2, 2, 37, 45, 51), (1, 1, 3, 5, 40), (2, 1, 23, 19, 1))


def phase_prefilter_kernel(torch, np, bs, bk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    before = kl.LAUNCHES["bspline_prefilter"]
    worst, cases = 0.0, 0
    for shape in PREFILTER_SHAPES:
        vol = torch.as_tensor(rng.random(shape, np.float32), device=dev)
        for order in ORDERS:
            got = bk.prefilter_cuda(vol, order)
            want = bs.prefilter_plain(vol, order)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
            if not err <= PREFILTER_RTOL:
                fail(f"prefilter order {order} {shape}: relative error {err}")
            cases += 1
    check_launches(kl, "bspline_prefilter", before, cases, per_call=3)
    print(
        f"prefilter kernel vs plain: {cases} cases, orders 2-7; max abs error over"
        f" the largest coefficient {worst:.3g} (limit {PREFILTER_RTOL})"
    )
    return worst


def phase_spline_kernel(torch, np, rs, bs, bk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(4)
    b, c = 2, 2
    fills = {
        "scalar": 0.0,
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["bspline_resample"]
    worst, cases = 0.0, 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for order in ORDERS:
            coeffs = bs.prefilter_plain(vol, order)
            for out_shape in out_shapes:
                for maps, fields in kernel_grids(np, rs, dev, in_shape):
                    for fname, fill in fills.items():
                        fill_bc, _ = rs._fill_bc(fill, b, c, dev)
                        args = (coeffs, maps, fields, fill_bc, out_shape, order)
                        got = bk.bspline_resample_cuda(*args)
                        want = bs.bspline_resample_plain(*args)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        worst = max(worst, err)
                        if got.shape != (b, c, *out_shape) or not err <= KERNEL_ATOL:
                            fail(
                                f"spline order {order} {in_shape}->{out_shape} fill"
                                f" {fname}: shape {tuple(got.shape)}, max abs {err}"
                            )
                        cases += 1
    check_launches(kl, "bspline_resample", before, cases)
    print(
        f"spline kernel vs plain: {cases} cases, orders 2-7; max abs {worst:.3g}"
        f" (limit {KERNEL_ATOL})"
    )
    return worst


def cpu_normals(tio_random):
    """Device normals drawn on the CPU and moved, so the card and CPU
    paths add the same noise."""
    default = tio_random.device_normal

    def cpu_normal(seed, shape, device, index):
        return default(seed, shape, "cpu", index).to(device)

    return default, cpu_normal


def run_on_both(tio, tio_random, make, pipeline, seed):
    import torch

    # the first multithreaded torch.exp of a process has returned results
    # off by up to 2e-4 on PyTorch's CPU build (2.13.0+cpu); warm the
    # CPU thread pool before the CPU path is the reference
    torch.exp(torch.zeros(1 << 20))
    default, cpu_normal = cpu_normals(tio_random)
    tio_random.device_normal = cpu_normal
    try:
        outs = []
        for device in ("cpu", DEVICE):
            batch = make().to(device)
            tio.seed(seed)
            outs.append(pipeline(tio)(batch))
    finally:
        tio_random.device_normal = default
    cpu, gpu = outs
    if [h.params for h in cpu.applied_transforms] != [
        h.params for h in gpu.applied_transforms
    ]:
        fail("history params differ between cpu and cuda")
    return cpu, gpu


def phase_small_slice(torch, tio, tio_random):
    """The headline on a small batch: card against the CPU path."""
    cpu, gpu = run_on_both(
        tio, tio_random, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 3),
        headline, 11,
    )
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    print(f"small slice (2 x 40x44x48) cuda vs cpu: max abs {err:.3g} (limit {SLICE_ATOL})")
    if not err <= SLICE_ATOL:
        fail(f"small slice differs from the CPU path by {err}")


def slice_grids(np, rs, params, affine, shape, device):
    """The (maps, fields) of a recorded per-element Spatial draw."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    grids = [
        _build_grid(
            input_affine=affine, output_shape=shape, output_affine=affine,
            affine_matrix=params["affine_matrix"][i],
            control_points=params["control_points"][i],
            max_displacement=params["max_displacement"][i], affine_first=True,
        )
        for i in range(len(params["affine_matrix"]))
    ]
    return rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], device)


def phase_small_labelled(torch, np, tio, tio_random, rs):
    """brats-label-bspline on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    cpu, gpu = run_on_both(
        tio, tio_random,
        lambda: make_brats_batch(tio, torch, 2, shape, "cpu", 5),
        brats_pipeline, 13,
    )
    err = float((gpu.mri.data.cpu() - cpu.mri.data).abs().max())
    seg_in = brats_labels(torch, shape, "cpu").expand(2, 1, *shape)
    maps, fields = slice_grids(
        np, rs, cpu.applied_transforms[0].params, cpu.seg.affines[0], shape, "cpu"
    )
    ties = vote_ties(torch, rs, seg_in, maps, fields, shape)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"labelled slice: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small labelled slice (2 x (4 + 1) x 40x44x48) cuda vs cpu: mri max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); seg voxels differing {int((got != want).sum())},"
        f" off near ties {off}"
    )
    if not err <= SLICE_ATOL or off:
        fail("the small labelled slice differs from the CPU path")


def drive(torch, kl, pipeline, batch, kernels):
    """WARMUP + TIMED calls with every launch count zeroed just before
    and read just after; returns (output, call seconds, launches per
    call per kernel, total launches per kernel, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.reset_launches()
    times, per_call, histories, out = [], [], [], None
    for _ in range(WARMUP + TIMED):
        before = dict(kl.LAUNCHES)
        t0 = time.perf_counter()
        out = pipeline(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_call.append({k: kl.LAUNCHES[k] - before[k] for k in KERNELS})
        histories.append([h.name for h in out.applied_transforms])
    totals = {k: kl.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        if any(call[k] < 1 for call in per_call):
            fail(f"a call did not launch the {k} kernel: {[c[k] for c in per_call]}")
    return out, times, per_call, totals, peak, histories


def profile_calls(torch, pipeline, batch, path, title):
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            pipeline(batch)
        torch.cuda.synchronize()
    table = p.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(f"== {title}: two calls ==\n{table}\n")
    print(f"profile ({title}): {path}")


def phase_slice(torch, tio, kl, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 0)
    pipeline = headline(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, _ = drive(torch, kl, pipeline, batch, ("resample",))
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
        f"headline slice: {vps:.2f} volumes/s over {TIMED} timed calls of B={B} x {S}^3"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first);"
        f" resample launches per call {[c['resample'] for c in per_call]};"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "headline")
    return totals


def phase_brats(torch, tio, kl, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0)
    pipeline = brats_pipeline(tio)
    tio.seed(0)
    new = ("label_vote", "bspline_prefilter", "bspline_resample")
    out, times, per_call, totals, peak, _ = drive(torch, kl, pipeline, batch, new)
    mri, seg = out.mri.data, out.seg.data
    if tuple(mri.shape) != (BRATS_B, BRATS_C, *BRATS_SHAPE) or mri.device.type != DEVICE:
        fail(f"brats mri output {tuple(mri.shape)} on {mri.device}")
    if tuple(seg.shape) != (BRATS_B, 1, *BRATS_SHAPE) or seg.dtype != torch.int32:
        fail(f"brats seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(mri).all()):
        fail("brats mri output has non-finite values")
    values = set(torch.unique(seg).tolist())
    if not values <= {0, 1, 2, 4} or len(values) < 4:
        fail(f"brats seg labels {sorted(values)}, expected {{0, 1, 2, 4}}")
    names = [h.name for h in out.applied_transforms]
    if names != ["Spatial", "BiasField", "Noise"]:
        fail(f"brats history is {names}")
    timed = times[WARMUP:]
    sps = BRATS_B * TIMED / sum(timed)
    print(
        f"brats-label-bspline: {sps:.2f} subjects/s over {TIMED} timed calls of"
        f" B={BRATS_B} x ({BRATS_C} + 1) x {'x'.join(map(str, BRATS_SHAPE))}"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first);"
        f" launches per call {dict((k, per_call[-1][k]) for k in new)};"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "brats-label-bspline")
    return totals, batch


def time_pair(torch, kernel, plain, kernel_reps=20, plain_reps=3):
    """Kernel, plain, kernel, plain; returns the better of each pair."""
    ms = cuda_time_ms(torch, kernel, kernel_reps)
    plain_ms = cuda_time_ms(torch, plain, plain_reps)
    ms2 = cuda_time_ms(torch, kernel, kernel_reps)
    plain_ms2 = cuda_time_ms(torch, plain, plain_reps)
    return (ms, plain_ms, ms2, plain_ms2), min(ms, ms2), min(plain_ms, plain_ms2)


def phase_kernel_timing(torch, np, tio, rs, rk):
    """The resample kernel against the plain resample at the headline's
    shape, on the grid specs of one headline Spatial draw."""
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 1)
    tio.seed(5)
    params = headline(tio).transforms[0].make_params(batch)
    maps, fields = slice_grids(np, rs, params, batch.t1.affines[0], (S, S, S), dev)
    vol = batch.t1.data.contiguous()
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, C, dev)
    args = (vol, maps, fields, fill, (S, S, S), "linear", apply_fill)
    err = float((rk.resample_cuda(*args) - rs.resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"resample kernel vs plain at {S}^3: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), lambda: rs.resample_plain(*args)
    )
    print(
        f"resample B={B} x {S}^3 linear + elastic: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (kernel, plain, kernel, plain:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}"
    )
    return err, ms, plain_ms


def phase_brats_timing(torch, np, tio, rs, rk, bs, bk, batch):
    """The three new kernels against their plain versions at the shapes
    brats-label-bspline gives them, on the grid specs of one draw."""
    dev = torch.device(DEVICE)
    tio.seed(6)
    params = brats_pipeline(tio).transforms[0].make_params(batch)
    maps, fields = slice_grids(np, rs, params, batch.mri.affines[0], BRATS_SHAPE, dev)
    mri, seg = batch.mri.data.contiguous(), batch.seg.data.contiguous()
    results = {}

    got = rk.resample_label_cuda(seg, maps, fields, BRATS_SHAPE, 0.0)
    want = rs.resample_label_plain(seg, maps, fields, BRATS_SHAPE, 0.0)
    diff = got != want
    differ = int(diff.sum())
    label_err = float((got - want).abs().max())
    if differ:
        ties = vote_ties(torch, rs, seg, maps, fields, BRATS_SHAPE)
        if int((diff & ~ties).sum()):
            fail(f"label vote at the slice's shape: {differ} voxels differ, some off ties")
    del got, want, diff
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_label_cuda(seg, maps, fields, BRATS_SHAPE, 0.0),
        lambda: rs.resample_label_plain(seg, maps, fields, BRATS_SHAPE, 0.0),
    )
    results["label_vote"] = (label_err, ms, plain_ms)
    print(
        f"label vote B={BRATS_B} x 1 x {'x'.join(map(str, BRATS_SHAPE))} int32: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); voxels differing {differ}"
    )

    coeffs = bk.prefilter_cuda(mri, 3)
    want = bs.prefilter_plain(mri, 3)
    abs_err = float((coeffs - want).abs().max())
    err = abs_err / float(want.abs().max())
    del want
    if not err <= PREFILTER_RTOL:
        fail(f"prefilter at the slice's shape: relative error {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.prefilter_cuda(mri, 3), lambda: bs.prefilter_plain(mri, 3)
    )
    results["bspline_prefilter"] = (abs_err, ms, plain_ms)
    print(
        f"prefilter order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {abs_err:.3g}, over the"
        f" largest coefficient {err:.3g}"
    )

    fill, _ = rs._fill_bc(torch.amin(mri, dim=(-3, -2, -1)), BRATS_B, BRATS_C, dev)
    args = (coeffs, maps, fields, fill, BRATS_SHAPE, 3)
    err = float((bk.bspline_resample_cuda(*args) - bs.bspline_resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"spline at the slice's shape: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_resample_cuda(*args),
        lambda: bs.bspline_resample_plain(*args), plain_reps=2,
    )
    results["bspline_resample"] = (err, ms, plain_ms)
    print(
        f"spline order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}"
    )
    return results


KSPACE_SEED = 0


def kspace_pipeline(tio):
    """BASELINE.json config 5's artifact pair (benchmarks/patches_bench.py:44-49)."""
    return tio.Compose(
        [
            tio.Motion(degrees=5, translation=3, num_transforms=1, p=0.5),
            tio.Ghosting(intensity=(0.3, 0.7), p=0.5),
        ]
    )


def block_seg(torch, shape, device):
    """(1, *shape) int32: label 1 on the central half of every axis, 0
    elsewhere, as benchmarks/patches_bench.py builds its label maps."""
    seg = torch.zeros((1, *shape), dtype=torch.int32, device=device)
    i, j, k = (n // 4 for n in shape)
    seg[0, i : shape[0] - i, j : shape[1] - j, k : shape[2] - k] = 1
    return seg


def make_kspace_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = torch.rand((b, 1, *shape), generator=gen, device=device)
    seg = block_seg(torch, shape, device)
    subjects = [
        tio.Subject(t1=tio.ScalarImage(t1[i]), seg=tio.LabelMap(seg.clone()))
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def dense_grids(torch, rs, dev, in_shape, out_shape, b):
    """Per-element (b, *out_shape, 3) coordinates: the kernel phases'
    rotated, scaled and shifted maps (their borders leave the volume),
    each coordinate jittered by up to one voxel."""
    center = [(s - 1) / 2 for s in in_shape]
    matrices = [
        rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
        rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
    ][:b]
    grids = torch.stack([rs.build_coords(out_shape, m, device=dev) for m in matrices])
    gen = torch.Generator(device=dev).manual_seed(7)
    return grids + (torch.rand(grids.shape, generator=gen, device=dev) * 2.0 - 1.0)


def phase_coords_kernel(torch, np, rs, rk, kl):
    """The dense-coordinate resample kernel against its plain version:
    linear and nearest, per-element and shared grids, every fill form,
    out-of-bounds points, a size-1 axis; equal voxel for voxel."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    b, c = 2, 2
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(C,)": [0.5, -1.0],
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["resample_coords"]
    cases = 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            grids = dense_grids(torch, rs, dev, in_shape, out_shape, b)
            for kind, coords in (("per-element", grids), ("shared", grids[:1].contiguous())):
                for mode in ("linear", "nearest"):
                    for fname, fill in fills.items():
                        fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                        args = (vol, coords, fill_bc, mode, apply_fill)
                        got = rk.resample_coords_cuda(*args)
                        want = rs.resample_coords_plain(*args)
                        torch.cuda.synchronize()
                        where = f"dense {mode} {kind} {in_shape}->{out_shape} fill {fname}"
                        if got.shape != (b, c, *out_shape):
                            fail(f"{where}: output shape {tuple(got.shape)}")
                        differ = int((got != want).sum())
                        if differ:
                            err = float((got - want).abs().max())
                            fail(f"{where}: {differ} voxels differ, max abs {err}")
                        cases += 1
    check_launches(kl, "resample_coords", before, cases)
    print(
        f"dense resample kernel vs plain: {cases} cases (linear and nearest,"
        f" per-element and shared grids, 4 fill forms); max abs 0"
    )


def phase_coords_spline_kernel(torch, np, rs, bs, bk, kl):
    """The dense-coordinate spline kernel against its plain version,
    orders 2-7, within KERNEL_ATOL."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    b, c = 2, 2
    fill_bc = torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev)
    before = kl.LAUNCHES["bspline_coords"]
    worst, cases = 0.0, 0
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for order in ORDERS:
            coeffs = bs.prefilter_plain(vol, order)
            for out_shape in out_shapes:
                grids = dense_grids(torch, rs, dev, in_shape, out_shape, b)
                for kind, coords in (("per-element", grids), ("shared", grids[:1].contiguous())):
                    got = bk.bspline_coords_cuda(coeffs, coords, fill_bc, order)
                    want = bs.bspline_coords_plain(coeffs, coords, fill_bc, order)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    if got.shape != (b, c, *out_shape) or not err <= KERNEL_ATOL:
                        fail(
                            f"dense spline order {order} {kind} {in_shape}->{out_shape}:"
                            f" shape {tuple(got.shape)}, max abs {err}"
                        )
                    cases += 1
    check_launches(kl, "bspline_coords", before, cases)
    print(
        f"dense spline kernel vs plain: {cases} cases, orders 2-7, per-element and"
        f" shared grids; max abs {worst:.3g} (limit {KERNEL_ATOL})"
    )
    return worst


def phase_small_kspace(torch, tio, tio_random, kl):
    """kspace-motion-ghosting on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    before = kl.LAUNCHES["resample_coords"]
    cpu, gpu = run_on_both(
        tio, tio_random, lambda: make_kspace_batch(tio, torch, B, shape, "cpu", 7),
        kspace_pipeline, 10,
    )
    launched = kl.LAUNCHES["resample_coords"] - before
    names = [h.name for h in gpu.applied_transforms]
    if "Motion" not in names or launched != 1:
        fail(f"small k-space batch: history {names}, {launched} dense resample launches")
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    seg_in = block_seg(torch, shape, "cpu").expand(B, 1, *shape)
    seg_ok = torch.equal(gpu.seg.data.cpu(), seg_in) and torch.equal(cpu.seg.data, seg_in)
    print(
        f"small k-space batch ({B} x 40x44x48, history {names}) cuda vs cpu: t1 max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); seg untouched {seg_ok}"
    )
    if not err <= SLICE_ATOL or not seg_ok:
        fail("the small k-space batch differs from the CPU path")


def phase_kspace(torch, tio, kl, profile: str | None):
    """kspace-motion-ghosting: config 5's Compose on B=4 x 256^3 t1 + seg."""
    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_kspace_batch(tio, torch, B, shape, dev, 0)
    seg_in = batch.seg.data.clone()
    pipeline = kspace_pipeline(tio)
    tio.seed(KSPACE_SEED)
    out, times, per_call, totals, peak, histories = drive(torch, kl, pipeline, batch, ())
    for names, call in zip(histories, per_call):
        if call["resample_coords"] != int("Motion" in names):
            fail(
                f"k-space calls: histories {histories}, dense resample launches"
                f" {[c['resample_coords'] for c in per_call]}"
            )
    kept = sum("Motion" in names for names in histories[WARMUP:])
    if 2 * kept <= TIMED:
        fail(f"only {kept} of {TIMED} timed calls kept Motion: {histories}")
    t1, seg = out.t1.data, out.seg.data
    if tuple(t1.shape) != (B, C, *shape) or t1.device.type != DEVICE or t1.dtype != torch.float32:
        fail(f"k-space t1 output {tuple(t1.shape)} {t1.dtype} on {t1.device}")
    if not bool(torch.isfinite(t1).all()):
        fail("k-space t1 output has non-finite values")
    if not torch.equal(seg, seg_in) or not torch.equal(batch.seg.data, seg_in):
        fail("k-space seg output is not the input label map")
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"kspace-motion-ghosting: {vps:.2f} volumes/s over {TIMED} timed calls of"
        f" B={B} x {S}^3 t1 (+ int32 seg)"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first); histories"
        f" {histories}; dense resample launches per call"
        f" {[c['resample_coords'] for c in per_call]}; peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "kspace-motion-ghosting")
    return totals


def phase_dense_entry(torch, np, tio, rs, rk, bs, bk, kl):
    """The public dense-coordinate entry points at the slice's shape, as a
    user calls them, with every launch count zeroed just before and read
    just after: ``ops.resample`` on B=4 x 256^3 at the per-element grids
    of one Motion draw, and ``ops.bspline.bspline_resample`` (cubic,
    "minimum" fill) on B=1 of it. Then each kernel against its plain
    version on the same inputs, and timed."""
    from torchio_tpu_torch.transforms.intensity.motion import _rigid_voxel_matrix

    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_kspace_batch(tio, torch, B, shape, dev, 1)
    tio.seed(5)
    params = tio.Motion(degrees=5, translation=3, num_transforms=1).make_params(batch)
    coords = torch.stack(
        [
            tio.ops.build_coords(
                shape, _rigid_voxel_matrix(t[0]["degrees"], t[0]["translation"], shape),
                device=dev,
            )
            for t in params["transforms"]
        ]
    )
    vol = batch.t1.data.contiguous()
    vol1, coords1 = vol[:1], coords[:1]
    fill1 = torch.amin(vol1, dim=(-3, -2, -1))
    torch.cuda.synchronize()
    kl.reset_launches()
    got_a = tio.ops.resample(vol, coords, mode="linear", fill=0.0)
    got_b = bs.bspline_resample(vol1, coords1, order=3, fill=fill1)
    torch.cuda.synchronize()
    launches = {k: kl.LAUNCHES[k] for k in KERNELS}
    want = {"resample_coords": 1, "bspline_coords": 1, "bspline_prefilter": 3}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"dense entry points: launches {launches}, expected {want}")

    fill_a, apply_a = rs._fill_bc(0.0, B, C, dev)
    args_a = (vol, coords, fill_a, "linear", apply_a)
    err_a = float((got_a - rs.resample_coords_plain(*args_a)).abs().max())
    coeffs = bk.prefilter_cuda(vol1, 3)
    fill_b, _ = rs._fill_bc(fill1, 1, C, dev)
    args_b = (coeffs, coords1, fill_b, 3)
    err_b = float((got_b - bs.bspline_coords_plain(*args_b)).abs().max())
    del got_a, got_b
    if not err_a <= KERNEL_ATOL or not err_b <= KERNEL_ATOL:
        fail(f"dense entry points vs plain: max abs {err_a} (resample), {err_b} (spline)")
    results = {}
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_coords_cuda(*args_a),
        lambda: rs.resample_coords_plain(*args_a),
    )
    results["resample_coords"] = (err_a, ms, plain_ms)
    print(
        f"dense resample B={B} x {S}^3 linear, per-element Motion grids: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err_a:.3g}"
    )
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_coords_cuda(*args_b),
        lambda: bs.bspline_coords_plain(*args_b), plain_reps=2,
    )
    results["bspline_coords"] = (err_b, ms, plain_ms)
    print(
        f"dense spline order 3 B=1 x {S}^3, a Motion grid: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (k, p, k, p: {', '.join(f'{t:.3f}' for t in order)});"
        f" max abs {err_b:.3g}; dense-entry launches {launches}"
    )
    return results, launches


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
    from torchio_tpu_torch.ops import bspline as bs
    from torchio_tpu_torch.ops import bspline_kernel as bk
    from torchio_tpu_torch.ops import kernel_lib as kl
    from torchio_tpu_torch.ops import resample_kernel as rk

    # the ops package exports the function ``resample`` under its module's name
    rs = importlib.import_module("torchio_tpu_torch.ops.resample")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.profile:
        Path(args.profile).unlink(missing_ok=True)
    smi = phase_device(torch, config)
    phase_build(kl)
    phase_kernel(torch, np, rs, rk, kl)
    phase_label_kernel(torch, np, rs, rk, kl)
    phase_prefilter_kernel(torch, np, bs, bk, kl)
    phase_spline_kernel(torch, np, rs, bs, bk, kl)
    phase_coords_kernel(torch, np, rs, rk, kl)
    phase_coords_spline_kernel(torch, np, rs, bs, bk, kl)
    phase_small_slice(torch, tio, tio_random)
    phase_small_labelled(torch, np, tio, tio_random, rs)
    phase_small_kspace(torch, tio, tio_random, kl)
    headline_launches = phase_slice(torch, tio, kl, args.profile)
    brats_launches, brats_batch = phase_brats(torch, tio, kl, args.profile)
    kspace_launches = phase_kspace(torch, tio, kl, args.profile)
    err, ms, plain_ms = phase_kernel_timing(torch, np, tio, rs, rk)
    timings = phase_brats_timing(torch, np, tio, rs, rk, bs, bk, brats_batch)
    del brats_batch
    dense, dense_launches = phase_dense_entry(torch, np, tio, rs, rk, bs, bk, kl)
    window = "torchio_tpu/ops/window_resample.py:335"
    kernels = [
        {
            "name": "resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": ["torchio_tpu/ops/shear_resample.py:81", window],
            "path": "headline",
            "launches": headline_launches["resample"],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "label_vote",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/label_resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": [window],
            "path": "brats-label-bspline",
            "launches": brats_launches["label_vote"],
            "max_abs_err": timings["label_vote"][0],
            "ms": timings["label_vote"][1],
            "plain_ms": timings["label_vote"][2],
        },
        {
            "name": "bspline_prefilter",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": "torchio_tpu/ops/bspline.py:81",
            "note": "XLA lax.scan prefilter in the JAX package; no Pallas counterpart",
            "path": "brats-label-bspline",
            "launches": brats_launches["bspline_prefilter"],
            "max_abs_err": timings["bspline_prefilter"][0],
            "ms": timings["bspline_prefilter"][1],
            "plain_ms": timings["bspline_prefilter"][2],
        },
        {
            "name": "bspline_resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "path": "brats-label-bspline",
            "launches": brats_launches["bspline_resample"],
            "max_abs_err": timings["bspline_resample"][0],
            "ms": timings["bspline_resample"][1],
            "plain_ms": timings["bspline_resample"][2],
        },
        {
            "name": "resample_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/pallas_resample.py:117",
            "path": "kspace-motion-ghosting",
            "launches": kspace_launches["resample_coords"],
            "max_abs_err": dense["resample_coords"][0],
            "ms": dense["resample_coords"][1],
            "plain_ms": dense["resample_coords"][2],
        },
        {
            "name": "bspline_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "note": "dense-coordinate mode; the JAX package's dense bspline_resample"
            " (torchio_tpu/ops/bspline.py:215) is an XLA gather",
            "path": "dense-entry",
            "launches": dense_launches["bspline_coords"],
            "max_abs_err": dense["bspline_coords"][0],
            "ms": dense["bspline_coords"][1],
            "plain_ms": dense["bspline_coords"][2],
        },
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
