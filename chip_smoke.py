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
     equal away from .5 ties; also on the row tiling's edges (rows of 1,
     3, 5 and 1,100 voxels, io x b and j tiles past the 65,535 grid cap),
     a field too fine to stage in shared memory, and a 1,291^3 volume
     (8.6 GB: offsets past 2^31);
   - label vote: equal off near ties, on int32 labels (also above 2^24),
     float32 labels, labels in large blocks and drawn per voxel, and
     tie-heavy half-voxel shifts; also on the row tiling's edges, a field
     too fine to stage, and a 1,291^3 int32 volume (offsets past 2^31);
   - prefilter: within 1e-5 of the plain coefficients' largest magnitude,
     orders 2-7, on lines that do not fill the last block, lines of 2,100
     samples on each axis (shared memory) and of 7,300 (device memory),
     and on 2-4 channels, which must come out channels-last;
   - spline: within 1e-5 max abs for orders 2-7 on inputs in [0, 1), on
     2 and 4 channels (four a load), from planar coefficients and from
     the prefilter kernel's channels-last ones, scale-downs by 2.6 and 4
     included;
   - dense-coordinate resample: equal, linear and nearest, shared and
     per-element grids, every fill form, points outside the volume, a
     size-1 axis, and the grid-spec resample's tiling edges and 1,291^3
     volume;
   - dense-coordinate spline: within 1e-5 max abs for orders 2-7;
   - threefry (jax.random's draws): the kernel's 32-bit words equal to
     the plain version's on draws that do not fill the last block, a
     4 x 256^3 draw, keys from split, and a draw past 2^32 words (the
     counter's high word); its normals within 1e-6 (log1pf rounds
     differently on the card), with the share of exact matches; its
     segmented draws (one launch for a list of draws: one segment,
     BiasField's 4 fields of 216 and of 576 normals times scales with 0
     and a negative one, segments of 1, 3 and 5 at unaligned offsets,
     cap + 1 segments in two launches, a Rician pair at 4 x 256^3) with
     words equal to the plain version's and normals equal to the kernel's
     separate draws times their scales;
4. small batches on the card against the CPU path, the card drawing its
   noise and bias fields with the threefry kernel and the CPU with the
   plain version: the headline (1e-4), the labelled BraTS-style pipeline
   (images 1e-4, labels equal off near ties), the k-space pair (1e-4,
   labels untouched), config 1 and config 2 (1e-4), config 3 (2 x (4 +
   1) x 40x44x24 at 1x1x2 mm to 1 mm) and config 4's forward and inverse
   (2 x (1 + 1) x 40x44x48; images 1e-4, labels equal off near ties of
   any step, 4 resample launches each); a subject and an array built
   from numpy go through the headline on the card (host data lands there
   by default) and launch the resample kernel;
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
8. config1-flip-noise-rescale: BASELINE.json config 1,
   ``Compose([Flip(axes=(0,), flip_probability=0.5), Noise(std=0.1),
   RescaleIntensity(0, 1)], fuse=True)`` on B=4 x 1 x 181x217x181
   float32, the same way; the output must lie in [0, 1];
9. config2-blur-bias-gamma: BASELINE.json config 2, ``Compose([Blur(
   std=(0.5, 1.5)), BiasField(std=0.5), Gamma(log_gamma=(-0.3, 0.3))])``
   (unfused) on B=4 x 1 x 256^3 float32, the same way; every path must
   launch the threefry kernel THREEFRY_LAUNCHES times a call (BiasField's
   per-element fields in one launch, Noise's draw in one);
10. config3-affine-resample: BASELINE.json config 3, ``Compose([Affine(
   scales=(0.9, 1.1), degrees=(-10, 10)), Resample(target=1.0)],
   copy=False)`` on a copy (metadata only) of B=4 subjects of a 4-channel
   192x192x96 float32 ``ch`` and an int32 ``seg`` at 1x1x2 mm, out at
   192^3 and 1 mm, the same way;
11. config4-elastic-inverse: BASELINE.json config 4 at 256^3,
   ``Compose([ElasticDeformation(max_displacement=7.5)])`` and then
   ``apply_inverse_transform()`` on B=4 subjects of a float32 ``t1`` and
   an int32 ``seg``, the same way, with the round trip's interior label
   consistency (a 12-voxel margin), which must beat the forward's alone;
   configs 3 and 4 must launch the resample kernel RESAMPLE_LAUNCHES
   times a call and the threefry kernel never;
12. each kernel against its plain version at its path's shape, timed
   kernel, plain, kernel, plain with CUDA events (the dense resample
   also against ``F.grid_sample``, its one-call library equivalent at a
   zero fill: kernel, library, kernel, library); the prefilter's three
   axis passes also timed one by one; the dense entry points
   ``ops.resample`` (B=4 x 256^3, per-element Motion grids) and
   ``ops.bspline.bspline_resample`` (cubic, B=1 of it) are called as a
   user calls them, with the launch counts zeroed around the calls; the
   threefry kernel at the headline's noise (B=4 x 1 x 256^3 normals),
   beside ``torch.randn`` of the same shape (Philox, another function:
   printed for scale, not as the library equivalent), with its main
   loop's SASS instructions an element (``cuobjdump -sass``) and the
   issue limit they set at the maximum SM clock (a model); the resample
   kernel also on config 3's diagonal 2 mm -> 1 mm map, beside
   ``F.interpolate(trilinear, align_corners=False)`` (the same map, which
   clamps at the border where the kernel fills: compared off the first
   and last k slice).

The line before the last is ``{"kernels": [...]}``: per kernel its
launches on its path, its error against the plain version, its time, the
plain version's and the library call's (or null), and its bound: the
larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and the float32 operations it does over 67
TFLOP/s (an H100 SXM's peaks; the threefry kernel's integer operations
count at the float32 rate, the only CUDA-core rate the data sheet
gives), with ``roofline`` = bound / time. The last line is ``{"ok":
true, "device": {...}}``. ``--profile PATH`` also writes a
``torch.profiler`` table of two calls of each pipeline to PATH, and
prints each pipeline's device time a call.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from importlib import metadata
from pathlib import Path

B, C, S = 4, 1, 256
BRATS_B, BRATS_C, BRATS_SHAPE = 4, 4, (240, 240, 155)
#: config 1's volume: benchmarks/suite.py's synthetic stand-in for Colin27
#: (1 mm MNI space)
CONFIG1_SHAPE = (181, 217, 181)
#: config 3's subjects (benchmarks/suite.py:169-194): a 4-channel ``ch``
#: and a label map ``seg`` of 192x192x96 voxels of 1x1x2 mm; Resample to
#: 1 mm doubles k
CONFIG3_C, CONFIG3_SHAPE, CONFIG3_SPACING = 4, (192, 192, 96), (1.0, 1.0, 2.0)
CONFIG3_OUT = (192, 192, 192)
#: config 4's interior label consistency skips this margin on every axis
#: (benchmarks/suite.py:208)
CONFIG4_MARGIN = 12
DEVICE = "cuda"
WARMUP, TIMED = 2, 5
KERNEL_ATOL = 1e-5
PREFILTER_RTOL = 1e-5
SLICE_ATOL = 1e-4
TIE_BAND = 1e-4
ORDERS = range(2, 8)
KERNELS = (
    "resample", "label_vote", "bspline_prefilter", "bspline_resample",
    "resample_coords", "bspline_coords", "threefry_normal",
)
#: threefry's normals: the kernel against the plain version (the bits
#: are held equal)
NORMAL_ATOL = 1e-6
#: threefry launches a call of each path: BiasField draws all of a
#: batch's per-element fields in one launch (a shared field too), Noise
#: one (a Rician pair too)
THREEFRY_LAUNCHES = {
    "headline": 2,
    "brats-label-bspline": 2,
    "config1-flip-noise-rescale": 1,
    "config2-blur-bias-gamma": 1,
    "config3-affine-resample": 0,
    "config4-elastic-inverse": 0,
}
#: resample-kernel launches a call: config 3's Affine and Resample each
#: resample ``ch`` (linear) and ``seg`` (nearest); config 4's
#: ElasticDeformation and its inverse each resample ``t1`` and ``seg``
RESAMPLE_LAUNCHES = {"config3-affine-resample": 4, "config4-elastic-inverse": 4}
#: operations a threefry normal takes: 2 counter adds, 20 rounds of add,
#: rotate and xor, 5 key injections of 2 adds, the final xor (73 integer
#: operations); the mantissa's shift and or; the uniform's subtract,
#: multiply, add and max; erf_inv's square, log1p, compare, two
#: subtracts, sqrt, 9 coefficient selects, 8 Horner steps of 2, the
#: |x| == 1 test and select, the product with x; the product with
#: sqrt(2) (log1p and sqrt counted as one operation each)
THREEFRY_OPS = 73 + 2 + 4 + (1 + 1 + 1 + 2 + 1 + 1 + 9 + 16 + 2 + 1 + 1) + 1
#: an H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s and
#: float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: an H100's issue width: SMs, warp schedulers an SM (one warp
#: instruction a clock each), lanes a warp, and lanes of a scheduler's
#: integer ALU pipe
SMS, SCHEDULERS, LANES, ALU_LANES = 132, 4, 32, 16
#: SASS opcodes (without modifiers) the integer ALU pipe issues, and those
#: the FMA pipe issues (IMAD included)
SASS_ALU = (
    "IADD3", "LOP3", "SHF", "ISETP", "FSETP", "FSEL", "SEL", "FMNMX", "IMNMX", "LEA", "PRMT",
    "IABS", "FLO", "POPC", "BMSK", "SGXT", "LOP", "MOV", "P2R", "R2P", "PLOP3", "VIADD",
)
SASS_FMA = ("IMAD", "FADD", "FMUL", "FFMA", "FCHK", "I2F", "F2I", "IMUL")
#: threefry::segments_kernel<true, unsigned int>: the normals kernel of
#: csrc/threefry.cu below 2^31 elements
THREEFRY_SASS_KERNEL = "_ZN8threefry15segments_kernelILb1EjEEvPvNS_5TableE"


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


def suite_labels(torch, shape, device):
    """(1, *shape) int32 labels (i // 24 + j // 24 + k // 24) % 4, the
    block-structured maps of benchmarks/suite.py:61-68."""
    i, j, k = (torch.arange(n, device=device) // 24 for n in shape)
    labels = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % 4
    return labels.to(torch.int32)[None]


def brats_labels(torch, shape, device):
    """(1, *shape) int32 block-structured labels in {0, 1, 2, 4}."""
    labels = suite_labels(torch, shape, device)
    labels[labels == 3] = 4
    return labels


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of a kernel's work, the larger
    of its bytes over the memory rate and its operations over the float32
    rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output: {mangled function: [(address, opcode,
    operands, predicated)]}."""
    import re

    functions, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(3), m.group(4).strip(),
                            bool(m.group(2))))
    return functions


def loop_profile(code) -> dict:
    """A kernel's main loop (the largest region a backward branch closes)
    per element it stores (a 128-bit store is four): its instructions in
    all, and on the hot path, by pipe (``alu``, ``fma``, ``mufu``,
    ``other``) and by opcode. The hot path leaves out the code a forward
    branch skips where it stores nothing (a rare case), and the arm of an
    if/else that holds a MUFU or a CALL (erf_inv's tail, sqrt's slow path),
    where the other arm does not."""
    import collections
    import re

    def target(op, args):
        m = re.match(r"(0x[0-9a-f]+)", args)
        return int(m.group(1), 16) if op.startswith("BRA") and m else None

    first, last = 0, 0
    for addr, op, args, _ in code:
        t = target(op, args)
        if t is not None and t < addr and addr - t > last - first:
            first, last = t, addr
    loop = [ins for ins in code if first <= ins[0] <= last]
    at = {ins[0]: i for i, ins in enumerate(loop)}

    def span(lo, hi):
        return [ins[1] for ins in loop if lo <= ins[0] < hi]

    def rare(ops):
        return any(op.startswith(("MUFU", "CALL")) for op in ops)

    cold = set()
    for addr, op, args, predicated in loop:
        t = target(op, args)
        if t is None or t <= addr or not predicated or t - 16 not in at:
            continue
        _, before_op, before_args, before_pred = loop[at[t - 16]]
        join = target(before_op, before_args)
        if join is not None and join > t and not before_pred:
            then_arm, else_arm = span(addr + 16, t), span(t, join)
            if rare(then_arm) and not rare(else_arm):
                cold.add((addr + 16, t))
            elif rare(else_arm) and not rare(then_arm):
                cold.add((t, join))
        elif not any(o.startswith("STG") for o in span(addr + 16, t)):
            cold.add((addr + 16, t))
    hot = [ins for ins in loop if not any(lo <= ins[0] < hi for lo, hi in cold)]
    elements = sum(4 if ".128" in op else 2 if ".64" in op else 1
                   for _, op, _, _ in loop if op.startswith("STG"))
    if not elements:
        fail("no store in the kernel's main loop")

    def pipe(op):
        if op in SASS_ALU:
            return "alu"
        if op in SASS_FMA:
            return "fma"
        return "mufu" if op == "MUFU" else "other"

    def per_element(counter):
        return {k: v / elements for k, v in counter.most_common()}

    ops = [ins[1].split(".")[0] for ins in hot]
    return {
        "per_element": len(loop) / elements,
        "hot_per_element": len(hot) / elements,
        "pipes": per_element(collections.Counter(map(pipe, ops))),
        "ops": per_element(collections.Counter(ops)),
    }


def sass_of(config, library: Path) -> dict:
    """{mangled function: its SASS} of a built library."""
    cuobjdump = Path(config.nvcc()).with_name("cuobjdump")
    return sass_functions(subprocess.run(
        [str(cuobjdump), "-sass", str(library)], capture_output=True, text=True, check=True
    ).stdout)


def issue_limits(profile: dict, n: int, clock_mhz: float) -> tuple[float, float]:
    """(issue limit, ALU pipe limit) in ms of ``n`` elements at
    ``profile``'s hot-path instructions an element: every instruction at
    one a scheduler a clock, and the ALU's over its 16 lanes."""
    hz = clock_mhz * 1e6
    issue = profile["hot_per_element"] * n / (SMS * SCHEDULERS * LANES * hz) * 1e3
    alu = profile["pipes"].get("alu", 0.0) * n / (SMS * SCHEDULERS * ALU_LANES * hz) * 1e3
    return issue, alu


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


#: float32 operations per output voxel of a sample point: the 3x4 map
#: (9 products, 9 sums) and, with a field, 3 components x 7 lerps x 4
def point_flops(fields) -> int:
    return 18 + (84 if fields is not None else 0)


def weight_flops(order: int) -> int:
    """Operations per axis for the fold, the base and the order+1 tap
    weights (closed forms at orders 2-3, Cox-de Boor's 2^order - 1 nodes of
    5 operations per weight at 4-7)."""
    if order == 2:
        return 7 + 9
    if order == 3:
        return 7 + 28
    return 7 + (order + 1) * 5 * (2**order - 1)


def spline_flops(order: int, voxels: int, channels: int, fields) -> int:
    """Per output voxel: its point, the 3-axis fill mask (6 each), the
    weights and the T^2 products wi wj; per voxel and channel, T^2 k sums
    of T products and T - 1 sums, each times its wi wj and added:
    T^2 (2T + 1), 144 at order 3."""
    t = order + 1
    per_voxel = point_flops(fields) + 18 + 3 * weight_flops(order) + t * t
    return voxels * per_voxel + voxels * channels * t * t * (2 * t + 1)


def prefilter_flops(bs, order: int, shape) -> int:
    """The gain, every pole's start sum (3 operations a term) and its two
    sweeps (2 a sample, 3 for the anticausal start), per line and axis."""
    total = 0
    spatial = shape[-3:]
    for axis, n in enumerate(spatial):
        if n == 1:
            continue
        lines = math.prod(shape) // n
        _, constants = bs.pole_constants(order, n)
        per_line = n
        for _, horizon, _, _ in constants:
            terms = horizon if horizon < n else 2 * n - 2
            per_line += 3 * terms + 4 * (n - 1) + 3
        total += lines * per_line
    return total


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


#: (input spatial shape, output spatial shapes) for the row-tiled
#: resample kernels' edges: rows shorter than a thread's 4 voxels and not
#: a multiple of them; rows wider than a block's 128-voxel tile; io x b
#: past the 65,535 cap on grid z, with io past it and under it; j tiles
#: past the cap on grid y
EDGE_SHAPES = (
    ((12, 14, 20), ((9, 10, 1), (9, 10, 3), (9, 10, 5))),
    ((12, 14, 150), ((3, 4, 1100),)),
    ((12, 14, 20), ((70000, 1, 2), (40000, 1, 2), (1, 600000, 1))),
)
#: one volume of 1,291^3 voxels: offsets past 2^31, the kernels' 64-bit path
WIDE_SHAPE, WIDE_OUT = (1291, 1291, 1291), (8, 8, 8)
#: a coarse field with more k points than the kernel stages in shared
#: memory (512): upsampled whole a voxel
FINE_FIELD = (3, 3, 600, 3)


def edge_matrices(in_shape, out_shape, target=None):
    """Two maps that stretch the output grid over the input's (rotated a
    little about the output's center onto ``target``, by default the
    input's center)."""
    import numpy as np

    c_out = np.asarray([(n - 1) / 2 for n in out_shape])
    c_in = np.asarray([(n - 1) / 2 for n in in_shape] if target is None else target)
    scale = np.diag([(i - 1) / max(o - 1, 1) for i, o in zip(in_shape, out_shape)])
    matrices = []
    for angles in ((0.15, -0.1, 0.12), (-0.08, 0.17, -0.05)):
        m = rot(*angles, 1.0, (0.0, 0.0, 0.0), c_out)
        m[:3, :3] = m[:3, :3] @ scale
        m[:3, 3] = c_in - m[:3, :3] @ c_out
        matrices.append(m)
    return matrices


def edge_grids(np, rs, dev, in_shape, out_shape, b, target=None, field_shape=(7, 7, 7, 3)):
    """The (maps, fields) of :func:`edge_matrices`, with and without an
    elastic field of ``field_shape``."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, field_shape)
    matrices = edge_matrices(in_shape, out_shape, target)[:b]
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field] * b, [None] * b)]


def wide_volume(torch, dev):
    """A 1 x 1 x 1,291^3 float32 volume in [0, 1) (8.6 GB) and the point
    near its far corner that the wide cases sample around."""
    gen = torch.Generator(device=dev).manual_seed(8)
    vol = torch.rand((1, 1, *WIDE_SHAPE), generator=gen, device=dev)
    return vol, [n - 4.5 for n in WIDE_SHAPE]


def resample_cases(torch, np, rs, dev, b, c):
    """(case name, vol, [(maps, fields)], out_shape) for the grid-spec
    kernel phase: the kernel shapes, the tiling's edges and a field too
    fine to stage."""
    rng = np.random.default_rng(0)
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            yield "", vol, kernel_grids(np, rs, dev, in_shape), out_shape
    for in_shape, out_shapes in EDGE_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            yield "edge ", vol, edge_grids(np, rs, dev, in_shape, out_shape, b), out_shape
    in_shape, out_shape = (12, 14, 20), (5, 6, 700)
    vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
    grids = edge_grids(np, rs, dev, in_shape, out_shape, b, field_shape=FINE_FIELD)
    yield f"field {FINE_FIELD} ", vol, grids[:1], out_shape


def phase_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    b, c = 2, 2
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["resample"]
    worst = {"linear": 0.0, "nearest": 0}
    cases = 0

    def check(kind, vol, grids, out_shape, fills):
        nonlocal cases
        b, c = vol.shape[:2]
        for maps, fields in grids:
            ties = coord_tie_mask(torch, rs, maps, fields, out_shape)
            for mode in ("linear", "nearest"):
                for fname, fill in fills.items():
                    fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                    args = (vol, maps, fields, fill_bc, out_shape, mode, apply_fill)
                    got = rk.resample_cuda(*args)
                    want = rs.resample_plain(*args)
                    torch.cuda.synchronize()
                    where = (
                        f"{kind}{mode} {tuple(vol.shape[2:])}->{out_shape}"
                        f" {'elastic' if fields is not None else 'affine'} fill {fname}"
                    )
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

    for kind, vol, grids, out_shape in resample_cases(torch, np, rs, dev, b, c):
        check(kind, vol, grids, out_shape, fills)
    vol, corner = wide_volume(torch, dev)
    wide_fills = {**fills, "(B,C)": torch.as_tensor([[0.75]], device=dev)}
    check("wide ", vol, edge_grids(np, rs, dev, WIDE_OUT, WIDE_OUT, 1, corner), WIDE_OUT,
          wide_fills)
    del vol
    torch.cuda.empty_cache()
    check_launches(kl, "resample", before, cases)
    print(
        f"resample kernel vs plain: {cases} cases (rows of 1, 3, 5 and 1,100 voxels,"
        f" io x b and j tiles past the grid cap, a {FINE_FIELD[:3]} field, a"
        f" {'x'.join(map(str, WIDE_SHAPE))} volume); linear max abs {worst['linear']:.3g}"
        f" (limit {KERNEL_ATOL}); nearest voxels differing off ties {worst['nearest']}"
    )
    return worst["linear"]


def label_volumes(torch, np, rng, b, in_shape, dev):
    """int32 labels {0, 1, 2, 4} in blocks of 3 voxels, the same above 2^24
    (2^24 + {1, 2, 3, 5}: neighbours a float32 round trip would merge)
    and as float labels; in blocks of 8 voxels (most voxels' 8 corners
    carry one label); and drawn per voxel (the vote decides nearly every
    voxel, ties included)."""

    def blocks(size):
        coarse = rng.integers(0, 4, (b, 1, *[-(-s // size) for s in in_shape]))
        out = coarse.repeat(size, 2).repeat(size, 3).repeat(size, 4)
        out = out[:, :, : in_shape[0], : in_shape[1], : in_shape[2]].astype(np.int32)
        out[out == 3] = 4
        return torch.as_tensor(out, device=dev)

    ints = blocks(3)
    return {
        "int32": ints,
        "int32>2^24": ints + (2**24 + 1),
        "float32": ints.to(torch.float32) * 0.5,
        "uniform": blocks(8),
        "noisy": blocks(1),
    }


def tie_grids(np, rs, dev):
    """Maps that shift the input by half a voxel on each axis, and by a
    quarter on one: equal corner weights, so per-voxel labels tie often
    and exactly (the smallest label must win)."""
    shifts = ((0.5, 0.5, 0.5), (0.5, 0.25, 0.5))
    matrices = []
    for shift in shifts:
        m = np.eye(4)
        m[:3, 3] = shift
        matrices.append(m)
    return [rs._marshal_maps(matrices, [None, None], dev)]


def label_cases(torch, np, rs, dev):
    """(case name, {kind: labels}, [(maps, fields)], out_shape) for the
    label phase: the kernel shapes (also with tie-heavy maps), the row
    tiling's edges as the resample phase has them, and a field too fine
    to stage."""
    rng = np.random.default_rng(2)
    for in_shape, out_shapes in KERNEL_SHAPES:
        volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
        for out_shape in out_shapes:
            yield "", volumes, kernel_grids(np, rs, dev, in_shape), out_shape
        yield "ties ", volumes, tie_grids(np, rs, dev), in_shape
    for in_shape, out_shapes in EDGE_SHAPES:
        volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
        for out_shape in out_shapes:
            yield "edge ", volumes, edge_grids(np, rs, dev, in_shape, out_shape, 2), out_shape
    in_shape, out_shape = (12, 14, 20), (5, 6, 700)
    grids = edge_grids(np, rs, dev, in_shape, out_shape, 2, field_shape=FINE_FIELD)
    volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
    yield f"field {FINE_FIELD} ", volumes, grids[:1], out_shape


def wide_labels(torch, dev):
    """A 1 x 1 x 1,291^3 int32 label volume drawn per voxel from {0, ...,
    4} (8.6 GB) and the point near its far corner that the case samples
    around."""
    gen = torch.Generator(device=dev).manual_seed(9)
    labels = torch.randint(0, 5, (1, 1, *WIDE_SHAPE), generator=gen, device=dev,
                           dtype=torch.int32)
    return labels, [n - 4.5 for n in WIDE_SHAPE]


def phase_label_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    before = kl.LAUNCHES["label_vote"]
    cases = voxels = 0
    differ = {"kernel shapes": 0, "the rest": 0}
    ties_total = 0

    def check(kind, name, labels, grids, out_shape):
        nonlocal cases, voxels, ties_total
        for maps, fields in grids:
            ties = vote_ties(torch, rs, labels, maps, fields, out_shape)
            for pad in (0.0, 7.0):
                got = rk.resample_label_cuda(labels, maps, fields, out_shape, pad)
                want = rs.resample_label_plain(labels, maps, fields, out_shape, pad)
                torch.cuda.synchronize()
                where = (
                    f"label {kind}{name} {tuple(labels.shape[2:])}->{out_shape}"
                    f" {'elastic' if fields is not None else 'affine'} pad {pad}"
                )
                if got.shape != want.shape or got.dtype != labels.dtype:
                    fail(f"{where}: output {tuple(got.shape)} {got.dtype}")
                diff = got != want
                old = kind == "" and name in ("int32", "int32>2^24", "float32")
                differ["kernel shapes" if old else "the rest"] += int(diff.sum())
                off = int((diff & ~ties).sum())
                if off:
                    fail(f"{where}: {off} voxels differ off near ties")
                ties_total += int(ties.sum())
                voxels += got.numel()
                cases += 1

    for kind, volumes, grids, out_shape in label_cases(torch, np, rs, dev):
        for name, labels in volumes.items():
            check(kind, name, labels, grids, out_shape)
    labels, corner = wide_labels(torch, dev)
    check("wide ", "int32", labels, edge_grids(np, rs, dev, WIDE_OUT, WIDE_OUT, 1, corner),
          WIDE_OUT)
    del labels
    torch.cuda.empty_cache()
    check_launches(kl, "label_vote", before, cases)
    total = sum(differ.values())
    print(
        f"label vote kernel vs plain: {cases} cases (int32, int32 above 2^24, float32,"
        f" blocks of 8, labels drawn per voxel, tie-heavy half-voxel shifts; rows of 1, 3,"
        f" 5 and 1,100 voxels, io x b and j tiles past the grid cap, a {FINE_FIELD[:3]}"
        f" field, a {'x'.join(map(str, WIDE_SHAPE))} volume); {total} of {voxels} voxels"
        f" differ, all at near ties ({differ['kernel shapes']} in the kernel shapes' int32,"
        f" int32 above 2^24 and float32 cases; {ties_total} near-tie voxels)"
    )
    return total


#: prefilter volumes: non-aligned (lines that do not fill the last
#: block), short axes (periodic start), a size-1 axis; 2-4 channels (the
#: output channels-last, the i pass moving them); lines of 2,100 samples
#: on each axis (smaller blocks), with 2 channels on the i axis; lines of
#: 7,300, longer than shared memory holds, on the k and i axes (device
#: memory)
PREFILTER_SHAPES = (
    (2, 2, 37, 45, 51), (1, 1, 3, 5, 40), (2, 1, 23, 19, 1), (1, 3, 20, 21, 22),
    (2, 4, 9, 40, 33), (1, 1, 2100, 3, 5), (1, 2, 2100, 3, 5), (1, 1, 3, 2100, 5),
    (1, 1, 3, 5, 2100), (1, 1, 2, 3, 7300), (1, 1, 7300, 4, 8),
)


def phase_prefilter_kernel(torch, np, bs, bk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    kernels = ("bspline_prefilter", "bspline_prefilter_global")
    before = {k: kl.LAUNCHES[k] for k in kernels}
    worst, cases, paths, moved = 0.0, 0, {}, 0
    for shape in PREFILTER_SHAPES:
        vol = torch.as_tensor(rng.random(shape, np.float32), device=dev)
        channels_last, steps = bk.prefilter_steps(shape)
        for step in steps:
            paths[step.plan.path] = paths.get(step.plan.path, 0) + len(ORDERS)
        moved += channels_last * len(ORDERS)
        layout = torch.channels_last_3d if channels_last else torch.contiguous_format
        for order in ORDERS:
            got = bk.prefilter_cuda(vol, order)
            want = bs.prefilter_plain(vol, order)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
            if not err <= PREFILTER_RTOL or not got.is_contiguous(memory_format=layout):
                fail(f"prefilter order {order} {shape}: relative error {err}, layout {got.stride()}")
            cases += 1
    grown = {k: kl.LAUNCHES[k] - before[k] for k in kernels}
    if sum(grown.values()) != 3 * cases or grown["bspline_prefilter_global"] != paths["global"]:
        fail(f"{cases} prefilter calls, plans {paths}, launches {grown}")
    print(
        f"prefilter kernel vs plain: {cases} cases, orders 2-7; max abs error over"
        f" the largest coefficient {worst:.3g} (limit {PREFILTER_RTOL}); {moved} came out"
        f" channels-last; axis passes by path {paths}; launches {grown}"
    )
    return worst


#: spline scale-downs (input shape, output shape, scale): each output
#: step covers 2.6 or 4 input voxels, so a warp's taps spread over many
#: rows and the mirror reflections at the faces
SPLINE_SCALE_DOWNS = (((40, 90, 90), (8, 20, 20), 2.6), ((48, 100, 100), (9, 22, 22), 4.0))


def scale_down_grids(np, rs, dev, in_shape, out_shape, scale):
    """Two rotations that map the output's center onto the input's and
    scale its steps by ``scale``, with and without the kernel phases'
    elastic field."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, (7, 7, 7, 3))
    c_in = np.asarray([(n - 1) / 2 for n in in_shape])
    c_out = np.asarray([(n - 1) / 2 for n in out_shape])
    matrices = []
    for angles in ((0.15, -0.1, 0.12), (-0.08, 0.17, -0.05)):
        m = rot(*angles, scale, (0.0, 0.0, 0.0), c_out)
        m[:3, 3] = c_in - m[:3, :3] @ c_out
        matrices.append(m)
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field, None], [None, None])]


def phase_spline_kernel(torch, np, rs, bs, bk, kl):
    """Orders 2-7 with 2 channels (one a load) and 4 (four a load), on
    planar coefficients (the wrapper makes them channels-last) and on the
    prefilter kernel's channels-last ones."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(4)
    b = 2
    before = kl.LAUNCHES["bspline_resample"]
    worst, cases = 0.0, 0

    def check(kind, coeffs, maps, fields, fill, out_shape, order):
        nonlocal worst, cases
        c = coeffs.shape[1]
        fill_bc, _ = rs._fill_bc(fill, b, c, dev)
        args = (coeffs, maps, fields, fill_bc, out_shape, order)
        got = bk.bspline_resample_cuda(*args)
        want = bs.bspline_resample_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if got.shape != (b, c, *out_shape) or not err <= KERNEL_ATOL:
            fail(
                f"spline {kind} order {order} {tuple(coeffs.shape[-3:])}->{out_shape}:"
                f" shape {tuple(got.shape)}, max abs {err}"
            )
        cases += 1

    for c in (2, 4):
        fill_bc = torch.as_tensor(rng.uniform(-1.0, 2.0, (b, c)).astype(np.float32), device=dev)
        for in_shape, out_shapes in KERNEL_SHAPES:
            vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
            for order in ORDERS:
                coeffs = bs.prefilter_plain(vol, order)
                for out_shape in out_shapes:
                    for maps, fields in kernel_grids(np, rs, dev, in_shape):
                        for fill in (0.0, fill_bc):
                            check("grid", coeffs, maps, fields, fill, out_shape, order)
                check("grid, prefilter kernel's coefficients", bk.prefilter_cuda(vol, order),
                      *kernel_grids(np, rs, dev, in_shape)[0], fill_bc, out_shapes[-1], order)
        for in_shape, out_shape, scale in SPLINE_SCALE_DOWNS:
            vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
            for order in ORDERS:
                coeffs = bs.prefilter_plain(vol, order)
                for maps, fields in scale_down_grids(np, rs, dev, in_shape, out_shape, scale):
                    check("scale-down", coeffs, maps, fields, fill_bc, out_shape, order)
    check_launches(kl, "bspline_resample", before, cases)
    print(
        f"spline kernel vs plain: {cases} cases, orders 2-7, 2 and 4 channels"
        f" (scale-downs by 2.6 and 4 included); max abs {worst:.3g} (limit {KERNEL_ATOL})"
    )
    return worst


def run_on_both(tio, make, pipeline, seed):
    """``pipeline`` from one seed on the CPU and on the card: each draws
    its own noise and bias fields (the plain threefry version on the CPU,
    the kernel on the card)."""
    import torch

    # the first multithreaded torch.exp of a process has returned results
    # off by up to 2e-4 on PyTorch's CPU build (2.13.0+cpu); warm the
    # CPU thread pool before the CPU path is the reference
    torch.exp(torch.zeros(1 << 20))
    outs = []
    for device in ("cpu", DEVICE):
        batch = make().to(device)
        tio.seed(seed)
        outs.append(pipeline(tio)(batch))
    cpu, gpu = outs
    if [h.params for h in cpu.applied_transforms] != [
        h.params for h in gpu.applied_transforms
    ]:
        fail("history params differ between cpu and cuda")
    return cpu, gpu


def phase_small_slice(torch, tio):
    """The headline on a small batch: card against the CPU path."""
    cpu, gpu = run_on_both(
        tio, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 3), headline, 11,
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


def phase_small_labelled(torch, np, tio, rs):
    """brats-label-bspline on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    cpu, gpu = run_on_both(
        tio, lambda: make_brats_batch(tio, torch, 2, shape, "cpu", 5),
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


def phase_host_subject(torch, np, tio, kl):
    """A subject and a bare array built from numpy go through the headline
    with no device named: the data lands on the card and the resample
    kernel launches; the array comes back as host numpy."""
    arr = np.random.default_rng(12).random((1, 48, 52, 56), np.float32)
    subject = tio.Subject(t1=tio.ScalarImage(arr))
    if subject.t1.data.device.type != DEVICE:
        fail(f"a numpy-built subject lies on {subject.t1.data.device}")
    before = kl.LAUNCHES["resample"]
    tio.seed(3)
    out = headline(tio)(subject)
    tio.seed(3)
    out_arr = headline(tio)(arr)
    torch.cuda.synchronize()
    launched = kl.LAUNCHES["resample"] - before
    data = out.t1.data
    if data.device.type != DEVICE or launched != 2 or not bool(torch.isfinite(data).all()):
        fail(f"numpy-built subject: output on {data.device}, {launched} resample launches")
    if not isinstance(out_arr, np.ndarray) or out_arr.shape != arr.shape:
        fail(f"numpy array through the headline came back as {type(out_arr).__name__}")
    err = float(np.abs(out_arr - data.cpu().numpy()).max())
    if err != 0.0:
        fail(f"array and subject entries differ by {err} on the same seed")
    print(
        f"numpy-built subject and array (1 x 48x52x56) through the headline on"
        f" {data.device}: resample launches {launched}; the array comes back as"
        f" numpy, equal to the subject's output"
    )


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            pipeline(batch)
        torch.cuda.synchronize()
    events = p.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    # the table's "Self CUDA time total": the device events' own time
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(f"== {title}: two calls ==\n{table}\n")
    print(f"profile ({title}): device time {device_us / 2e3:.3f} ms a call; table in {path}")


def phase_slice(torch, tio, kl, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 0)
    pipeline = headline(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, _ = drive(
        torch, kl, pipeline, batch, ("resample", "threefry_normal")
    )
    # BiasField draws its B coarse fields in one launch, Noise one volume
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES["headline"] for d in draws):
        fail(f"headline threefry launches per call {draws}, expected"
             f" {THREEFRY_LAUNCHES['headline']}")
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
        f" resample launches per call {[c['resample'] for c in per_call]}; threefry"
        f" launches per call {draws} (BiasField 1 for its {B} fields, Noise 1);"
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
    new = ("label_vote", "bspline_prefilter", "bspline_resample", "threefry_normal")
    out, times, per_call, totals, peak, _ = drive(torch, kl, pipeline, batch, new)
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES["brats-label-bspline"] for d in draws):
        fail(f"brats threefry launches per call {draws}, expected"
             f" {THREEFRY_LAUNCHES['brats-label-bspline']}")
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
    voxels = B * S**3
    # trilinear: 8 corner weights (16 products) a voxel, 8 products and 7
    # sums a voxel and channel
    work = bound(
        nbytes(vol, maps, fields, fill) + vol.numel() * 4,
        voxels * (point_flops(fields) + 16) + voxels * C * 15,
    )
    print(
        f"resample B={B} x {S}^3 linear + elastic: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (kernel, plain, kernel, plain:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work}


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
    voxels = BRATS_B * math.prod(BRATS_SHAPE)
    # the vote: 8 corner weights (16 operations), each added to its
    # label's total (7 sums: a label's first weight starts its total), the
    # top total (7 compares) and the in-bounds weight (7 sums); the label
    # compares are integer work and left out
    work = bound(
        nbytes(seg, maps, fields) + seg.numel() * 4,
        voxels * (point_flops(fields) + 16 + 7 + 7 + 7),
    )
    results["label_vote"] = {
        "max_abs_err": label_err, "ms": ms, "plain_ms": plain_ms, "bound": work,
    }
    print(
        f"label vote B={BRATS_B} x 1 x {'x'.join(map(str, BRATS_SHAPE))} int32: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); voxels differing {differ};"
        f" bound {work[0]:.3f} ms ({work[1]})"
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
    # each axis pass alone: the first reads the volume and writes the
    # coefficients channels-last, the others work in place, as in a call
    work_buf = torch.empty_like(coeffs)
    _, steps = bk.prefilter_steps(tuple(mri.shape))
    pass_ms = []
    for n, step in enumerate(steps):
        src = mri if n == 0 else work_buf
        pass_ms.append(cuda_time_ms(
            torch, lambda st=step, x=src: bk.prefilter_pass(x, work_buf, st, 3), 20
        ))
    del work_buf
    plans = [step.plan for step in steps]
    work = bound(2 * nbytes(mri), prefilter_flops(bs, 3, tuple(mri.shape)))
    results["bspline_prefilter"] = {
        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "pass_ms": pass_ms,
    }
    print(
        f"prefilter order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {abs_err:.3g}, over the"
        f" largest coefficient {err:.3g}; passes i, j, k"
        f" {', '.join(f'{t:.3f}' for t in pass_ms)} ms"
        f" ({', '.join(f'{p.path} x {p.per_block}' for p in plans)});"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )

    fill, _ = rs._fill_bc(torch.amin(mri, dim=(-3, -2, -1)), BRATS_B, BRATS_C, dev)
    args = (coeffs, maps, fields, fill, BRATS_SHAPE, 3)
    got = bk.bspline_resample_cuda(*args)
    err = float((got - bs.bspline_resample_plain(*args)).abs().max())
    del got
    if not err <= KERNEL_ATOL:
        fail(f"spline at the slice's shape: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_resample_cuda(*args),
        lambda: bs.bspline_resample_plain(*args), plain_reps=2,
    )
    work = bound(
        nbytes(coeffs, maps, fields, fill) + coeffs.numel() * 4,
        spline_flops(3, voxels, BRATS_C, fields),
    )
    results["bspline_resample"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
    }
    print(
        f"spline order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
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


def dense_grids(torch, rs, dev, in_shape, out_shape, b, matrices=None):
    """Per-element (b, *out_shape, 3) coordinates: the kernel phases'
    rotated, scaled and shifted maps (their borders leave the volume), or
    ``matrices``, each coordinate jittered by up to one voxel."""
    if matrices is None:
        center = [(s - 1) / 2 for s in in_shape]
        matrices = [
            rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
            rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
        ]
    grids = torch.stack([rs.build_coords(out_shape, m, device=dev) for m in matrices[:b]])
    gen = torch.Generator(device=dev).manual_seed(7)
    return grids + (torch.rand(grids.shape, generator=gen, device=dev) * 2.0 - 1.0)


def phase_coords_kernel(torch, np, rs, rk, kl):
    """The dense-coordinate resample kernel against its plain version:
    linear and nearest, per-element and shared grids, every fill form,
    out-of-bounds points, a size-1 axis, the tiling's edges and a volume
    past 2^31 voxels; equal voxel for voxel."""
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

    def check(kind, vol, grids, fills):
        nonlocal cases
        b, c = vol.shape[:2]
        out_shape = tuple(grids.shape[1:4])
        pairs = (("per-element", grids), ("shared", grids[:1].contiguous()))
        for grid_kind, coords in pairs[: 2 if b > 1 else 1]:
            for mode in ("linear", "nearest"):
                for fname, fill in fills.items():
                    fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                    args = (vol, coords, fill_bc, mode, apply_fill)
                    got = rk.resample_coords_cuda(*args)
                    want = rs.resample_coords_plain(*args)
                    torch.cuda.synchronize()
                    where = (
                        f"dense {kind}{mode} {grid_kind} {tuple(vol.shape[2:])}->{out_shape}"
                        f" fill {fname}"
                    )
                    if got.shape != (b, c, *out_shape):
                        fail(f"{where}: output shape {tuple(got.shape)}")
                    differ = int((got != want).sum())
                    if differ:
                        err = float((got - want).abs().max())
                        fail(f"{where}: {differ} voxels differ, max abs {err}")
                    cases += 1

    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            check("", vol, dense_grids(torch, rs, dev, in_shape, out_shape, b), fills)
    for in_shape, out_shapes in EDGE_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            matrices = edge_matrices(in_shape, out_shape)
            check("edge ", vol, dense_grids(torch, rs, dev, in_shape, out_shape, b, matrices),
                  fills)
    vol, corner = wide_volume(torch, dev)
    wide_fills = {**fills, "(C,)": [0.5], "(B,C)": torch.as_tensor([[0.75]], device=dev)}
    matrices = edge_matrices(WIDE_OUT, WIDE_OUT, corner)
    check("wide ", vol, dense_grids(torch, rs, dev, WIDE_SHAPE, WIDE_OUT, 1, matrices),
          wide_fills)
    del vol
    torch.cuda.empty_cache()
    check_launches(kl, "resample_coords", before, cases)
    print(
        f"dense resample kernel vs plain: {cases} cases (linear and nearest,"
        f" per-element and shared grids, 4 fill forms, the tiling's edges, a"
        f" {'x'.join(map(str, WIDE_SHAPE))} volume); max abs 0"
    )


def phase_coords_spline_kernel(torch, np, rs, bs, bk, kl):
    """The dense-coordinate spline kernel against its plain version,
    orders 2-7, within KERNEL_ATOL."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    b = 2
    before = kl.LAUNCHES["bspline_coords"]
    worst, cases = 0.0, 0
    for c, (in_shape, out_shapes) in itertools.product((2, 4), KERNEL_SHAPES):
        fill_bc = torch.as_tensor(rng.uniform(-1.0, 2.0, (b, c)).astype(np.float32), device=dev)
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
                            f"dense spline order {order} C={c} {kind} {in_shape}->{out_shape}:"
                            f" shape {tuple(got.shape)}, max abs {err}"
                        )
                    cases += 1
    check_launches(kl, "bspline_coords", before, cases)
    print(
        f"dense spline kernel vs plain: {cases} cases, orders 2-7, 2 and 4 channels,"
        f" per-element and shared grids; max abs {worst:.3g} (limit {KERNEL_ATOL})"
    )
    return worst


def phase_small_kspace(torch, tio, kl):
    """kspace-motion-ghosting on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    before = kl.LAUNCHES["resample_coords"]
    cpu, gpu = run_on_both(
        tio, lambda: make_kspace_batch(tio, torch, B, shape, "cpu", 7), kspace_pipeline, 10,
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
    got_kernel_a = got_a
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
    # the one PyTorch call of the same function at a zero fill: grid_sample
    # takes (x, y, z) = (k, j, i) normalised to [-1, 1] (align_corners);
    # the conversion is outside the timed window
    scale = torch.tensor([2.0 / (n - 1) for n in reversed(shape)], device=dev)
    grid = (coords.flip(-1) * scale - 1.0).contiguous()
    library = torch.nn.functional.grid_sample
    lib_args = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    lib_err = float((library(vol, grid, **lib_args) - got_kernel_a).abs().max())
    del got_kernel_a
    lib_order, _, library_ms = time_pair(
        torch, lambda: rk.resample_coords_cuda(*args_a),
        lambda: library(vol, grid, **lib_args), plain_reps=20,
    )
    del grid
    voxels = B * S**3
    work = bound(
        nbytes(vol, coords, fill_a) + vol.numel() * 4,
        voxels * 16 + voxels * C * 15,
    )
    results["resample_coords"] = {
        "max_abs_err": err_a, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "library_ms": library_ms,
    }
    print(
        f"dense resample B={B} x {S}^3 linear, per-element Motion grids: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err_a:.3g};"
        f" F.grid_sample {library_ms:.3f} ms (k, l, k, l:"
        f" {', '.join(f'{t:.3f}' for t in lib_order)}), max abs vs the kernel"
        f" {lib_err:.3g}; bound {work[0]:.3f} ms ({work[1]})"
    )
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_coords_cuda(*args_b),
        lambda: bs.bspline_coords_plain(*args_b), plain_reps=2,
    )
    voxels = S**3
    # a read point needs no map: the mask and the weights
    work = bound(
        nbytes(coeffs, coords1, fill_b) + coeffs.numel() * 4,
        spline_flops(3, voxels, C, None) - voxels * point_flops(None),
    )
    results["bspline_coords"] = {
        "max_abs_err": err_b, "ms": ms, "plain_ms": plain_ms, "bound": work,
    }
    print(
        f"dense spline order 3 B=1 x {S}^3, a Motion grid: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (k, p, k, p: {', '.join(f'{t:.3f}' for t in order)});"
        f" max abs {err_b:.3g}; dense-entry launches {launches};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return results, launches


def config1_pipeline(tio):
    """BASELINE.json config 1 (benchmarks/suite.py:96-111)."""
    return tio.Compose(
        [
            tio.Flip(axes=(0,), flip_probability=0.5),
            tio.Noise(std=0.1),
            tio.RescaleIntensity(out_min=0.0, out_max=1.0),
        ],
        fuse=True,
    )


def config2_pipeline(tio):
    """BASELINE.json config 2 (benchmarks/suite.py:145-166), unfused."""
    return tio.Compose(
        [
            tio.Blur(std=(0.5, 1.5)),
            tio.BiasField(std=0.5),
            tio.Gamma(log_gamma=(-0.3, 0.3)),
        ]
    )


#: (name, shape) of the threefry kernel's checks: draws shorter than a
#: block, not a multiple of its 256 threads, past one grid-stride turn,
#: and the headline's noise
THREEFRY_SHAPES = (
    ("one", (1,)),
    ("255", (255,)),
    ("257", (257,)),
    ("odd", (3, 5, 7, 11)),
    ("strided", (1_000_003,)),
    ("headline", (B, C, S, S, S)),
)
#: a draw past 2^32 words (17 GB of each type): the 64-bit instantiation
#: and the counter's high word; its head, the words around 2^31 and 2^32,
#: and its tail are held against the plain version
THREEFRY_WIDE = 2**32 + 2**20


def threefry_keys(tr):
    """Keys as the port derives them: PRNGKey of a seed, keys from split,
    and words with the top bit set."""
    return {
        "PRNGKey(42)": tr.prng_key(42),
        "split(PRNGKey(7), 3)[1]": tr.split(tr.prng_key(7), 3)[1],
        "Noise image 0, k2": tr.draw_key(2**31 - 2, 2),
        "(0xFFFFFFFF, 0x80000001)": (0xFFFFFFFF, 0x80000001),
    }


def phase_threefry_kernel(torch, tr, tk, kl):
    """The threefry kernel against its plain version: words equal, normals
    within NORMAL_ATOL."""
    dev = torch.device(DEVICE)
    before = {k: kl.LAUNCHES[k] for k in ("threefry_bits", "threefry_normal")}
    worst, exact, total, cases = 0.0, 0, 0, 0
    for key_name, key in threefry_keys(tr).items():
        for name, shape in THREEFRY_SHAPES:
            if name == "headline" and key_name != "PRNGKey(42)":
                continue
            n = math.prod(shape)
            words = tr.bits_plain(key, 0, n, dev)
            got = tk.threefry_bits_cuda(key, shape, dev).view(torch.int32).reshape(-1)
            want = tr.as_uint32(words).view(torch.int32)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            if tuple(tk.threefry_bits_cuda(key, shape, dev).shape) != shape or differ:
                fail(f"threefry bits {key_name} {shape}: {differ} words differ")
            normal = tk.threefry_normal_cuda(key, shape, dev).reshape(-1)
            plain = tr.normal_of_bits(words)
            torch.cuda.synchronize()
            diff = (normal - plain).abs()
            err = float(diff.max())
            worst = max(worst, err)
            exact += int((diff == 0).sum())
            total += n
            if not err <= NORMAL_ATOL:
                fail(f"threefry normals {key_name} {shape}: max abs {err}")
            cases += 1
            del words, got, want, normal, plain, diff
    torch.cuda.empty_cache()
    grown = {k: kl.LAUNCHES[k] - before[k] for k in before}
    if grown != {"threefry_bits": 2 * cases, "threefry_normal": cases}:
        fail(f"{cases} threefry cases, launches {grown}")
    # past 2^32 words: the 64-bit path carries the counter's high word
    key = tr.prng_key(42)
    spans = ((0, 2**20), (2**31 - 2**19, 2**20), (2**32 - 2**19, 2**20),
             (THREEFRY_WIDE - 2**19, 2**19))
    wide_err = 0.0
    for kind in ("bits", "normal"):
        if kind == "bits":
            out = tk.threefry_bits_cuda(key, (THREEFRY_WIDE,), dev).view(torch.int32)
        else:
            out = tk.threefry_normal_cuda(key, (THREEFRY_WIDE,), dev)
        for start, count in spans:
            words = tr.bits_plain(key, start, count, dev)
            piece = out[start : start + count]
            if kind == "bits":
                if not torch.equal(piece, tr.as_uint32(words).view(torch.int32)):
                    fail(f"threefry bits past 2^31: words [{start}, {start + count}) differ")
            else:
                err = float((piece - tr.normal_of_bits(words)).abs().max())
                wide_err = max(wide_err, err)
                if not err <= NORMAL_ATOL:
                    fail(f"threefry normals past 2^31: [{start}, +{count}) max abs {err}")
        del out
        torch.cuda.empty_cache()
    print(
        f"threefry kernel vs plain: {cases} draws (shapes"
        f" {', '.join(name for name, _ in THREEFRY_SHAPES)}; {len(threefry_keys(tr))} keys),"
        f" words equal; normals max abs {worst:.3g} (limit {NORMAL_ATOL}),"
        f" {exact / total:.4%} equal; a draw of {THREEFRY_WIDE:,} words and normals (past 2^32):"
        f" words equal, normals max abs {wide_err:.3g}; launches {grown}"
    )
    return max(worst, wide_err, phase_threefry_segments(torch, tr, tk, kl))


def threefry_segment_cases(tr, tk):
    """(name, keys, counts, scales) of the segmented kernel's checks."""
    keys = threefry_keys(tr)
    fields = [tr.draw_key(seed, 0) for seed in (3, 99, 2**31 - 2, 12345)]
    stds = [0.5, 0.0, -1.25, 0.3]
    many = tr.split(tr.prng_key(7), tk.MAX_SEGMENTS + 1)
    n = B * C * S**3
    return (
        ("one segment", [keys["PRNGKey(42)"]], [1_000_003], None),
        (f"BiasField {B} x 216", fields, [216] * B, stds),
        (f"BiasField {B} x 576", fields, [576] * B, stds),
        ("1, 3, 5 (unaligned)", list(keys.values())[:3], [1, 3, 5], [2.0, -1.0, 0.0]),
        (
            f"cap + 1 = {tk.MAX_SEGMENTS + 1}", many,
            [(i * 37) % 101 + 1 for i in range(len(many))],
            [float(i - 24) / 8 for i in range(len(many))],
        ),
        (f"Rician pair {B} x {C} x {S}^3", [tr.draw_key(77, 1), tr.draw_key(77, 2)], [n, n], None),
    )


def phase_threefry_segments(torch, tr, tk, kl):
    """The segmented kernel against separate draws: its words equal to the
    plain version's; its normals equal to the kernel's separate draws times
    their scales (a torch multiply), and within NORMAL_ATOL of the plain
    version; one launch a MAX_SEGMENTS segments."""
    dev = torch.device(DEVICE)
    worst, lines = 0.0, []
    for name, keys, counts, scales in threefry_segment_cases(tr, tk):
        before = {k: kl.LAUNCHES[k] for k in ("threefry_bits", "threefry_normal")}
        words = tk.threefry_segments_cuda(keys, counts, None, dev, normal=False)
        got = tk.threefry_segments_cuda(keys, counts, scales, dev)
        grown = {k: kl.LAUNCHES[k] - before[k] for k in before}
        expect = -(-len(keys) // tk.MAX_SEGMENTS)
        if grown != {"threefry_bits": expect, "threefry_normal": expect}:
            fail(f"threefry segments {name}: launches {grown}, expected {expect} of each")
        offset, err, separate_equal = 0, 0.0, True
        for i, (key, count) in enumerate(zip(keys, counts)):
            piece = slice(offset, offset + count)
            plain_words = tr.bits_plain(key, 0, count, dev)
            if not torch.equal(words[piece], tr.as_uint32(plain_words).view(torch.int32)):
                fail(f"threefry segments {name}: segment {i}'s words differ")
            separate = tk.threefry_normal_cuda(key, (count,), dev)
            plain = tr.normal_of_bits(plain_words)
            if scales is not None:
                scale = torch.tensor(scales[i], dtype=torch.float32, device=dev)
                separate, plain = separate * scale, plain * scale
            separate_equal &= torch.equal(got[piece], separate)
            err = max(err, float((got[piece] - plain).abs().max()))
            offset += count
            del plain_words, separate, plain
        if not separate_equal:
            fail(f"threefry segments {name}: normals differ from the separate draws")
        if not err <= NORMAL_ATOL:
            fail(f"threefry segments {name}: normals max abs {err} from the plain version")
        worst = max(worst, err)
        lines.append(f"{name} ({len(keys)} segment{'s' * (len(keys) > 1)}, {expect}"
                     f" launch{'es' * (expect > 1)}):"
                     f" max abs {err:.3g}")
        del words, got
        torch.cuda.empty_cache()
    print(
        "threefry segments vs separate draws: words equal to the plain version's, normals"
        f" equal to the kernel's separate draws times their scales; {'; '.join(lines)}"
    )
    return worst


def phase_threefry_timing(torch, config, tr, tk):
    """The threefry kernel at the headline's noise (B x C x S^3 normals):
    kernel against plain, then kernel against torch.randn (Philox: another
    function, printed for scale only)."""
    dev = torch.device(DEVICE)
    key = tr.draw_key(2024, 1)
    shape = (B, C, S, S, S)
    n = math.prod(shape)
    got = tk.threefry_normal_cuda(key, shape, dev)
    want = tr.normal_of_bits(tr.bits_plain(key, 0, n, dev)).reshape(shape)
    diff = (got - want).abs()
    err, share = float(diff.max()), float((diff == 0).float().mean())
    del got, want, diff
    if not err <= NORMAL_ATOL:
        fail(f"threefry normals at the headline's shape: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: tk.threefry_normal_cuda(key, shape, dev),
        lambda: tr.normal_of_bits(tr.bits_plain(key, 0, n, dev)),
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    randn_order, _, randn_ms = time_pair(
        torch, lambda: tk.threefry_normal_cuda(key, shape, dev),
        lambda: torch.randn(shape, generator=gen, device=dev), plain_reps=20,
    )
    # reads nothing, writes 4 bytes an element
    work = bound(4 * n, n * THREEFRY_OPS)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    functions = sass_of(config, tk.THREEFRY.path())
    if THREEFRY_SASS_KERNEL not in functions:
        fail(f"no {THREEFRY_SASS_KERNEL} in the threefry library's SASS")
    sass = loop_profile(functions[THREEFRY_SASS_KERNEL])
    issue_ms, alu_ms = issue_limits(sass, n, clock_mhz)
    print(
        f"threefry normals B={B} x {S}^3: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k,"
        f" p: {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}, {share:.4%} equal;"
        f" torch.randn (Philox, not the same function) {randn_ms:.3f} ms (k, r, k, r:"
        f" {', '.join(f'{t:.3f}' for t in randn_order)}); bound {work[0]:.3f} ms ({work[1]},"
        f" {THREEFRY_OPS} operations an element); SASS of the loop {sass['per_element']:g}"
        f" instructions an element, {sass['hot_per_element']:g} on its hot path"
        f" ({', '.join(f'{k} {v:g}' for k, v in sass['pipes'].items())}):"
        f" issue limit {issue_ms:.3f} ms, ALU pipe limit {alu_ms:.3f} ms at the maximum SM"
        f" clock, {clock_mhz:g} MHz (a model, not measured); opcodes {sass['ops']}"
    )
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "randn_ms": randn_ms,
    }


def phase_small_config(torch, tio, number):
    """Config 1 or 2 on a small batch: card against the CPU path."""
    pipeline = config1_pipeline if number == 1 else config2_pipeline
    cpu, gpu = run_on_both(
        tio, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 20 + number),
        pipeline, 30 + number,
    )
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    names = [h.name for h in gpu.applied_transforms]
    print(
        f"small config {number} (2 x 40x44x48, history {names}) cuda vs cpu: max abs"
        f" {err:.3g} (limit {SLICE_ATOL})"
    )
    if not err <= SLICE_ATOL:
        fail(f"small config {number} differs from the CPU path by {err}")


def phase_config(torch, tio, kl, number, profile: str | None):
    """config1-flip-noise-rescale (B=4 x 1 x 181x217x181, fused) or
    config2-blur-bias-gamma (B=4 x 1 x 256^3, unfused)."""
    dev = torch.device(DEVICE)
    if number == 1:
        name, shape, pipeline = "config1-flip-noise-rescale", CONFIG1_SHAPE, config1_pipeline(tio)
        want_names = [["Flip", "Noise", "Normalize"], ["Noise", "Normalize"]]
    else:
        name, shape, pipeline = "config2-blur-bias-gamma", (S, S, S), config2_pipeline(tio)
        want_names = [["Blur", "BiasField", "Gamma"]]
    batch = make_batch(tio, torch, B, shape, dev, number)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(
        torch, kl, pipeline, batch, ("threefry_normal",)
    )
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES[name] for d in draws):
        fail(f"{name} threefry launches per call {draws}, expected {THREEFRY_LAUNCHES[name]}")
    data = out.t1.data
    if tuple(data.shape) != (B, C, *shape) or data.device.type != DEVICE:
        fail(f"{name} output {tuple(data.shape)} on {data.device}")
    if not bool(torch.isfinite(data).all()):
        fail(f"{name} output has non-finite values")
    if any(h not in want_names for h in histories):
        fail(f"{name} histories {histories}")
    if number == 1:
        low, high = float(data.min()), float(data.max())
        if low < 0.0 or high > 1.0:
            fail(f"{name} output spans [{low}, {high}], not [0, 1]")
        in_range = out.applied_transforms[-1].params["in_ranges"]["t1"]
        extra = f"; output in [{low:.3g}, {high:.3g}], the input range {in_range}"
    else:
        extra = ""
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"{name}: {vps:.2f} volumes/s over {TIMED} timed calls of B={B} x"
        f" {'x'.join(map(str, shape))} (median call {statistics.median(timed) * 1e3:.1f} ms,"
        f" calls {[round(t * 1e3, 1) for t in times]} ms, warm-up first); threefry launches"
        f" per call {[c['threefry_normal'] for c in per_call]}; histories"
        f" {[len(h) for h in histories]} transforms; peak allocated {peak / 2**30:.2f} GiB{extra}"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, name)
    return totals


def config3_pipeline(tio):
    """BASELINE.json config 3 (benchmarks/suite.py:169-194)."""
    return tio.Compose(
        [tio.Affine(scales=(0.9, 1.1), degrees=(-10.0, 10.0)), tio.Resample(target=1.0)],
        copy=False,
    )


def config3_call(tio):
    """One config 3 call as the suite makes it: the pipeline works in
    place (copy=False) and Resample changes the shape, so each call starts
    from a copy of the batch (metadata only: the copy shares the
    tensors)."""
    pipeline = config3_pipeline(tio)
    return lambda batch: pipeline(copy.deepcopy(batch))


def config4_forward(tio):
    """BASELINE.json config 4's forward (benchmarks/suite.py:197-229)."""
    return tio.Compose([tio.ElasticDeformation(max_displacement=7.5)])


def config4_call(tio):
    """One config 4 call: the elastic forward, then its inverse built from
    the recorded history (a Compose of the inverse)."""
    forward = config4_forward(tio)
    return lambda batch: forward(batch).apply_inverse_transform()


def make_suite_batch(tio, torch, b, images, shape, spacing, device, seed):
    """B subjects as benchmarks/suite.py:51-74 builds them: a ScalarImage
    of uniform [0, 1) values for each name -> channels of ``images`` and
    an int32 ``seg`` (suite_labels), all at ``spacing`` mm."""
    affine = [[spacing[0], 0, 0, 0], [0, spacing[1], 0, 0], [0, 0, spacing[2], 0], [0, 0, 0, 1]]
    gen = torch.Generator(device=device).manual_seed(seed)
    data = {
        name: torch.rand((b, c, *shape), generator=gen, device=device)
        for name, c in images.items()
    }
    seg = suite_labels(torch, shape, device)
    subjects = [
        tio.Subject(
            **{name: tio.ScalarImage(d[i], affine=affine) for name, d in data.items()},
            seg=tio.LabelMap(seg.clone(), affine=affine),
        )
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def target_grids(rs, params, affine, b, device):
    """(maps, fields, output shape) of a recorded Resample draw (no
    geometry, a target space) from input ``affine``."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid, _deserialize_space

    shape, target_affine = _deserialize_space(params["target"])
    matrix, _ = _build_grid(
        input_affine=affine, output_shape=shape, output_affine=target_affine,
        affine_matrix=None, control_points=None, max_displacement=None, affine_first=True,
    )
    return (*rs._marshal_maps([matrix] * b, [None] * b, device), shape)


def inverse_grids(np, rs, tio, params, affine, shape, device):
    """(maps, fields) of the inverse of a recorded per-element Spatial
    draw, as its inverse builds them."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    geometry = object.__new__(tio.Spatial).inverse(params).per_sample
    grids = [
        _build_grid(
            input_affine=affine, output_shape=shape, output_affine=affine,
            affine_matrix=geometry.affines[i], control_points=geometry.control_points[i],
            max_displacement=geometry.max_displacements[i],
            affine_first=not params["affine_first"],
        )
        for i in range(len(geometry))
    ]
    return rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], device)


def nearest_ties(torch, rs, maps, fields, out_shape, earlier=None):
    """(B, 1, *out) True where a nearest-neighbour label of this step may
    legitimately differ between two devices: its own coordinate lies
    within TIE_BAND of a .5 tie, or it reads a voxel that was a tie of the
    step before (``earlier``)."""
    ties = ~coord_tie_mask(torch, rs, maps, fields, out_shape)
    if earlier is not None:
        fill, _ = rs._fill_bc(0.0, maps.shape[0], 1, maps.device)
        read = rs.resample_plain(
            earlier.float(), maps, fields, fill, out_shape, "nearest", False
        )
        ties |= read > 0
    return ties


def check_path_launches(name, per_call):
    """The resample kernel RESAMPLE_LAUNCHES[name] times a call of the
    path, the threefry kernel THREEFRY_LAUNCHES[name] times."""
    resample = [c["resample"] for c in per_call]
    draws = [c["threefry_normal"] for c in per_call]
    if any(n != RESAMPLE_LAUNCHES[name] for n in resample) or any(
        n != THREEFRY_LAUNCHES[name] for n in draws
    ):
        fail(
            f"{name}: resample launches per call {resample} (expected"
            f" {RESAMPLE_LAUNCHES[name]}), threefry {draws} (expected"
            f" {THREEFRY_LAUNCHES[name]})"
        )
    return resample, draws


def phase_small_config3(torch, np, tio, rs, kl):
    """Config 3 on a small batch: card against the CPU path; labels
    equal off near ties of the Affine step (Resample's k coordinates land
    on .25 and .75)."""
    shape = (40, 44, 24)
    before = kl.LAUNCHES["resample"]
    cpu, gpu = run_on_both(
        tio,
        lambda: make_suite_batch(
            tio, torch, 2, {"ch": CONFIG3_C}, shape, CONFIG3_SPACING, "cpu", 23
        ),
        config3_call, 33,
    )
    launched = kl.LAUNCHES["resample"] - before
    out_shape = (40, 44, 48)
    if tuple(gpu.ch.data.shape) != (2, CONFIG3_C, *out_shape) or launched != 4:
        fail(f"small config 3: ch {tuple(gpu.ch.data.shape)}, {launched} resample launches")
    err = float((gpu.ch.data.cpu() - cpu.ch.data).abs().max())
    affine = tio.AffineMatrix(np.diag([*CONFIG3_SPACING, 1.0]))
    history = [h.params for h in cpu.applied_transforms]
    maps, fields = slice_grids(np, rs, history[0], affine, shape, "cpu")
    ties = nearest_ties(torch, rs, maps, fields, shape)
    maps, fields, _ = target_grids(rs, history[1], affine, 2, "cpu")
    ties = nearest_ties(torch, rs, maps, fields, out_shape, earlier=ties)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"small config 3: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small config 3 (2 x ({CONFIG3_C} + 1) x 40x44x24 at 1x1x2 mm -> 40x44x48)"
        f" cuda vs cpu: ch max abs {err:.3g} (limit {SLICE_ATOL}); seg voxels differing"
        f" {int((got != want).sum())}, off near ties {off}; resample launches {launched}"
    )
    if not err <= SLICE_ATOL or off:
        fail("small config 3 differs from the CPU path")


def phase_small_config4(torch, np, tio, rs, kl):
    """Config 4 on a small batch: forward and inverse, card against the
    CPU path; labels equal off near ties of either step."""
    shape = (40, 44, 48)
    before = kl.LAUNCHES["resample"]
    torch.exp(torch.zeros(1 << 20))  # warm the CPU thread pool (run_on_both)
    outs = []
    with warnings.catch_warnings():
        # a 7.5 mm displacement on a 40 mm volume may fold
        warnings.filterwarnings("ignore", "The maximum displacement")
        for device in ("cpu", DEVICE):
            batch = make_suite_batch(tio, torch, 2, {"t1": 1}, shape, (1, 1, 1), "cpu", 24)
            tio.seed(34)
            forward = config4_forward(tio)(batch.to(device))
            outs.append((forward, forward.apply_inverse_transform()))
        launched = kl.LAUNCHES["resample"] - before
        (cpu_fwd, cpu), (gpu_fwd, gpu) = outs
        params = cpu_fwd.applied_transforms[0].params
        if params != gpu_fwd.applied_transforms[0].params or launched != 4:
            fail(f"small config 4: params differ or {launched} resample launches")
        if gpu.applied_transforms or tuple(gpu.t1.data.shape) != (2, 1, *shape):
            fail(f"small config 4: history {gpu.applied_transforms}, t1 {tuple(gpu.t1.data.shape)}")
        err = max(
            float((g.t1.data.cpu() - c.t1.data).abs().max())
            for g, c in ((gpu_fwd, cpu_fwd), (gpu, cpu))
        )
        affine = tio.AffineMatrix(np.eye(4))
        maps, fields = slice_grids(np, rs, params, affine, shape, "cpu")
        ties = nearest_ties(torch, rs, maps, fields, shape)
        maps, fields = inverse_grids(np, rs, tio, params, affine, shape, "cpu")
        ties = nearest_ties(torch, rs, maps, fields, shape, earlier=ties)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"small config 4: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small config 4 (2 x (1 + 1) x 40x44x48, elastic and its inverse) cuda vs cpu:"
        f" t1 max abs {err:.3g} (limit {SLICE_ATOL}); seg voxels differing"
        f" {int((got != want).sum())}, off near ties {off}; resample launches {launched}"
    )
    if not err <= SLICE_ATOL or off:
        fail("small config 4 differs from the CPU path")


def phase_config3(torch, tio, kl, profile: str | None):
    """config3-affine-resample: B=4 subjects of a 4-channel 192x192x96
    ``ch`` and a ``seg`` at 1x1x2 mm, resampled to 1 mm (192^3)."""
    name = "config3-affine-resample"
    dev = torch.device(DEVICE)
    batch = make_suite_batch(
        tio, torch, B, {"ch": CONFIG3_C}, CONFIG3_SHAPE, CONFIG3_SPACING, dev, 3
    )
    call = config3_call(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(torch, kl, call, batch, ("resample",))
    resample, draws = check_path_launches(name, per_call)
    ch, seg = out.ch.data, out.seg.data
    if tuple(ch.shape) != (B, CONFIG3_C, *CONFIG3_OUT) or ch.device.type != DEVICE:
        fail(f"{name} ch output {tuple(ch.shape)} on {ch.device}")
    if tuple(seg.shape) != (B, 1, *CONFIG3_OUT) or seg.dtype != torch.int32:
        fail(f"{name} seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(ch).all()):
        fail(f"{name} ch output has non-finite values")
    values = set(torch.unique(seg).tolist())
    if not values <= {0, 1, 2, 3} or len(values) < 4:
        fail(f"{name} seg labels {sorted(values)}, expected {{0, 1, 2, 3}}")
    spacing = out.ch.affines[0].spacing
    if any(h != ["Affine", "Resample"] for h in histories) or spacing != (1.0, 1.0, 1.0):
        fail(f"{name} histories {histories}, output spacing {spacing}")
    if tuple(batch.ch.data.shape) != (B, CONFIG3_C, *CONFIG3_SHAPE):
        fail(f"{name} changed its input batch")
    timed = times[WARMUP:]
    print(
        f"{name}: {B * TIMED / sum(timed):.2f} subjects/s over {TIMED} timed calls of"
        f" B={B} x ({CONFIG3_C} + 1) x {'x'.join(map(str, CONFIG3_SHAPE))} at 1x1x2 mm ->"
        f" {'x'.join(map(str, CONFIG3_OUT))} at 1 mm (median call"
        f" {statistics.median(timed) * 1e3:.1f} ms, calls {[round(t * 1e3, 1) for t in times]}"
        f" ms, warm-up first); resample launches per call {resample}; threefry {draws};"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, call, batch, profile, name)
    return totals, batch


def phase_config4(torch, tio, kl, profile: str | None):
    """config4-elastic-inverse: ElasticDeformation and its inverse on B=4
    subjects of a 256^3 ``t1`` and ``seg``; the interior label
    consistency of the round trip, as benchmarks/suite.py:206-209
    computes it."""
    name = "config4-elastic-inverse"
    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_suite_batch(tio, torch, B, {"t1": 1}, shape, (1, 1, 1), dev, 4)
    seg_in = batch.seg.data.clone()
    call = config4_call(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(torch, kl, call, batch, ("resample",))
    resample, draws = check_path_launches(name, per_call)
    t1, seg = out.t1.data, out.seg.data
    if tuple(t1.shape) != (B, 1, *shape) or t1.device.type != DEVICE:
        fail(f"{name} t1 output {tuple(t1.shape)} on {t1.device}")
    if tuple(seg.shape) != (B, 1, *shape) or seg.dtype != torch.int32:
        fail(f"{name} seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(t1).all()) or any(histories):
        fail(f"{name}: non-finite t1 or histories left {histories}")
    interior = (slice(None), slice(None), *(slice(CONFIG4_MARGIN, -CONFIG4_MARGIN),) * 3)
    consistency = float((seg[interior] == seg_in[interior]).float().mean())
    # the forward alone: the inverse must bring the labels back closer
    tio.seed(0)
    warped = config4_forward(tio)(batch).seg.data
    forward = float((warped[interior] == seg_in[interior]).float().mean())
    del warped
    if not consistency > forward:
        fail(f"{name}: interior label consistency {consistency}, the forward alone {forward}")
    timed = times[WARMUP:]
    print(
        f"{name}: {B * TIMED / sum(timed):.2f} subjects/s over {TIMED} timed calls of"
        f" B={B} x (1 + 1) x {S}^3, forward and inverse (median call"
        f" {statistics.median(timed) * 1e3:.1f} ms, calls {[round(t * 1e3, 1) for t in times]}"
        f" ms, warm-up first); resample launches per call {resample}; threefry {draws};"
        f" interior label consistency (margin {CONFIG4_MARGIN}) {consistency:.6f}, the"
        f" forward alone {forward:.6f}; peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, call, batch, profile, name)
    return totals


def phase_diagonal_timing(torch, np, tio, rs, rk, batch):
    """The resample kernel on config 3's Resample step (a diagonal map,
    2 mm -> 1 mm along k: k_in = k_out / 2 - 0.25) against the plain
    resample, and against its one-call library equivalent,
    ``F.interpolate(trilinear, scale_factor=(1, 1, 2), align_corners=
    False)``: the same map, which clamps at the border where the kernel
    fills, so they are compared off the first and last k slice."""
    dev = torch.device(DEVICE)
    params = tio.Resample(target=1.0).make_params(batch)
    maps, fields, out_shape = target_grids(rs, params, batch.ch.affines[0], B, dev)
    vol = batch.ch.data.contiguous()
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, CONFIG3_C, dev)
    args = (vol, maps, fields, fill, out_shape, "linear", apply_fill)
    got = rk.resample_cuda(*args)
    err = float((got - rs.resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"resample kernel vs plain on config 3's diagonal map: max abs {err}")

    def library():
        return torch.nn.functional.interpolate(
            vol, scale_factor=(1.0, 1.0, 2.0), mode="trilinear", align_corners=False
        )

    lib_err = float((library()[..., 1:-1] - got[..., 1:-1]).abs().max())
    del got
    if not lib_err <= KERNEL_ATOL:
        fail(f"F.interpolate differs from the kernel off the k borders by {lib_err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), lambda: rs.resample_plain(*args)
    )
    lib_order, _, library_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), library, plain_reps=20
    )
    voxels = B * math.prod(out_shape)
    # as the resample's bound: the map, 8 corner weights a voxel, 8
    # products and 7 sums a voxel and channel
    work = bound(
        nbytes(vol, maps, fill) + voxels * CONFIG3_C * 4,
        voxels * (point_flops(fields) + 16) + voxels * CONFIG3_C * 15,
    )
    print(
        f"resample on config 3's diagonal map, B={B} x {CONFIG3_C} x"
        f" {'x'.join(map(str, CONFIG3_SHAPE))} -> {'x'.join(map(str, out_shape))} linear:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}; F.interpolate"
        f" {library_ms:.3f} ms (k, l, k, l: {', '.join(f'{t:.3f}' for t in lib_order)}),"
        f" max abs vs the kernel off the first and last k slice {lib_err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "library_ms": library_ms,
    }


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
    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.ops import bspline as bs
    from torchio_tpu_torch.ops import bspline_kernel as bk
    from torchio_tpu_torch.ops import kernel_lib as kl
    from torchio_tpu_torch.ops import resample_kernel as rk
    from torchio_tpu_torch.ops import threefry_kernel as tk

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
    phase_threefry_kernel(torch, tr, tk, kl)
    phase_small_slice(torch, tio)
    phase_small_labelled(torch, np, tio, rs)
    phase_small_kspace(torch, tio, kl)
    phase_small_config(torch, tio, 1)
    phase_small_config(torch, tio, 2)
    phase_small_config3(torch, np, tio, rs, kl)
    phase_small_config4(torch, np, tio, rs, kl)
    phase_host_subject(torch, np, tio, kl)
    headline_launches = phase_slice(torch, tio, kl, args.profile)
    brats_launches, brats_batch = phase_brats(torch, tio, kl, args.profile)
    kspace_launches = phase_kspace(torch, tio, kl, args.profile)
    config1_launches = phase_config(torch, tio, kl, 1, args.profile)
    config2_launches = phase_config(torch, tio, kl, 2, args.profile)
    config3_launches, config3_batch = phase_config3(torch, tio, kl, args.profile)
    config4_launches = phase_config4(torch, tio, kl, args.profile)
    timings = {"resample": phase_kernel_timing(torch, np, tio, rs, rk)}
    timings.update(phase_brats_timing(torch, np, tio, rs, rk, bs, bk, brats_batch))
    del brats_batch
    dense, dense_launches = phase_dense_entry(torch, np, tio, rs, rk, bs, bk, kl)
    timings.update(dense)
    timings["threefry_normal"] = phase_threefry_timing(torch, config, tr, tk)
    timings["resample_diagonal"] = phase_diagonal_timing(torch, np, tio, rs, rk, config3_batch)
    del config3_batch
    window = "torchio_tpu/ops/window_resample.py:335"
    launches = {
        "resample": headline_launches["resample"],
        "label_vote": brats_launches["label_vote"],
        "bspline_prefilter": brats_launches["bspline_prefilter"],
        "bspline_resample": brats_launches["bspline_resample"],
        "resample_coords": kspace_launches["resample_coords"],
        "bspline_coords": dense_launches["bspline_coords"],
        "threefry_normal": headline_launches["threefry_normal"],
        "resample_diagonal": config3_launches["resample"],
    }
    resample_paths = {
        "headline": headline_launches["resample"],
        "config3-affine-resample": config3_launches["resample"],
        "config4-elastic-inverse": config4_launches["resample"],
    }
    threefry_paths = {
        "headline": headline_launches["threefry_normal"],
        "brats-label-bspline": brats_launches["threefry_normal"],
        "config1-flip-noise-rescale": config1_launches["threefry_normal"],
        "config2-blur-bias-gamma": config2_launches["threefry_normal"],
        "config3-affine-resample": config3_launches["threefry_normal"],
        "config4-elastic-inverse": config4_launches["threefry_normal"],
    }
    kernels = [
        {
            "name": "resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": ["torchio_tpu/ops/shear_resample.py:81", window],
            "note": f"launches on the headline; per path: {resample_paths}",
            "path": "headline",
        },
        {
            "name": "label_vote",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/label_resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": [window],
            "path": "brats-label-bspline",
        },
        {
            "name": "bspline_prefilter",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": "torchio_tpu/ops/bspline.py:81",
            "note": "XLA lax.scan prefilter in the JAX package; no Pallas counterpart",
            "path": "brats-label-bspline",
        },
        {
            "name": "bspline_resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "path": "brats-label-bspline",
        },
        {
            "name": "resample_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/pallas_resample.py:117",
            "path": "kspace-motion-ghosting",
        },
        {
            "name": "bspline_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "note": "dense-coordinate mode; the JAX package's dense bspline_resample"
            " (torchio_tpu/ops/bspline.py:215) is an XLA gather",
            "path": "dense-entry",
        },
        {
            "name": "threefry_normal",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/threefry.cu",
            "replaces": "torchio_tpu/transforms/fuse.py:197",
            "also_replaces": [
                "torchio_tpu/transforms/fuse.py:195",
                "torchio_tpu/transforms/intensity/noise.py:121",
                "torchio_tpu/transforms/intensity/bias_field.py:42",
                "torchio_tpu/transforms/intensity/bias_field.py:65",
            ],
            "note": "jax.random.normal (threefry2x32, Giles' erf_inv) is XLA in the JAX"
            " package, no Pallas kernel; launches on the headline, per path:"
            f" {threefry_paths}; torch.randn (Philox, not the same function)"
            f" {timings['threefry_normal']['randn_ms']:.3f} ms",
            "path": "headline",
        },
        {
            "name": "resample_diagonal",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/resample.py:298",
            "note": "the resample kernel (tio_resample) on config 3's diagonal 2 mm ->"
            " 1 mm map; the JAX package computes a diagonal map with XLA separable"
            " matmuls (_resample_element_separable), no Pallas kernel; launches: every"
            " resample launch of the config 3 path, 4 a call (Affine and Resample, ch"
            " and seg); library: F.interpolate(trilinear, align_corners=False)",
            "path": "config3-affine-resample",
        },
    ]
    for entry in kernels:
        t = timings[entry["name"]]
        bound_ms, bound_by = t["bound"]
        entry.update(
            launches=launches[entry["name"]],
            max_abs_err=t["max_abs_err"],
            ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=bound_ms,
            bound_by=bound_by,
            roofline=bound_ms / t["ms"],
            library_ms=t.get("library_ms"),
        )
        if "pass_ms" in t:
            entry["pass_ms"] = t["pass_ms"]
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
