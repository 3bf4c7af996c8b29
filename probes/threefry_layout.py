#!/usr/bin/env python3
"""Probe: the threefry kernel's forms at the headline's noise.

Builds ``probes/threefry_layout.cu`` (``csrc/threefry.cu``, the kernel it
replaced, and the segmented kernel in other forms) and, on B=4 x 1 x
256^3 normals (the headline's Noise draw) under one key,

- checks every form's words and normals equal to the package kernel's,
  and the package kernel's equal to the plain version on the card (words)
  and within 1e-6 (normals); every segmented form also on BiasField's
  B=4 fields of 216 normals, each times a scale, and on segments of 1, 3
  and 5 normals at unaligned offsets;
- times every form twice in turns (the order, then the order reversed)
  with CUDA events, 20 launches a time;
- dumps the library's SASS (``cuobjdump -sass``) to
  ``chiprun_out/threefry_layout.sass`` and counts, for each form's
  normal kernel (32-bit index), the instructions of its main loop by
  opcode and pipe, per element; with the maximum SM clock these give the
  issue limit (instructions x elements / (132 SMs x 4 schedulers x 32
  lanes x clock)) and the ALU pipe's limit (ALU instructions over 16
  lanes), models, not measurements;
- prints each kernel's ptxas registers and spills.

The forms (``FORMS``; the first is the package's kernel):

- ``replaced``: the replaced kernel: one element a thread, selects in
  erf_inv, every integer add on the ALU pipe;
- ``alu``: the segmented kernel, four elements a thread, a branch an
  element on erf_inv's tail, every integer add written as an add;
- ``select``: ``alu`` with the replaced kernel's selects; ``single``: ``alu`` with one
  element a thread;
- ``imad_round``, ``imad_inject``, ``imad_both``: ``alu`` with a round's
  x0 += x1, the key injections, or both as multiply-adds by a runtime 1;
- ``imad_round_hi``: ``imad_round`` with the uniform's mantissa as a high
  product plus the exponent;
- ``wide``, ``wide_imad_round``: ``alu`` and ``imad_round`` with each
  rotate as the two halves of a 64-bit product by 2^r;
- ``imad_both_once``: ``imad_both`` with one branch on the tail for a
  thread's four elements; ``imad_fused``: ``imad_both`` with x0's
  injection folded into the next round's add (IADD3);
  ``imad_both_u24``: ``imad_both`` with the uniform as 2m - 2 + lo, which
  is the package's form built from the probe's template (its time beside
  ``package`` shows the spread of the measurement);
  ``imad_fused_u24_once``: all three steps.

Needs a CUDA GPU, nvcc and cuobjdump; run from the repository's root:

    python3 probes/threefry_layout.py

``python3 probes/threefry_layout.py --sass FILE --clock-mhz MHZ`` only
counts a saved dump (no GPU).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (name, template arguments of probe::Probe); the
#: order of probe_threefry's switch, the package's kernel first
FORMS = (
    ("package", None),
    ("alu", (4, 0, 0, 0, 0, 0, 1)),
    ("select", (4, 0, 0, 0, 0, 0, 0)),
    ("single", (1, 0, 0, 0, 0, 0, 1)),
    ("imad_round", (4, 1, 0, 0, 0, 0, 1)),
    ("imad_inject", (4, 0, 1, 0, 0, 0, 1)),
    ("imad_both", (4, 1, 1, 0, 0, 0, 1)),
    ("imad_round_hi", (4, 1, 0, 0, 0, 1, 1)),
    ("wide", (4, 0, 0, 0, 1, 0, 1)),
    ("wide_imad_round", (4, 1, 0, 0, 1, 0, 1)),
    ("imad_both_once", (4, 1, 1, 0, 0, 0, 2)),
    ("imad_both_u24", (4, 1, 1, 0, 0, 2, 1)),
    ("imad_fused", (4, 1, 1, 1, 0, 0, 1)),
    ("imad_fused_u24_once", (4, 1, 1, 1, 0, 2, 2)),
)
#: the replaced kernel, replaced::threefry_kernel<unsigned int, true>
REPLACED_KERNEL = "_ZN8replaced15threefry_kernelIjLb1EEEvPvNS_8ScheduleET_"


def mangled(args) -> str:
    """The normal kernel (32-bit index) of a form: the package's
    threefry::segments_kernel<true, unsigned int>, or
    probe::segments_kernel<probe::Probe<args...>, true, unsigned int>."""
    if args is None:
        return cs.THREEFRY_SASS_KERNEL
    vec, *flags, uniform, tail = args
    form = f"INS_5ProbeILi{vec}E{''.join(f'Lb{f}E' for f in flags)}Li{uniform}ELi{tail}EEE"
    return f"_ZN5probe15segments_kernel{form}Lb1EjEEvPvN8threefry5TableE"


def loop_counts(text: str) -> dict[str, dict]:
    """For each form's normal kernel (32-bit index): its main loop's
    instructions per element, by pipe and by opcode."""
    functions = cs.sass_functions(text)
    counts = {}
    for name, args in (*FORMS, ("replaced", REPLACED_KERNEL)):
        code = functions.get(REPLACED_KERNEL if name == "replaced" else mangled(args))
        if code is not None:
            counts[name] = cs.loop_profile(code)
    return counts


def print_counts(counts: dict, n: int, clock_mhz: float) -> None:
    for name, c in counts.items():
        issue_ms, alu_ms = cs.issue_limits(c, n, clock_mhz)
        top = ", ".join(f"{k} {v:g}" for k, v in list(c["ops"].items())[:14])
        pipes = ", ".join(f"{k} {v:g}" for k, v in c["pipes"].items())
        print(f"  sass {name}: {c['per_element']:g} instructions an element in the loop,"
              f" {c['hot_per_element']:g} on its hot path ({pipes});"
              f" issue limit {issue_ms:.3f} ms, ALU limit {alu_ms:.3f} ms at the maximum SM"
              f" clock, {clock_mhz:g} MHz; {top}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", help="count a saved SASS dump and stop")
    parser.add_argument("--clock-mhz", type=float, default=1980.0)
    args = parser.parse_args()
    n = 4 * 256**3
    if args.sass:
        print_counts(loop_counts(Path(args.sass).read_text()), n, args.clock_mhz)
        return

    import torch

    from resample_layout import ptxas_report
    from torchio_tpu_torch import config
    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.ops import kernel_lib as kl
    from torchio_tpu_torch.ops import threefry_kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    clock_mhz = float(re.findall(r"([\d.]+) MHz", smi)[-1])

    lib_path = ROOT / "probes" / "_build" / "libthreefry_layout.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [config.nvcc(), *kl.FLAGS, "-o", str(lib_path), str(ROOT / "probes" / "threefry_layout.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    tk.THREEFRY.build()
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(log)
    for line in ptxas_report(log):
        print(f"  ptxas {line}")
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_threefry.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.probe_threefry_replaced.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.probe_threefry, lib.probe_threefry_replaced):
        fn.restype = ctypes.c_int
    cuobjdump = Path(config.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    dump = ROOT / "chiprun_out" / "threefry_layout.sass"
    dump.parent.mkdir(parents=True, exist_ok=True)
    dump.write_text(sass)

    dev = torch.device("cuda")
    st = kl.stream(dev)

    def draw(form, keys, counts, scales, normal=True, shift=0):
        total = sum(counts)
        buf = torch.empty(total + 4, dtype=torch.float32 if normal else torch.int32, device=dev)
        out = buf[shift : shift + total]
        if form == "replaced":
            (k0, k1), = keys
            err = lib.probe_threefry_replaced(out.data_ptr(), k0, k1, total, int(normal), st)
        else:
            index = [f[0] for f in FORMS].index(form)
            err = 0
            for segments in tk.segment_plan(keys, counts, scales):
                rows = tk._rows(segments)
                err = err or lib.probe_threefry(index, out.data_ptr(), ctypes.addressof(rows),
                                                len(segments), int(normal), st)
        if err:
            raise SystemExit(f"{form} launch failed: {err}")
        return out

    key = tr.draw_key(2024, 1)
    words = tr.as_uint32(tr.bits_plain(key, 0, n, dev)).view(torch.int32)
    plain = tr.normal_of_bits(tr.bits_plain(key, 0, n, dev))
    want_words = draw("package", [key], [n], None, normal=False)
    want = draw("package", [key], [n], None)
    torch.cuda.synchronize()
    err = float((want - plain).abs().max())
    print(f"package vs plain at B=4 x 1 x 256^3: words equal {torch.equal(want_words, words)},"
          f" normals max abs {err:.3g}, {float((want == plain).float().mean()):.4%} equal")
    if not torch.equal(want_words, words) or not err <= cs.NORMAL_ATOL:
        raise SystemExit("the package kernel differs from the plain version")
    del words, plain
    names = ["replaced"] + [f[0] for f in FORMS]
    bias_keys = [tr.draw_key(s, 0) for s in (11, 12, 13, 14)]
    bias_scales = [0.5, 0.0, -1.25, 0.3]
    small_keys = bias_keys[:3]
    for form in names:
        same = torch.equal(draw(form, [key], [n], None, normal=False), want_words)
        same &= torch.equal(draw(form, [key], [n], None), want)
        if form != "replaced":
            for keys, counts, scales, shift in (
                (bias_keys, [216] * 4, bias_scales, 0),
                (small_keys, [1, 3, 5], [1.5, -2.0, 0.0], 1),
            ):
                got = draw(form, keys, counts, scales, shift=shift)
                ref = tr.normals_plain(keys, counts, scales, dev)
                same &= bool((got - ref).abs().max() <= cs.NORMAL_ATOL)
        print(f"  {form}: equal to the package kernel {same}")
        if not same:
            raise SystemExit(f"{form} differs")
    runs = {form: (lambda form=form: draw(form, [key], [n], None)) for form in names}
    times = {form: [] for form in names}
    for form in names + names[::-1]:
        times[form].append(cs.cuda_time_ms(torch, runs[form], 20))
    print(f"threefry normals B=4 x 1 x 256^3 ({smi}):")
    for form, ts in times.items():
        print(f"  {form}: {', '.join(f'{t:.4f}' for t in ts)} ms (best {min(ts):.4f})")
    print_counts(loop_counts(sass), n, clock_mhz)


if __name__ == "__main__":
    main()
