#!/usr/bin/env python3
"""Probe: where the build time of ``csrc/bspline.cu`` goes.

Writes variants of the source into ``probes/_build/build_time/``, each
leaving out or changing one part of the dense spline kernel's instances
(``SplineCoords``: 6 orders x 2 channel widths x 2 offset types), compiles
them all at once with the package's ``nvcc`` flags, one process each, and
prints each variant's time from the common start:

- ``as_is``: the source as it is;
- ``no_wide``: no 64-bit offset instances;
- ``min_blocks_1``: the dense kernel without its register limit;
- ``no_v4``: no four-channel instances;
- ``no_dense``: no dense kernel at all (the grid-spec spline and the
  prefilter alone);
- ``dense_orders_2_3``: the dense kernel at orders 2 and 3 only;
- ``dense_only``: no grid-spec spline.

Needs nvcc (no GPU); run from the repository's root:

    python3 probes/bspline_build_time.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from torchio_tpu_torch import config  # noqa: E402
from torchio_tpu_torch.ops import kernel_lib as kl  # noqa: E402

#: variant: (text of bspline.cu, its replacement)
EDITS = {
    "as_is": ("", ""),
    "no_wide": (
        "  if (l.wide) {\n"
        "    tio::launch_rows<SplineCoords<kOrder, V, int64_t, L>, Source::kDense>"
        "(args, pts, s, l, st);\n  } else {",
        "  {",
    ),
    "min_blocks_1": (
        "  static constexpr int kMinBlocks =\n"
        "      kOrder <= 3 || L::kMinBlocks < 2 ? L::kMinBlocks : 2;",
        "  static constexpr int kMinBlocks = 1;",
    ),
    "no_v4": ("    launch_coords_vec<4, L>(args, pts, s, l, order, st);", ""),
    "no_dense": (
        "  return launch_coords<DenseSplineLayout>({coeffs, fill, out}, pts, s, l, order, vec,\n"
        "                                          static_cast<cudaStream_t>(stream));",
        "  return 0;",
    ),
    "dense_orders_2_3": (
        "".join(
            f"    case {n}: launch_coords_as<{n}, V, L>(args, pts, s, l, st); break;\n"
            for n in (4, 5, 6, 7)
        ),
        "",
    ),
    "dense_only": (
        "    return launch_spline<Source::kMapField>(coeffs, pts, fill, out, s, order, vec, st);\n"
        "  }\n"
        "  return launch_spline<Source::kMap>(coeffs, pts, fill, out, s, order, vec, st);",
        "  }\n  return 0;",
    ),
}


def main():
    source = (config.CSRC_DIR / "bspline.cu").read_text()
    out = ROOT / "probes" / "_build" / "build_time"
    out.mkdir(parents=True, exist_ok=True)
    include = f'#include "{config.CSRC_DIR / "row_tiles.cuh"}"'
    procs = {}
    start = time.perf_counter()
    for name, (old, new) in EDITS.items():
        if old not in source:
            raise SystemExit(f"{name}: bspline.cu no longer holds the text this variant edits")
        text = source.replace(old, new).replace('#include "row_tiles.cuh"', include)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [config.nvcc(), *kl.FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
    while procs:
        for name, proc in list(procs.items()):
            if proc.poll() is not None:
                print(f"{name}: rc {proc.returncode}, {time.perf_counter() - start:.1f} s",
                      flush=True)
                del procs[name]
        time.sleep(1)


if __name__ == "__main__":
    main()
