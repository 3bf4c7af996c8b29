#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: the program's largest gaps to the reference on each of
``--seeds`` seeds, and the control's (the reference kept in bfloat16 in
the program's place) on each of ``--control-seeds``, each from a short
window at the cell's own size and load.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 3]

Prints one JSON line a seed and last the lower reading (the largest the
program gave) and the upper one (the smallest the control gave) of each
compared number. The benchmark's own runs do not run this."""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench.run import THREADS, pin

    os.environ.update(THREADS)
    pin()
    import torch

    from port_bench import harness, registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload, ROOT)
    readings = {"program": {}, "control": {}}
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for side, seed in runs:
        result = harness.run(cell, seed, args.seconds, False, "cuda:0", started=time.perf_counter(),
                             control=side == "control", log=lambda *_: None)
        gaps = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"side": side, "seed": seed, "gaps": gaps,
                          "calls": result["attempted"]}), flush=True)
        for key, value in gaps.items():
            readings[side].setdefault(key, []).append(value)
    summary = {
        key: {"lower": max(readings["program"].get(key, [float("nan")])),
              "upper": min(readings["control"].get(key, [float("nan")]))}
        for key in sorted(set(readings["program"]) | set(readings["control"]))
    }
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
