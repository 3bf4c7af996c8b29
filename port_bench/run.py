#!/usr/bin/env python3
"""The benchmark of ``torchio_tpu_torch`` on one NVIDIA GPU.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell ``<name>`` of ``BENCHMARK.json`` from the root of a
checkout: set-up, a closed loop of its pipeline for ``<s>`` seconds, the
comparison with the plain reference. The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last the compared
numbers with their limits under ``checks``); the compared numbers are
also the last lines of standard error. Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits with 2; if
the run loaded ``jax``, ``jaxlib``, ``flax`` or ``torchio_tpu``, with 3.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
#: the run's process and its threads stay on this many of the CPUs it may
#: use, the lowest-numbered: the scheduler then does not move the
#: pipeline's serial host work between cores whose neighbours differ
CORES = 4


def pin() -> list[int]:
    """Keep this process on the ``CORES`` lowest-numbered CPUs it may use
    (all of them where the system has no affinity call)."""
    try:
        cpus = sorted(os.sched_getaffinity(0))[:CORES]
        os.sched_setaffinity(0, cpus)
    except (AttributeError, OSError):
        return []
    return cpus


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``), where the system tells; else 0."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    started = STARTED - process_age()
    # a fixed cache directory inside the checkout, for any Triton kernel
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".port_bench_cache" / "triton"))
    # one host thread a math library, on a fixed set of cores: the load of
    # one process with few threads (the pipeline's host work is serial)
    os.environ.update(THREADS)
    cpus = pin()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness, registry

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA devices,"
              f" {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    print(f"cpus: {cpus or 'all'}")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                         started=started)
    if result is None:
        return 3
    sys.stdout.flush()
    for key, entry in result["checks"].items():
        print(f"check {key} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
