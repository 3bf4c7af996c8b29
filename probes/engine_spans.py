#!/usr/bin/env python3
"""Probe: one traced run of a ``port_bench`` cell, with the transform
engine's spans read in full.

Runs ``port_bench/run.py --trace 1`` in this process (its result line
is printed as usual), keeps the traced window's timeline, and prints one
more JSON line:

- ``split_ms``: a call's idle device time by part (the four phases, the
  interpreter's collections, the rest) beside ``host_exposed_ms``, and
  their difference;
- ``idle_by_span_ms``: the same idle time by the innermost span's full
  name (which transform's phase);
- ``span_ms``: each span's own host time a call (inclusive);
- ``resolve_per_call``: the ``tio.<T>.resolve`` spans a call (a
  history's params made JSON: none while nothing reads them);
- ``runtime_in_spans``: the CUDA runtime calls a call inside the spans,
  by name (the synchronising ones are what ``host_syncs_per_call``
  counts);
- ``device_tio_events``: device events named ``tio.*`` (none expected);
- ``reader_s``: the seconds each per-layer metric's reader took.

    python3 probes/engine_spans.py --workload t1-kspace-b4 --seed 7 --seconds 20

from the root of a checkout, on a machine with a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def analyse(line) -> dict:
    from port_bench import spans
    from port_bench.timeline import union

    calls = len(line.calls)
    program = spans.program_spans(line)
    parts = spans.idle_by(line) or {}
    by_name = spans.idle_by(line, label=str) or {}
    exposed = sum(line.host_exposed())
    own = collections.Counter()
    for lo, hi, name in program:
        own[name] += hi - lo
    inside = union((lo, hi) for lo, hi, _ in program)
    starts = [lo for lo, _ in inside]

    def within(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= inside[i][1]

    runtime = collections.Counter(
        e.name for e in line.events
        if e.kind == "cpu" and e.name.startswith("cuda") and within(e.start)
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    return {
        "calls": calls,
        "spans": len(program),
        "split_ms": {k: v / calls / 1e3 for k, v in parts.items()},
        "host_exposed_ms": exposed / calls / 1e3,
        "split_minus_exposed_ms": (sum(parts.values()) - exposed) / calls / 1e3,
        "idle_by_span_ms": {k: v / calls / 1e3 for k, v in top},
        "span_ms": {k: v / calls / 1e3 for k, v in own.most_common(24)},
        "resolve_per_call": sum(name.endswith(".resolve") for _, _, name in program) / calls,
        "runtime_in_spans": {k: v / calls for k, v in runtime.most_common(16)},
        "syncs_per_call": spans.syncs_per_call(line),
        "device_tio_events": sum(1 for e in line.device() if e.name.startswith("tio.")),
        "device_events": len(line.device()),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args()

    from port_bench import registry, run

    kept, seconds = [], {}
    reader = registry.metric_reader

    def keeping(name, root=registry.ROOT):
        read = reader(name, root)

        def read_and_keep(line):
            if not kept:
                kept.append(line)
            t0 = time.perf_counter()
            value = read(line)
            seconds[name] = time.perf_counter() - t0
            return value

        return read_and_keep

    registry.metric_reader = keeping
    code = run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if code != 0 or not kept:
        return code or 1
    report = {"workload": args.workload, "seed": args.seed, "reader_s": seconds,
              **analyse(kept[0])}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
