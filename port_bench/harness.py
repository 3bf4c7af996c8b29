"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison that decides ``correct``.

The window is a closed loop: one ``Compose.__call__`` of the cell's
pipeline on the same input batch, then ``torch.cuda.synchronize()`` (the
training step that consumes the batch), then the next call. The host
parameter generator moves on, so every call draws new parameters. At
times drawn from the seed, one element of the call running then is
copied to the host once the call has ended; after the window the
reference recomputes it from the seed and the inputs, and the largest
gap is compared with its limit.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from port_bench import inputs, registry, timeline, trace
from port_bench.reference.context import Context
from port_bench.reference.pipeline import Reference

#: top-level module names that no run may hold once its window closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "torchio_tpu")
GIB = 2**30
#: the gap of an image that is missing, misshapen or not finite (the
#: largest float, which JSON can hold where it cannot hold infinity)
UNBOUNDED = sys.float_info.max


def derived_seed(seed: int, stream: int) -> int:
    """A 64-bit seed of its own for each use of ``--seed`` (any whole
    number): the warm-up, the window, the captures."""
    sequence = np.random.SeedSequence([int(seed) % 2**64, stream])
    return int(sequence.generate_state(1, np.uint64)[0])


WARMUP, WINDOW, CAPTURES = 0, 1, 2


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def build_pipeline(tio, traffic: dict):
    """The mix's ``Compose`` through the port's public API: each entry
    ``[name, arguments]`` is ``tio.<name>(**arguments)``."""
    steps = [getattr(tio, name)(**args) for name, args in traffic["transforms"]]
    return tio.Compose(steps, fuse=bool(traffic.get("fuse", False)))


def make_batch(tio, specs: dict, tensors: dict):
    """The batch of subjects of the inputs (a made image is the
    pipeline's to write)."""
    classes = {"scalar": tio.ScalarImage, "label": tio.LabelMap}
    batch = len(next(iter(tensors.values())))
    subjects = [
        tio.Subject(**{
            name: classes[spec.kind](tensors[name][b], affine=spec.affine)
            for name, spec in inputs.given(specs).items()
        })
        for b in range(batch)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def capture_plan(seed: int, count: int, batch: int, seconds: float):
    """``count`` (time into the window, element) pairs drawn from the
    seed: times uniform over the window (each takes the call running at
    that time), elements a permutation of the batch repeated, so that the
    captures cover every element they can."""
    rng = np.random.default_rng(derived_seed(seed, CAPTURES))
    times = np.sort(rng.uniform(0.0, seconds, count))
    order = []
    while len(order) < count:
        order.extend(int(e) for e in rng.permutation(batch))
    return list(zip(times.tolist(), order[:count]))


@dataclass
class Capture:
    call: int
    element: int
    #: name -> the element's copy on the host; an image the call did not
    #: return, or returned in another shape, is left out
    images: dict


@dataclass
class Window:
    calls: list[float] = field(default_factory=list)
    started: float = 0.0
    ended: float = 0.0
    failed: int = 0
    error: str = ""
    captures: list[Capture] = field(default_factory=list)
    work: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    #: the interpreter's garbage collections, (start, end, generation) in
    #: microseconds of the wall clock (the profiler's time base)
    collections: list = field(default_factory=list)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    """The port's own launch counter of its hand-written kernels."""
    try:
        from torchio_tpu_torch.ops import kernel_lib
    except ImportError:
        return {}
    return dict(kernel_lib.LAUNCHES)


def _history(out) -> list:
    return [(record.name, record.raw_params()) for record in out.applied_transforms]


def _capture(out, element: int, buffers: dict) -> dict:
    """``buffers`` filled with element ``element`` of each image of
    ``out`` that has their shape; the others are left out, so that
    ``compare`` reads them as missing."""
    held = {}
    for name, buffer in buffers.items():
        image = out.images.get(name)
        if image is not None and tuple(image.data.shape[1:]) == tuple(buffer.shape):
            held[name] = buffer.copy_(image.data[element])
    return held


def drive(call, batch, size: int, specs, seconds, plan, device, work=None) -> Window:
    """The closed loop: ``call(batch)``, synchronise, next call, until
    ``seconds`` have passed; the planned captures copied to the host
    between calls; with ``work`` (``{kernel: module}``) each call's work
    by kernel from its recorded history."""
    window = Window(work={kernel: [] for kernel in (work or {})})
    pinned = device.type == "cuda"
    buffers = [
        {name: torch.empty((spec.channels, *spec.shape), dtype=spec.dtype, pin_memory=pinned)
         for name, spec in specs.items()}
        for _ in plan
    ]
    pending = list(zip(plan, buffers))
    before = _launches()
    tracing = work is not None
    collecting = {}

    def collection(phase, info):
        if phase == "start":
            collecting["start"] = time.time_ns() / 1e3
        elif "start" in collecting:
            window.collections.append(
                (collecting.pop("start"), time.time_ns() / 1e3, info["generation"]))

    if tracing:
        gc.callbacks.append(collection)
    window.started = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - window.started >= seconds:
            break
        try:
            if tracing:
                with torch.profiler.record_function(trace.CALL_SPAN):
                    out = call(batch)
                    _sync(device)
            else:
                out = call(batch)
                _sync(device)
        except Exception as error:  # a call that fails ends the window; the run is not correct
            window.failed += 1
            window.error = f"{type(error).__name__}: {error}"
            break
        t1 = time.perf_counter()
        window.calls.append(t1 - t0)
        index = len(window.calls) - 1
        while pending and pending[0][0][0] <= t1 - window.started:
            (_, element), held = pending.pop(0)
            window.captures.append(Capture(index, element, _capture(out, element, held)))
        if tracing:
            history = _history(out)
            for kernel, module in work.items():
                window.work[kernel].append(module.work(history, specs, size))
        del out
    window.ended = time.perf_counter()
    if tracing:
        gc.callbacks.remove(collection)
    after = _launches()
    window.launches = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    return window


def compare(specs: dict, candidate: dict, reference: dict) -> dict:
    """The gaps of one element: a scalar image's largest absolute
    difference, a label map's share of differing voxels (a missing or
    misshapen image, or a value that is not finite, reads ``UNBOUNDED``)."""
    gaps = {}
    for name, spec in specs.items():
        got, want = candidate.get(name), reference[name]
        key = f"{name}.{'max_abs' if spec.kind == 'scalar' else 'mismatch'}"
        if got is None or tuple(got.shape) != tuple(want.shape):
            gaps[key] = UNBOUNDED
            continue
        got = got.to(want.device)
        if spec.kind == "scalar":
            diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
            value = float(diff.max())  # NaN where any difference is NaN
            gaps[key] = value if math.isfinite(value) else UNBOUNDED
        else:
            gaps[key] = float((got != want).to(torch.float64).mean())
    return gaps


def check(cell, specs, batch: int, seed: int, window: Window, device, control=False) -> dict:
    """Largest gap over the window's captures by compared number: the
    program's copies against the float32 reference, or (``control``) the
    reference kept in bfloat16 in the program's place."""
    ctx = Context(specs, batch, device)
    reference = Reference(cell.traffic, ctx)
    low = Reference(cell.traffic, Context(specs, batch, device, low=True)) if control else None
    tensors = inputs.make(specs, batch, seed, device)
    last = max((c.call for c in window.captures), default=-1)
    drawn = reference.replay(derived_seed(seed, WINDOW), last + 1)
    worst: dict = {}
    with torch.no_grad():
        for capture in window.captures:
            want = reference.element(drawn[capture.call], tensors, capture.element)
            got = low.element(drawn[capture.call], tensors, capture.element) if control \
                else capture.images
            for key, value in compare(specs, got, want).items():
                worst[key] = max(worst.get(key, 0.0), value)
            del want, got
    return worst


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(cell, seed: int, seconds: float, traced: bool, device, *, started: float,
        shape=None, batch=None, captures=None, wrap=None, control=False,
        log=print) -> dict | None:
    """One run; returns the result object (None where a forbidden module
    was loaded). ``started`` is the process's start on the
    ``time.perf_counter`` clock; ``shape``, ``batch``, ``captures`` and
    ``wrap`` (a function of the pipeline that returns the callable to
    time) serve the CPU tests."""
    import torchio_tpu_torch as tio

    device = torch.device(device)
    if device.type == "cuda":
        from torchio_tpu_torch.ops import kernel_lib

        kernel_lib.build_all()
    else:
        tio.set_default_device(device)
    traffic = cell.traffic
    b = int(batch or traffic["batch"])
    specs = inputs.images(cell.config, shape)
    tensors = inputs.make(specs, b, seed, device)
    data = make_batch(tio, specs, tensors)
    del tensors
    pipeline = build_pipeline(tio, traffic)
    call = wrap(pipeline) if wrap else pipeline
    tio.seed(derived_seed(seed, WARMUP))
    for _ in range(int(traffic.get("warmup_calls", 3))):
        out = call(data)
        _sync(device)
        del out
    plan = capture_plan(seed, int(captures or traffic.get("captures", 6)), b, seconds)
    work = registry.work_modules() if traced else None
    prof = trace.profiler(device) if traced else None
    tio.seed(derived_seed(seed, WINDOW))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if prof is not None:
        prof.__enter__()
    setup_s = time.perf_counter() - started
    window = drive(call, data, b, specs, seconds, plan, device, work)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if prof is not None:
        prof.__exit__(None, None, None)
    del data, pipeline, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    loaded = forbidden_modules()
    if loaded:
        print(f"port_bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return None

    calls = window.calls
    wall = window.ended - window.started
    metrics: dict = {}
    extra: dict = {}
    if calls:
        median_ms = statistics.median(calls) * 1e3
        log(f"calls {len(calls)} of B={b} in {wall:.3f} s; median call {median_ms:.3f} ms;"
            f" p95 {timeline.percentile(calls, 95) * 1e3:.3f} ms; longest"
            f" {max(calls) * 1e3:.3f} ms; failed {window.failed}")
    log(f"card: {power_limit() if device.type == 'cuda' else device}")
    if calls:
        per_call = {k: round(v / len(calls), 3) for k, v in window.launches.items()}
        log(f"hand-written kernel launches a call: {per_call}")
    if window.error:
        log(f"the window ended on a failed call: {window.error}")
    values = {}
    if calls:
        values = {
            "subjects_per_s": timeline.rate(b * len(calls), wall),
            "call_ms_p95": timeline.percentile(calls, 95) * 1e3,
            "peak_gib": peak / GIB,
            "setup_s": setup_s,
        }
    if prof is not None:
        line = trace.timeline_of(prof)
        line.work = window.work
        line.collections = window.collections
        full = [c for c in window.collections if c[2] == 2]
        log(f"traced window: {len(line.calls)} calls, {len(line.events)} events;"
            f" {len(full)} full garbage collections of the interpreter,"
            f" {sum(e - s for s, e, _ in full) / 1e3:.1f} ms in all")
        for entry in cell.per_layer:
            value = registry.metric_reader(entry["name"])(line)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        extra["busy_s"] = trace.busy_seconds(line)
        extra["window_s"] = trace.window_seconds(line)
        result_breakdown = trace.breakdown(line)
    else:
        result_breakdown = None
        for entry in cell.end_to_end:
            if entry["name"] in values:
                metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}

    gaps = check(cell, specs, b, seed, window, device, control) if window.captures else {}
    limits = cell.limits.get("limits", {})
    checks = {
        key: {"value": gaps.get(key, UNBOUNDED), "limit": limits.get(key)}
        for key in sorted(set(limits) | set(gaps))
    }
    correct = (
        bool(calls) and not window.failed and bool(window.captures)
        and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    )
    result = {
        "correct": correct,
        "attempted": len(calls) + window.failed,
        "failed": window.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            **extra,
        },
    }
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["checks"] = checks
    log(f"compared {len(window.captures)} elements (call, element):"
        f" {[(c.call, c.element) for c in window.captures]}")
    return result
