"""The traced run: ``torch.profiler`` over the window, each call inside a
span of the harness's own (``CALL_SPAN``), read back into a
:class:`~port_bench.timeline.Timeline`, and the breakdown of where the
device's time and its idle gaps went."""

from __future__ import annotations

import collections

from port_bench.timeline import Event, Timeline, covered, gaps, union

#: the name of the harness's span around one call of the pipeline
CALL_SPAN = "port_bench.call"
BREAKDOWN_ENTRIES = 10


def profiler(device):
    """A profiler of the host and, on a card, of the card (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _span(e) -> tuple[float, float]:
    """An event's (start, end) in microseconds."""
    if hasattr(e, "duration_ns"):
        start = e.start_ns() / 1e3
        return start, start + e.duration_ns() / 1e3
    return float(e.start_us()), float(e.start_us() + e.duration_us())


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def timeline_of(prof, thread: int | None = None) -> Timeline:
    """The profiler's events as a Timeline in microseconds: the calls
    from the harness's spans, the host operations of ``thread`` (the
    thread that recorded the spans where None), the device's kernels,
    copies and fills (every device event but the spans' own device-side
    annotations)."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    calls, events = [], []
    for e in raw:
        if e.name() == CALL_SPAN and e.device_type() == DeviceType.CPU:
            calls.append(_span(e))
            thread = e.start_thread_id() if thread is None else thread
    for e in raw:
        name = e.name()
        if name == CALL_SPAN:
            continue
        if e.device_type() == DeviceType.CUDA:
            events.append(Event(_device_kind(name), name, *_span(e)))
        elif e.device_type() == DeviceType.CPU and e.start_thread_id() == thread:
            events.append(Event("cpu", name, *_span(e)))
    calls.sort()
    window = (calls[0][0], calls[-1][1]) if calls else (0.0, 0.0)
    return Timeline(calls=calls, events=events, window=window)


def host_op_at(cpu: list[Event], starts: list[float], t: float) -> str:
    """The innermost host operation open at time ``t`` ("python" where
    none is: the interpreter between operations)."""
    import bisect

    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        e = cpu[i]
        if e.end >= t and (best is None or e.start >= best.start):
            best = e
        if t - e.start > 5e6:  # no host operation of a call lasts 5 s
            break
    return "python" if best is None else best.name


def host_at(timeline: Timeline, cpu, starts, t: float) -> str:
    """What the host was doing at time ``t``: a garbage collection of the
    interpreter, else the innermost host operation open."""
    for start, end, generation in timeline.collections:
        if start <= t <= end:
            return f"garbage collection (generation {generation})"
    return host_op_at(cpu, starts, t)


def breakdown(timeline: Timeline) -> dict:
    """The device operations that took the most time, and the longest
    idle gaps inside the calls, each named by what the host was doing at
    its middle: ``{"device_ops": [[name, seconds], ...], "idle_gaps":
    [[name, seconds], ...]}``, at most ten entries each."""
    totals: dict[str, float] = collections.Counter()
    for e in timeline.device_in_calls():
        totals[e.name] += (e.end - e.start) / 1e6
    device_ops = [[name, seconds] for name, seconds in totals.most_common(BREAKDOWN_ENTRIES)]
    cpu = sorted((e for e in timeline.events if e.kind == "cpu"), key=lambda e: e.start)
    starts = [e.start for e in cpu]
    idle = []
    for (start, end), pieces in zip(timeline.calls, timeline.busy_by_call()):
        idle.extend(gaps(pieces, start, end))
    idle.sort(key=lambda g: g[0] - g[1])
    idle_gaps = [
        [host_at(timeline, cpu, starts, (lo + hi) / 2), (hi - lo) / 1e6]
        for lo, hi in idle[:BREAKDOWN_ENTRIES]
    ]
    return {"device_ops": device_ops, "idle_gaps": idle_gaps}


def busy_seconds(timeline: Timeline) -> float:
    return covered(union(timeline.busy())) / 1e6


def window_seconds(timeline: Timeline) -> float:
    return (timeline.window[1] - timeline.window[0]) / 1e6
