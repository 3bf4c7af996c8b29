"""Arithmetic on a run's timings: the rate and the tail of the host
clock's calls, and the union of the device's busy intervals in a traced
window (all times in one unit, as given)."""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field


def rate(units: int, wall: float) -> float:
    """Work units completed over the wall time they took."""
    return units / wall


def percentile(values, q: int) -> float:
    """The ``q``-th percentile of every value (the inclusive method of
    ``statistics.quantiles``; one value is its own percentile)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def union(intervals) -> list[tuple[float, float]]:
    """The disjoint, sorted union of ``(start, end)`` intervals."""
    merged: list[tuple[float, float]] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of sorted disjoint ``intervals`` inside ``[lo, hi]``."""
    out = []
    for start, end in intervals:
        start, end = max(start, lo), min(end, hi)
        if end > start:
            out.append((start, end))
    return out


def covered(intervals) -> float:
    return sum(end - start for start, end in intervals)


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that sorted disjoint ``intervals`` leave
    uncovered."""
    out, at = [], lo
    for start, end in clip(intervals, lo, hi):
        if start > at:
            out.append((at, start))
        at = max(at, end)
    if hi > at:
        out.append((at, hi))
    return out


@dataclass
class Event:
    """One event of a traced window: ``kind`` is ``cpu`` (a host
    operation of the thread that calls the pipeline), ``kernel``,
    ``memcpy`` or ``memset`` (device operations)."""

    kind: str
    name: str
    start: float
    end: float


DEVICE_KINDS = ("kernel", "memcpy", "memset")


@dataclass
class Timeline:
    """A traced window in microseconds: the calls' spans (the harness's
    own), the events, and each call's work by kernel, ``{kernel: [(bytes,
    flops), ...]}`` one entry a call."""

    calls: list[tuple[float, float]]
    events: list[Event]
    window: tuple[float, float]
    work: dict = field(default_factory=dict)
    #: the interpreter's garbage collections, (start, end, generation)
    collections: list = field(default_factory=list)

    def device(self) -> list[Event]:
        return [e for e in self.events if e.kind in DEVICE_KINDS]

    def by_call(self) -> list[list[Event]]:
        """The device operations that start inside each call's span (the
        harness's own copies between calls are left out)."""
        out: list[list[Event]] = [[] for _ in self.calls]
        starts = [start for start, _ in self.calls]
        for e in self.device():
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= self.calls[i][1]:
                out[i].append(e)
        return out

    def device_in_calls(self) -> list[Event]:
        return [e for events in self.by_call() for e in events]

    def busy_by_call(self) -> list[list[tuple[float, float]]]:
        """Each call's device busy intervals: the union of its device
        operations, clipped to its span."""
        return [
            union((e.start, min(e.end, end)) for e in events)
            for events, (_, end) in zip(self.by_call(), self.calls)
        ]

    def busy(self) -> list[tuple[float, float]]:
        return [piece for pieces in self.busy_by_call() for piece in pieces]

    def host_exposed(self) -> list[float]:
        """Each call's wall time minus the device's busy time inside it."""
        return [
            (end - start) - covered(pieces)
            for (start, end), pieces in zip(self.calls, self.busy_by_call())
        ]
