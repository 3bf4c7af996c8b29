"""The program's own spans in a traced window: the transform engine's
``tio.*`` host events (``torchio_tpu_torch.profiling.span``), the split
of each call's idle device time by the engine's phase, and the host
synchronisations inside the spans.

A phase span is named ``tio.<owner>.<phase>``, with ``<phase>`` one of
:data:`PHASES`; ``tio.<Transform>`` spans a transform's call. The device
is idle inside a call wherever none of its operations runs (the gaps of
``Timeline.busy_by_call``). Each idle piece goes to the first that
holds at its time: a garbage collection of the interpreter
(``Timeline.collections``), the phase of the innermost open ``tio.*``
span, else ``other`` (a ``tio.<Transform>`` span with no phase open, or
no program span). The pieces add up to ``Timeline.host_exposed``. A
span's owner is the ``<owner>`` of its name: the same split by owner
gives one transform's share, and the synchronisations may be counted
inside one owner's spans.
"""

from __future__ import annotations

import bisect
import heapq

from port_bench.timeline import Timeline, covered, gaps, union

PREFIX = "tio."
PHASES = ("copy", "draw", "apply", "record")
#: the CUDA runtime's calls that wait for the device
SYNCS = frozenset(
    {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}
)


def program_spans(timeline: Timeline) -> list[tuple[float, float, str]]:
    """The ``tio.*`` host spans as sorted ``(start, end, name)``."""
    return sorted(
        (e.start, e.end, e.name)
        for e in timeline.events
        if e.kind == "cpu" and e.name.startswith(PREFIX)
    )


def phase_of(name: str) -> str:
    """A span's phase: its last dotted component where that is one of
    :data:`PHASES`, else ``other``."""
    last = name.rsplit(".", 1)[-1]
    return last if last in PHASES else "other"


def owner_of(name: str) -> str:
    """A span's owner: ``<owner>`` of ``tio.<owner>`` or
    ``tio.<owner>.<phase>``."""
    return name[len(PREFIX):].split(".", 1)[0]


def innermost(spans: list[tuple[float, float, str]], label=phase_of) -> list:
    """Disjoint sorted ``(start, end, label)`` pieces of the sorted spans'
    union, each labelled with ``label`` of the name of the innermost span
    open there (the open span that started last; its phase by default)."""
    bounds = sorted({t for start, end, _ in spans for t in (start, end)})
    pieces: list[tuple[float, float, str]] = []
    heap: list[tuple[float, float, str]] = []  # (-start, end, part) of open spans
    nxt = 0
    for lo, hi in zip(bounds, bounds[1:]):
        while nxt < len(spans) and spans[nxt][0] <= lo:
            start, end, name = spans[nxt]
            heapq.heappush(heap, (-start, end, label(name)))
            nxt += 1
        while heap and heap[0][1] <= lo:
            heapq.heappop(heap)
        if not heap:
            continue
        part = heap[0][2]
        if pieces and pieces[-1][1] == lo and pieces[-1][2] == part:
            pieces[-1] = (pieces[-1][0], hi, part)
        else:
            pieces.append((lo, hi, part))
    return pieces


def _meet(intervals, pieces):
    """``(start, end, piece)`` for each overlap of sorted disjoint
    ``intervals`` with sorted disjoint ``pieces`` (tuples that start with
    their bounds)."""
    i = j = 0
    while i < len(intervals) and j < len(pieces):
        lo = max(intervals[i][0], pieces[j][0])
        hi = min(intervals[i][1], pieces[j][1])
        if hi > lo:
            yield lo, hi, pieces[j]
        if intervals[i][1] < pieces[j][1]:
            i += 1
        else:
            j += 1


def _subtract(intervals, holes) -> list[tuple[float, float]]:
    """The parts of sorted disjoint ``intervals`` outside sorted disjoint
    ``holes``."""
    out, j = [], 0
    for lo, hi in intervals:
        while j < len(holes) and holes[j][1] <= lo:
            j += 1
        at, k = lo, j
        while k < len(holes) and holes[k][0] < hi:
            if holes[k][0] > at:
                out.append((at, holes[k][0]))
            at = max(at, holes[k][1])
            k += 1
        if hi > at:
            out.append((at, hi))
    return out


def idle_by(timeline: Timeline, label=phase_of) -> dict[str, float] | None:
    """The calls' idle device time, summed over the calls in the
    timeline's unit: ``collection`` during the interpreter's collections,
    else by ``label`` of the innermost open program span's name (its
    phase by default), ``other`` under no program span. The values add
    up to the calls' host time that the device does not hide. None where
    the window holds no call or no program span."""
    spans = program_spans(timeline)
    if not timeline.calls or not spans:
        return None
    idle = sorted(
        piece
        for (start, end), busy in zip(timeline.calls, timeline.busy_by_call())
        for piece in gaps(busy, start, end)
    )
    rest = _subtract(idle, union((start, end) for start, end, _ in timeline.collections))
    totals = {"collection": covered(idle) - covered(rest)}
    named = 0.0
    for lo, hi, (_, _, key) in _meet(rest, innermost(spans, label)):
        totals[key] = totals.get(key, 0.0) + (hi - lo)
        named += hi - lo
    totals["other"] = totals.get("other", 0.0) + covered(rest) - named
    return totals


def phase_ms_per_call(timeline: Timeline, phase: str) -> float | None:
    """Idle device ms a call under ``phase``'s spans."""
    totals = idle_by(timeline)
    if totals is None:
        return None
    return totals.get(phase, 0.0) / len(timeline.calls) / 1e3


def owner_ms_per_call(timeline: Timeline, owner: str) -> float | None:
    """Idle device ms a call under an innermost span of ``owner``; None
    where the window holds no call or no span of ``owner``."""
    if not any(owner_of(name) == owner for _, _, name in program_spans(timeline)):
        return None
    totals = idle_by(timeline, label=owner_of)
    if totals is None:
        return None
    return totals.get(owner, 0.0) / len(timeline.calls) / 1e3


def syncs_per_call(timeline: Timeline, owner: str | None = None) -> float | None:
    """The runtime's synchronising calls (:data:`SYNCS`) a call that
    start inside the union of the program's spans (of ``owner``'s spans
    only, where given); None where the window holds no call or no such
    span."""
    spans = [s for s in program_spans(timeline) if owner is None or owner_of(s[2]) == owner]
    if not timeline.calls or not spans:
        return None
    inside = union((start, end) for start, end, _ in spans)
    starts = [lo for lo, _ in inside]
    count = 0
    for e in timeline.events:
        if e.kind == "cpu" and e.name in SYNCS:
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= inside[i][1]:
                count += 1
    return count / len(timeline.calls)
