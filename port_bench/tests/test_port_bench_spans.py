"""The transform engine's spans on synthetic timelines: each phase metric
gets exactly its idle pieces, the phases, the collections and the rest
add up to the host time the device does not hide, a collection belongs
to no phase, the synchronisations counted are the program's, and a
window without the program's spans reads nothing."""

from __future__ import annotations

import pytest

from port_bench import spans, trace
from port_bench.registry import metric_reader
from port_bench.timeline import Event, Timeline

PHASE_METRICS = {
    "copy": "copy_exposed_ms_per_call",
    "draw": "draw_exposed_ms_per_call",
    "apply": "enqueue_exposed_ms_per_call",
    "record": "record_exposed_ms_per_call",
}
METRICS = (*PHASE_METRICS.values(), "host_syncs_per_call")

#: one call of a fused headline (us): the composer's copy, Spatial's
#: phases, the fused run's draw, apply and record
CALL_SPANS = [
    ("tio.Compose", 1, 99),
    ("tio.Compose.copy", 2, 10),
    ("tio.Spatial", 12, 60),
    ("tio.Spatial.draw", 13, 20),
    ("tio.Spatial.apply", 21, 50),
    ("tio.Spatial.record", 51, 55),
    ("tio.BiasField.draw", 61, 65),
    ("tio.fused.apply", 66, 90),
    ("tio.BiasField.record", 91, 95),
]
#: the device runs 22-45 and 70-98: idle 0-22, 45-70 and 98-100
KERNELS = [(22, 45), (70, 98)]
#: idle us a call by part, read off the spans above
WANT = {"copy": 8.0, "draw": 11.0, "apply": 10.0, "record": 4.0, "other": 16.0}


def synthetic(calls: int = 2, program: bool = True) -> Timeline:
    """``calls`` calls of 100 us, 200 us apart; in each a runtime sync
    inside Spatial's apply and the harness's own sync after the
    composer."""
    events, bounds = [], []
    for c in range(calls):
        t = 200.0 * c
        bounds.append((t, t + 100.0))
        if program:
            events += [Event("cpu", name, t + lo, t + hi) for name, lo, hi in CALL_SPANS]
        events += [Event("kernel", "elementwise_kernel", t + lo, t + hi) for lo, hi in KERNELS]
        events += [
            Event("cpu", "aten::mul", t + 23, t + 24),
            Event("cpu", "cudaStreamSynchronize", t + 30, t + 44),
            Event("cpu", "cudaLaunchKernel", t + 67, t + 68),
            Event("cpu", "cudaStreamSynchronize", t + 99.2, t + 99.9),  # the harness's
        ]
    return Timeline(calls=bounds, events=events, window=(0.0, 200.0 * calls - 100.0))


def read(line: Timeline) -> dict:
    return {name: metric_reader(name)(line) for name in (*METRICS, "host_exposed_ms_per_call")}


def test_each_phase_gets_exactly_its_idle_pieces():
    line = synthetic()
    assert spans.idle_by(line) == {**{k: 2 * v for k, v in WANT.items()}, "collection": 0.0}
    got = read(line)
    for phase, name in PHASE_METRICS.items():
        assert got[name] == pytest.approx(WANT[phase] / 1e3)


def test_the_parts_add_up_to_the_host_time_not_hidden():
    line = synthetic(calls=3)
    # the second collection starts between two calls
    line.collections = [(52.0, 58.0, 2), (340.0, 420.0, 0)]
    got = read(line)
    parts = spans.idle_by(line)
    rest = (parts["collection"] + parts["other"]) / len(line.calls) / 1e3
    total = sum(got[name] for name in PHASE_METRICS.values()) + rest
    assert total == pytest.approx(got["host_exposed_ms_per_call"], abs=1e-12)
    assert sum(parts.values()) == pytest.approx(sum(line.host_exposed()), abs=1e-9)


def test_a_gap_during_a_collection_goes_to_no_phase():
    line = synthetic(calls=1)
    line.collections = [(52.0, 58.0, 2)]  # 3 us of Spatial's record, 3 of Spatial's rest
    parts = spans.idle_by(line)
    assert parts["collection"] == 6.0
    assert parts["record"] == WANT["record"] - 3
    assert parts["other"] == WANT["other"] - 3
    assert parts["copy"] == WANT["copy"] and parts["apply"] == WANT["apply"]


def test_syncs_leave_out_the_harness_sync_outside_the_spans():
    line = synthetic(calls=2)
    assert metric_reader("host_syncs_per_call")(line) == 1.0
    line.events.append(Event("cpu", "cudaMemcpy", 14.0, 15.0))  # a draw's pageable copy
    line.events.append(Event("cpu", "cudaMemcpyAsync", 16.0, 17.0))  # does not wait
    assert metric_reader("host_syncs_per_call")(line) == 1.5


def test_a_window_without_program_spans_reads_nothing():
    line = synthetic(program=False)
    got = read(line)
    assert got["host_exposed_ms_per_call"] is not None
    assert all(got[name] is None for name in METRICS)
    assert spans.idle_by(line) is None
    empty = Timeline(calls=[], events=synthetic().events, window=(0.0, 1.0))
    assert all(metric_reader(name)(empty) is None for name in METRICS)


def test_the_innermost_span_takes_the_time_and_the_breakdown_names_it():
    pieces = spans.innermost(sorted((lo, hi, name) for name, lo, hi in CALL_SPANS))
    assert pieces[:3] == [(1, 2, "other"), (2, 10, "copy"), (10, 13, "other")]
    assert sum(hi - lo for lo, hi, _ in pieces) == 98
    # the idle gap 45-70 has its middle in Spatial after its record
    gaps = trace.breakdown(synthetic(calls=1))["idle_gaps"]
    assert gaps[0] == ["tio.Spatial", pytest.approx(25e-6)]
