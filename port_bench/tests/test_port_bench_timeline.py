"""The run's arithmetic on synthetic timelines: the rate, the tail over
every call (with a stall), the union of busy intervals, the host time the
device does not hide, the idle share, the breakdown and a roofline."""

from __future__ import annotations

import pytest

from port_bench import timeline, trace
from port_bench.registry import metric_reader
from port_bench.timeline import Event, Timeline
from port_bench.yardstick import bound


def test_rate_counts_every_subject_over_the_wall_time():
    assert timeline.rate(8 * 150, 2.0) == 600.0


def test_p95_is_over_every_call_and_sees_a_stall():
    calls = [0.010] * 95 + [0.157] * 5
    assert timeline.percentile(calls, 95) == pytest.approx(0.010 + 0.05 * 0.147)
    calls = [0.010] * 94 + [0.157] * 6
    assert timeline.percentile(calls, 95) == pytest.approx(0.157)
    assert timeline.percentile([0.01], 95) == 0.01


def test_union_merges_overlaps_and_drops_empty_intervals():
    assert timeline.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5), (9, 9)]) == [
        (0, 4), (5, 7)]
    assert timeline.covered(timeline.union([(0, 2), (1, 3)])) == 3


def test_gaps_and_clip():
    busy = [(1, 2), (4, 6)]
    assert timeline.clip(busy, 1.5, 5) == [(1.5, 2), (4, 5)]
    assert timeline.gaps(busy, 0, 7) == [(0, 1), (2, 4), (6, 7)]


def synthetic() -> Timeline:
    """Two calls of 10 us; the second holds a 4 us idle stall. A copy
    between the calls (the harness's capture) is not the program's."""
    events = [
        Event("cpu", "aten::mul", 0.0, 1.0),
        Event("kernel", "void tio::row_kernel<Resample<false>, (tio::Source)1, true>", 1.0, 4.0),
        Event("kernel", "elementwise_kernel", 3.0, 6.0),  # overlaps the one before
        Event("cpu", "aten::exp", 6.0, 8.0),
        Event("memcpy", "Memcpy DtoH", 10.5, 11.5),  # between the calls
        Event("kernel", "segments_kernel<true, false, unsigned int>", 12.0, 14.0),
        Event("cpu", "aten::sort", 14.0, 19.0),
        Event("kernel", "elementwise_kernel", 18.0, 22.0),  # runs past the call's end
    ]
    return Timeline(calls=[(0.0, 10.0), (12.0, 20.0)], events=events, window=(0.0, 20.0))


def test_busy_is_the_union_inside_the_calls():
    line = synthetic()
    assert line.busy() == [(1.0, 6.0), (12.0, 14.0), (18.0, 20.0)]
    assert line.host_exposed() == [5.0, 4.0]
    assert metric_reader("host_exposed_ms_per_call")(line) == pytest.approx(4.5e-3)
    assert metric_reader("device_idle_pct")(line) == pytest.approx(100 * (1 - 9 / 20))


def test_torch_ops_leave_out_the_hand_written_kernels():
    line = synthetic()
    # the two elementwise kernels: 3 us and 4 us, over 2 calls
    assert metric_reader("torch_ops_ms_per_call")(line) == pytest.approx(3.5e-3)


def test_breakdown_names_the_longest_ops_and_gaps():
    got = trace.breakdown(synthetic())
    assert got["device_ops"][0] == ["elementwise_kernel", pytest.approx(7e-6)]
    assert len(got["device_ops"]) == 3
    assert got["idle_gaps"][0] == ["aten::exp", pytest.approx(4e-6)]
    assert got["idle_gaps"][1] == ["aten::sort", pytest.approx(4e-6)]


def test_roofline_is_the_bound_over_the_kernel_time():
    line = synthetic()
    line.work = {"resample": [(3.35e6, 0.0), (0.0, 0.0)]}  # 1 us of bytes in all
    assert metric_reader("resample_roofline")(line) == pytest.approx(100 * 1 / 3)
    assert bound(3.35e6, 0)[0] == pytest.approx(1e-3)


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = Timeline(calls=[(0.0, 1.0)], events=[Event("cpu", "aten::add", 0, 1)],
                     window=(0.0, 1.0))
    for name in ("host_exposed_ms_per_call", "torch_ops_ms_per_call", "device_idle_pct",
                 "resample_roofline", "threefry_roofline", "spline_roofline"):
        assert metric_reader(name)(empty) is None
    line = synthetic()
    assert metric_reader("spline_roofline")(line) is None  # no such kernel ran


def test_a_gap_during_a_garbage_collection_is_named_so():
    line = synthetic()
    line.collections = [(14.5, 17.5, 2)]
    got = trace.breakdown(line)
    assert got["idle_gaps"][0] == ["aten::exp", pytest.approx(4e-6)]
    assert got["idle_gaps"][1] == ["garbage collection (generation 2)", pytest.approx(4e-6)]
