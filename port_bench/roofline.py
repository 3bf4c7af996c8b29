"""A kernel's share of its roofline in a traced window: the least time
of the work its calls gave it (``work/<kernel>.py`` and
``yardstick.bound``) over the device time of its launches."""

from __future__ import annotations

from port_bench.registry import work_module
from port_bench.timeline import Timeline
from port_bench.yardstick import bound


def share(timeline: Timeline, kernel: str) -> float | None:
    """100 x bound / time, or None where the window ran no such kernel or
    gave it no work."""
    module = work_module(kernel)
    time_us = sum(e.end - e.start for e in timeline.device_in_calls() if module.matches(e.name))
    least_ms = sum(bound(nbytes, flops)[0] for nbytes, flops in timeline.work.get(kernel, []))
    if time_us <= 0 or least_ms <= 0:
        return None
    return 100.0 * least_ms / (time_us / 1e3)
