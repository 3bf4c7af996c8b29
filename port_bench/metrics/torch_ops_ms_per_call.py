"""Device time a call of every operation that is none of the hand-written
kernels (those with a work function in ``work/``): PyTorch's own
kernels, cuFFT, copies and fills (ms)."""

from __future__ import annotations

from port_bench.registry import work_modules


def read(timeline):
    events = timeline.device_in_calls()
    if not timeline.calls or not events:
        return None
    kernels = work_modules().values()
    own = sum(e.end - e.start for e in events if not any(k.matches(e.name) for k in kernels))
    return own / len(timeline.calls) / 1e3
