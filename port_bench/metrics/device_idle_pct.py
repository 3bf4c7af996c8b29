"""The device's idle share of the traced window: 100 x (1 - the union of
its kernels', copies' and fills' intervals inside the calls / the
window's wall time)."""

from __future__ import annotations

from port_bench.timeline import covered


def read(timeline):
    busy = covered(timeline.busy())
    wall = timeline.window[1] - timeline.window[0]
    if busy <= 0 or wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
