"""Host time a call that the device does not hide: each call's wall time
minus the union of the device's busy intervals inside it, averaged over
the traced window's calls (ms). Nothing where the device ran nothing."""

from __future__ import annotations


def read(timeline):
    if not timeline.calls or not timeline.device_in_calls():
        return None
    exposed = timeline.host_exposed()
    return sum(exposed) / len(exposed) / 1e3
