"""Idle device time a call while the transform engine deep-copies the
input: the calls' idle pieces under an innermost ``tio.<Transform>.copy``
span, averaged over the traced window's calls (ms; ``spans.py``).
Nothing where the window holds no program span."""

from __future__ import annotations

from port_bench.spans import phase_ms_per_call


def read(timeline):
    return phase_ms_per_call(timeline, "copy")
