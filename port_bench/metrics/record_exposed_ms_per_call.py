"""Idle device time a call while the transform engine records the
history: the calls' idle pieces under an innermost
``tio.<Transform>.record`` span (``record_history``, a fused stage's
``finish``, the result's copy of the history), averaged over the traced
window's calls (ms; ``spans.py``). Nothing where the window holds no
program span."""

from __future__ import annotations

from port_bench.spans import phase_ms_per_call


def read(timeline):
    return phase_ms_per_call(timeline, "record")
