"""Idle device time a call while the transform engine draws on the host:
the calls' idle pieces under an innermost ``tio.<Transform>.draw`` span
(``make_params``; a fused run's p-gate coins and ``fused_stage``),
averaged over the traced window's calls (ms; ``spans.py``). Nothing
where the window holds no program span."""

from __future__ import annotations

from port_bench.spans import phase_ms_per_call


def read(timeline):
    return phase_ms_per_call(timeline, "draw")
