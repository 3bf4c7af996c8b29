"""Idle device time a call while LabelsToImage holds the host: the calls'
idle pieces under an innermost span that LabelsToImage owns
(``tio.LabelsToImage``, ``tio.LabelsToImage.<phase>``: the label census,
the host draws, the per-label loop that enqueues each label's draw and
passes), averaged over the traced window's calls (ms; ``spans.py``).
Nothing where the window holds no such span."""

from __future__ import annotations

from port_bench.spans import owner_ms_per_call


def read(timeline):
    return owner_ms_per_call(timeline, "LabelsToImage")
