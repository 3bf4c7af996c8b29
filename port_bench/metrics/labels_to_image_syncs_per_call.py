"""Host synchronisations a call inside LabelsToImage: the CUDA runtime's
calls that wait for the device (``spans.SYNCS``) that start inside the
spans LabelsToImage owns (``tio.LabelsToImage``,
``tio.LabelsToImage.<phase>``: the label census's reads, the pageable
uploads of each label's values), averaged over the traced window's
calls. Nothing where the window holds no such span."""

from __future__ import annotations

from port_bench.spans import syncs_per_call


def read(timeline):
    return syncs_per_call(timeline, "LabelsToImage")
