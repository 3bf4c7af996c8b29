"""Host synchronisations a call: the CUDA runtime's calls that wait for
the device (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy``) that start inside the
program's ``tio.*`` spans, averaged over the traced window's calls (the
harness's own synchronisation after each call lies outside them; see
``port_bench/spans.py``). Nothing where the window holds no program
span."""

from __future__ import annotations

from port_bench.spans import syncs_per_call


def read(timeline):
    return syncs_per_call(timeline)
