"""Share of its roofline of the prefilter kernel (see ``work/prefilter.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "prefilter")
