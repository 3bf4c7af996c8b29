"""Share of its roofline of the resample kernel (see ``work/resample.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "resample")
