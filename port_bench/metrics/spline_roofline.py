"""Share of its roofline of the spline kernel (see ``work/spline.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "spline")
