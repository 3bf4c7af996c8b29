"""Share of its roofline of the threefry kernel (see ``work/threefry.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "threefry")
