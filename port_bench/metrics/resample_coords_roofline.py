"""Share of its roofline of the resample_coords kernel (see ``work/resample_coords.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "resample_coords")
