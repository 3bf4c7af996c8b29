"""Share of its roofline of the label_vote kernel (see ``work/label_vote.py``)."""

from port_bench.roofline import share


def read(timeline):
    return share(timeline, "label_vote")
