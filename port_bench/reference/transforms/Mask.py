"""Mask: every scalar image set to ``outside_value`` where the first
element of the label map ``masking_method`` holds none of ``labels``
(where it is 0 when ``labels`` is not given)."""

from __future__ import annotations

import torch

from port_bench.reference import draws

NEEDS_FIRST = True


def draw(args: dict, rng, ctx):
    return {} if draws.coin(args, rng, ctx.batch, per_element_p=False) else None


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    labels = data[args.get("masking_method", "brain")][rows.index(0)]
    if args.get("labels") is None:
        mask = labels != 0
    else:
        mask = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
        for label in args["labels"]:
            mask |= labels == label
    out = dict(data)
    for name in ctx.scalars():
        out[name] = ctx.store(torch.where(mask, data[name], float(args.get("outside_value", 0.0))))
    return out
