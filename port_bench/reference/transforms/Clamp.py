"""Clamp: every scalar image clipped to ``[out_min, out_max]``."""

from __future__ import annotations

import torch

from port_bench.reference import draws

NEEDS_FIRST = False


def draw(args: dict, rng, ctx):
    return {} if draws.coin(args, rng, ctx.batch, per_element_p=False) else None


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = dict(data)
    for name in ctx.scalars():
        out[name] = ctx.store(torch.clamp(data[name], args.get("out_min"), args.get("out_max")))
    return out
