"""ZNormalization: every scalar image standardised batch-wide by the mean
and the sample standard deviation (ddof 1) of the batch's first element,
over the voxels where the first element of the label map
``masking_method`` is not 0 (all channels together)."""

from __future__ import annotations

import torch

from port_bench.reference import draws

NEEDS_FIRST = True


def draw(args: dict, rng, ctx):
    return {} if draws.coin(args, rng, ctx.batch, per_element_p=False) else None


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    first = rows.index(0)
    mask_name = args.get("masking_method")
    out = dict(data)
    for name in ctx.scalars():
        x = data[name][first].to(torch.float64)
        if mask_name is None:
            values = x.reshape(-1)
        else:
            values = x[torch.broadcast_to(data[mask_name][first] != 0, x.shape)]
        mean = values.mean()
        std = torch.sqrt(((values - mean) ** 2).sum() / (values.numel() - 1))
        mean32, std32 = mean.to(torch.float32), std.to(torch.float32)
        out[name] = ctx.store((data[name].to(torch.float32) - mean32) / std32)
    return out
