"""RescaleIntensity: each scalar image clipped to the input range, the
minimum and the maximum of the batch's first element (all its channels),
and mapped linearly to ``[out_min, out_max]``:
``(clip(v) - lo) / (hi - lo) * (out_max - out_min) + out_min`` in
float32. An input range of zero leaves the image as it is."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws

NEEDS_FIRST = True
SUPPORTED = {"out_min", "out_max"}


def draw(args: dict, rng, ctx):
    unknown = set(args) - SUPPORTED
    if unknown:
        raise NotImplementedError(f"the RescaleIntensity reference has no {sorted(unknown)}")
    # the program gates RescaleIntensity by one coin a batch, never per
    # element (no keep mask); then each element's output range
    if not draws.coin(args, rng, ctx.batch, per_element_p=False):
        return None
    return {key: np.asarray(draws.sample_1d(args.get(key, default), rng, ctx.batch), np.float32)
            for key, default in (("out_min", -1.0), ("out_max", 1.0))}


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    first = rows.index(0)
    out = dict(data)
    for name in ctx.scalars():
        x = data[name].to(torch.float32)
        lo, hi = x[first].min(), x[first].max()
        if hi == lo:
            out[name] = x
            continue
        volumes = []
        for r, b in enumerate(rows):
            out_min, out_max = (torch.tensor(params[k][b], device=ctx.device)
                                for k in ("out_min", "out_max"))
            scaled = (torch.clamp(x[r], lo, hi) - lo) / (hi - lo) * (out_max - out_min) + out_min
            volumes.append(ctx.store(scaled))
        out[name] = torch.stack(volumes)
    return out
