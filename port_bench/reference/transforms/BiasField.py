"""BiasField: each scalar image times ``exp`` of a coarse N(0, std) field
(a side of the volume times ``scale``, at least 4), drawn by threefry
under the element's recorded seed and upsampled trilinearly."""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import draws
from port_bench.reference.sampling import upsample_volume
from port_bench.reference.threefry import draw_key, normals

NEEDS_FIRST = False


def draw(args: dict, rng, ctx):
    if not draws.coin(args, rng, ctx.batch):
        return None
    if not draws.per_instance(args, ctx.batch):
        raise NotImplementedError("the BiasField reference draws one field an element")
    keep = draws.keep_mask(args, rng, ctx.batch)
    std = draws.sample_1d(args.get("std", 0.5), rng, ctx.batch)
    if keep is not None:
        std = np.where(keep, std, 0.0)
    seeds = [draws.seed(rng) for _ in range(ctx.batch)]
    return {"std": np.asarray(std, np.float32), "seed": seeds}


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    scale = float(args.get("scale", 0.025))
    out = dict(data)
    for name in ctx.scalars():
        shape, c = ctx.images[name].shape, ctx.images[name].channels
        small = tuple(max(round(s * scale), 4) for s in shape)
        volumes = []
        for r, b in enumerate(rows):
            vol, std = data[name][r], params["std"][b]
            if std == 0:
                volumes.append(vol)
                continue
            key = draw_key(params["seed"][b], 0)
            coarse = normals(key, 0, c * math.prod(small), ctx.device).reshape(1, c, *small)
            coarse = coarse * torch.tensor(std, dtype=torch.float32, device=ctx.device)
            field = torch.exp(upsample_volume(coarse, shape))[0]
            volumes.append(ctx.store(vol * field))
        out[name] = torch.stack(volumes)
    return out
