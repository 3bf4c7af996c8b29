"""Noise: each scalar image ``n`` plus ``mean + std * N(0, 1)``, the field
drawn by threefry under key ``2 n + 1`` of the call's recorded seed over
the whole batch, an element its own rows of it."""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import draws
from port_bench.reference.threefry import draw_key, normals

NEEDS_FIRST = False


def draw(args: dict, rng, ctx):
    if args.get("rician"):
        raise NotImplementedError("the Noise reference draws Gaussian noise")
    if not draws.coin(args, rng, ctx.batch):
        return None
    recorded = draws.seed(rng)
    n = ctx.batch if draws.per_instance(args, ctx.batch) else None
    keep = draws.keep_mask(args, rng, ctx.batch)
    mean = draws.sample_1d(args.get("mean", 0.0), rng, n)
    std = draws.sample_1d(args.get("std", 0.25), rng, n)
    if n is None:
        mean, std = np.full(ctx.batch, mean), np.full(ctx.batch, std)
    elif keep is not None:
        mean, std = np.where(keep, mean, 0.0), np.where(keep, std, 0.0)
    return {"seed": recorded, "keep": keep, "mean": np.asarray(mean, np.float32),
            "std": np.asarray(std, np.float32)}


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = dict(data)
    for n, name in enumerate(ctx.scalars()):
        image = ctx.images[name]
        count = image.channels * math.prod(image.shape)
        key = draw_key(params["seed"], 2 * n + 1)
        volumes = []
        for r, b in enumerate(rows):
            vol = data[name][r]
            if not draws.kept(params["keep"], b):
                volumes.append(vol)
                continue
            field = normals(key, b * count, count, ctx.device).reshape(vol.shape)
            mean, std = (torch.tensor(params[k][b], dtype=torch.float32, device=ctx.device)
                         for k in ("mean", "std"))
            volumes.append(ctx.store(vol + (mean + std * field)))
        out[name] = torch.stack(volumes)
    return out
