"""Gamma: each scalar image ``sign(v) |v| ** exp(beta)``, with ``beta``
drawn from ``log_gamma`` for each element (float32, the exponent
``exp`` of the drawn value rounded to float32)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws

NEEDS_FIRST = False
SUPPORTED = {"log_gamma"}


def draw(args: dict, rng, ctx):
    unknown = set(args) - SUPPORTED
    if unknown:
        raise NotImplementedError(f"the Gamma reference has no {sorted(unknown)}")
    # the coin, then the ranges: with no ``p`` the program draws no keep mask
    if not draws.coin(args, rng, ctx.batch):
        return None
    beta = draws.sample_1d(args.get("log_gamma", 0.0), rng, ctx.batch)
    return {"log_gamma": np.asarray(beta, np.float32)}


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = dict(data)
    for name in ctx.scalars():
        volumes = []
        for r, b in enumerate(rows):
            v = data[name][r]
            gamma = torch.exp(torch.tensor(params["log_gamma"][b], device=ctx.device))
            volumes.append(ctx.store(torch.sign(v) * torch.abs(v) ** gamma))
        out[name] = torch.stack(volumes)
    return out
