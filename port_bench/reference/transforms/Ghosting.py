"""Ghosting: every ``size // num_ghosts``-th line of the centred spectrum
along a drawn axis scaled by ``1 - intensity`` (a central band of width
``restore`` left as it is); the real part of the inverse FFT."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws

NEEDS_FIRST = False
SPATIAL = (-3, -2, -1)


def line_mask(size: int, ghosts: int, intensity: float, restore: float) -> np.ndarray:
    mask = np.ones(size, np.float32)
    step = max(size // ghosts, 1)
    mask[::step] = 1.0 - intensity
    if restore > 0:
        mid = size // 2
        half = max(int(size * restore / 2), 1)
        mask[mid - half:mid + half] = 1.0
    return mask


def draw(args: dict, rng, ctx):
    axes = tuple(args.get("axes", (0, 1, 2)))
    if not draws.coin(args, rng, ctx.batch):
        return None
    if not draws.per_instance(args, ctx.batch):
        raise NotImplementedError("the Ghosting reference draws one set of lines an element")
    keep = draws.keep_mask(args, rng, ctx.batch)
    drawn = []
    for b in range(ctx.batch):
        if not draws.kept(keep, b):
            drawn.append(None)
            continue
        ghosts = max(1, round(draws.sample_1d(args.get("num_ghosts", 4), rng)))
        axis = int(axes[rng.integers(len(axes))])
        intensity = float(draws.sample_1d(args.get("intensity", 0.0), rng))
        drawn.append((ghosts, axis, intensity))
    return drawn


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    restore = args.get("restore") or 0.0
    out = dict(data)
    for name in ctx.scalars():
        volumes = []
        for r, b in enumerate(rows):
            vol = data[name][r]
            if params[b] is None or params[b][2] == 0:
                volumes.append(vol)
                continue
            ghosts, axis, intensity = params[b]
            shape = [1, 1, 1, 1]
            shape[axis + 1] = vol.shape[axis + 1]
            line = np.fft.ifftshift(line_mask(vol.shape[axis + 1], ghosts, intensity, restore))
            mask = torch.as_tensor(line.reshape(shape), device=ctx.device)
            spectrum = torch.fft.fftn(vol.to(torch.float32), dim=SPATIAL) * mask
            volumes.append(ctx.store(torch.fft.ifftn(spectrum, dim=SPATIAL).real.contiguous()))
        out[name] = torch.stack(volumes)
    return out
