"""Motion: the k-space of each scalar image split along its first axis
into ``num_transforms + 1`` segments, every segment but the first taken
from the spectrum of a rigidly moved copy (a linear resample at dense
coordinates, no fill); the real part of the inverse FFT. The rigid map
keeps ``affine_grid``'s normalisation (rotation in (x, y, z) = (K, J, I)
normalised coordinates, translation over half the extent)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws
from port_bench.reference.sampling import points, sample

NEEDS_FIRST = False
SPATIAL = (-3, -2, -1)


def _axis_rotation(angle: float, axis: int) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3)
    a, b = [(1, 2), (0, 2), (0, 1)][axis]
    m[a, a] = m[b, b] = c
    m[a, b] = -s if axis != 1 else s
    m[b, a] = s if axis != 1 else -s
    return m


def rigid_voxel_matrix(degrees, translation, shape) -> np.ndarray:
    """Output-voxel -> input-voxel 4x4 map of one move."""
    rx, ry, rz = np.deg2rad(np.asarray(degrees, np.float64))
    r = _axis_rotation(rz, 2) @ _axis_rotation(ry, 1) @ _axis_rotation(rx, 0)
    si, sj, sk = (float(s) for s in shape)
    sizes_xyz = np.array([sk, sj, si])
    t_norm = np.asarray(translation, np.float64) / (np.array([si, sj, sk]) / 2)
    a = 2.0 / np.maximum(sizes_xyz - 1.0, 1.0)
    half = np.maximum(sizes_xyz - 1.0, 1.0) / 2.0
    a_xyz = half[:, None] * r * a[None, :]
    c_xyz = half * (r @ (-np.ones(3)) + t_norm + np.ones(3))
    perm = np.zeros((3, 3))
    perm[0, 2] = perm[1, 1] = perm[2, 0] = 1.0
    m = np.eye(4)
    m[:3, :3] = perm.T @ a_xyz @ perm
    m[:3, 3] = perm.T @ c_xyz
    return m


def draw(args: dict, rng, ctx):
    if not draws.coin(args, rng, ctx.batch):
        return None
    if not draws.per_instance(args, ctx.batch):
        raise NotImplementedError("the Motion reference draws one set of moves an element")
    keep = draws.keep_mask(args, rng, ctx.batch)
    count = int(args.get("num_transforms", 2))
    return [
        [
            {"degrees": draws.sample(args.get("degrees", 10.0), rng),
             "translation": draws.sample(args.get("translation", 10.0), rng)}
            for _ in range(count)
        ] if draws.kept(keep, b) else []
        for b in range(ctx.batch)
    ]


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = dict(data)
    moves = max(len(t) for t in params)
    for name in ctx.scalars():
        volumes = []
        for r, b in enumerate(rows):
            vol = data[name][r]
            if not params[b]:
                volumes.append(vol)
                continue
            volumes.append(ctx.store(_motion(vol.to(torch.float32), params[b], moves, ctx)))
        out[name] = torch.stack(volumes)
    return out


def _motion(vol, moves_of_element, moves: int, ctx):
    shape = tuple(vol.shape[1:])
    spectrum = torch.fft.fftn(vol, dim=SPATIAL)
    segments = moves + 1
    size = shape[0]
    width = size // segments
    zero = torch.zeros(vol.shape[0], device=ctx.device)
    for index in range(1, segments):
        move = moves_of_element[index - 1]
        matrix = rigid_voxel_matrix(move["degrees"], move["translation"], shape)
        moved = ctx.store(sample(vol, *points(matrix, None, shape, ctx.device), zero, "linear", False))
        start = index * width
        end = size if index == segments - 1 else start + width
        spectrum[:, start:end] = torch.fft.fftn(moved, dim=SPATIAL)[:, start:end]
    return torch.fft.ifftn(spectrum, dim=SPATIAL).real.contiguous()
