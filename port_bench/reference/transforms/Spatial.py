"""Spatial: a random affine (scales, degrees, translation about the image
centre) and a random elastic field (a coarse grid of uniform
displacements, its borders held at zero), one draw an element, resampled
through one grid: scalar images linearly or by cubic B-spline with the
element's per-channel minimum outside the volume; label maps at the
nearest voxel or by partial-volume vote, padded with 0."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws
from port_bench.reference.sampling import points, prefilter, sample, spline, vote

NEEDS_FIRST = False
ORDERS = {"nearest": 0, "linear": 1, "cubic": 3, "bspline": 3}
SUPPORTED = {
    "scales", "degrees", "translation", "max_displacement", "num_control_points",
    "locked_borders", "image_interpolation", "label_interpolation", "p", "per_instance",
}


def _euler_rotation(degrees) -> np.ndarray:
    rx, ry, rz = np.radians(np.asarray(degrees, np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    r_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return r_z @ r_y @ r_x


def _forward_affine(scales, degrees, translation, shape, affine: np.ndarray) -> np.ndarray:
    """World-space 4x4 ``R @ S`` about the image centre, then the shift."""
    rs = _euler_rotation(degrees) @ np.diag(np.asarray(scales, np.float64))
    t = np.eye(4)
    t[:3, :3] = rs
    centre = affine[:3, 3] + affine[:3, :3] @ ((np.asarray(shape, np.float64) - 1) / 2)
    t[:3, 3] = centre - rs @ centre + np.asarray(translation, np.float64)
    return t


def _control_points(rng, grid, max_displacement, locked: int) -> np.ndarray:
    field = rng.uniform(-1.0, 1.0, size=tuple(grid) + (3,)).astype(np.float32)
    for axis in range(3):
        field[..., axis] *= max_displacement[axis]
    for border in range(locked):
        field[border, :] = 0
        field[-1 - border, :] = 0
        field[:, border] = 0
        field[:, -1 - border] = 0
        field[:, :, border] = 0
        field[:, :, -1 - border] = 0
    return field


def _element(args, rng, shape, affine):
    """(output -> input voxel map, coarse field in input voxels or None),
    or None where the draw holds no geometry."""
    scales = draws.sample(args.get("scales", 1.0), rng)
    degrees = draws.sample(args.get("degrees", 0.0), rng)
    translation = draws.sample(args.get("translation", 0.0), rng)
    displacement = draws.sample(args.get("max_displacement", 0.0), rng)
    field = None
    if any(v != 0.0 for v in displacement):
        grid = args.get("num_control_points", 7)
        grid = (grid,) * 3 if isinstance(grid, int) else tuple(grid)
        field = _control_points(rng, grid, displacement, args.get("locked_borders", 2))
    moved = scales != (1.0,) * 3 or degrees != (0.0,) * 3 or translation != (0.0,) * 3
    if not moved and field is None:
        return None
    forward = _forward_affine(scales, degrees, translation, shape, affine) if moved else np.eye(4)
    mapping = np.linalg.inv(affine) @ np.linalg.inv(forward) @ affine
    if field is not None:
        spacing = np.linalg.norm(affine[:3, :3], axis=0)
        field = (field.astype(np.float64) / spacing).astype(np.float32)
    return mapping, field


def draw(args: dict, rng, ctx):
    unknown = set(args) - SUPPORTED
    if unknown:
        raise NotImplementedError(f"the Spatial reference has no {sorted(unknown)}")
    if not draws.coin(args, rng, ctx.batch):
        return None
    first = next(iter(ctx.images.values()))
    shape, affine = first.shape, first.affine
    if not draws.per_instance(args, ctx.batch):
        return [_element(args, rng, shape, affine)] * ctx.batch
    keep = draws.keep_mask(args, rng, ctx.batch)
    return [
        _element(args, rng, shape, affine) if draws.kept(keep, b) else None
        for b in range(ctx.batch)
    ]


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    out = {}
    for name, image in ctx.images.items():
        volumes = []
        for r, b in enumerate(rows):
            vol = data[name][r]
            if params[b] is None:
                volumes.append(vol)
                continue
            ci, cj, ck = points(*params[b], image.shape, ctx.device)
            if image.kind == "label":
                how = args.get("label_interpolation", "nearest")
                if how == "label":
                    moved = vote(vol[0].to(torch.int32), ci, cj, ck, 0)[None]
                else:
                    zero = torch.zeros(vol.shape[0], device=ctx.device)
                    moved = sample(vol.to(torch.float32), ci, cj, ck, zero, how, False)
                volumes.append(moved.to(vol.dtype))
                continue
            order = ORDERS[args.get("image_interpolation", "linear")]
            fill = torch.amin(vol, dim=(-3, -2, -1))
            if order >= 2:
                moved = spline(prefilter(vol, order), ci, cj, ck, fill, order)
            else:
                moved = sample(vol, ci, cj, ck, fill, "linear" if order else "nearest", True)
            volumes.append(ctx.store(moved))
        out[name] = torch.stack(volumes)
    return out
