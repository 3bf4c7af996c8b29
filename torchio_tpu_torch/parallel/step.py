"""The fused augmentation step, on one device or sharded over a mesh.

Counterpart of ``torchio_tpu/parallel/step.py``. Per batch element: an
affine resample (rotation and shift about the image centre), a
multiplicative bias field, additive Gaussian noise; then a rescale of the
whole batch to [0, 1] by its GLOBAL minimum and maximum.

:func:`augment_step` runs it on whole tensors. :func:`make_augment_step`
returns the sharded step: each rank resamples its J slab through the halo
program's local function (:mod:`.halo`), draws only its batch rows of the
global bias draw and only its rows and J columns of the noise draw (a
counter base and a strided segment, one launch of ``csrc/threefry.cu``
on a card), upsamples only its J rows of the bias field, and takes the
global statistics with one ``all_reduce`` each.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist

from .. import random as tio_random
from ..ops.resample import resample
from .halo import (
    HaloUnsupported,
    _exchange_halo_zero,
    _halo_width,
    _upsample_field_slab,
    halo_resample_local,
)
from .mesh import (
    axis_index,
    axis_size,
    batch_sharding,
    from_local,
    is_dtensor,
    mesh_device,
    place,
)


def sample_step_params(batch_size: int, *, degrees=10.0, translation=2.0):
    """Host-side parameter sampling: (B, 3, 3) rotations + (B, 3) shifts."""
    from ..transforms.spatial.spatial import _euler_rotation

    rng = tio_random.get_rng()
    rots = np.stack(
        [_euler_rotation(rng.uniform(-degrees, degrees, 3)) for _ in range(batch_size)]
    ).astype(np.float32)
    shifts = rng.uniform(-translation, translation, (batch_size, 3)).astype(np.float32)
    return rots, shifts


def _inverse_rotations(rotations) -> np.ndarray:
    """(B, 3, 3) float32 inverses, each by LAPACK's float32 LU solve (the
    factorisation ``jnp.linalg.inv`` runs: equal bit for bit)."""
    from scipy.linalg import lu_factor, lu_solve

    rots = np.asarray(rotations, np.float32).reshape(-1, 3, 3)
    eye = np.eye(3, dtype=np.float32)
    return np.stack([lu_solve(lu_factor(r), eye) for r in rots]).astype(np.float32)


def _step_planes(inv, shift, spatial, j0: int, jl: int):
    """Three (I, jl, K) float32 input-voxel coordinate arrays of the
    output rows ``[j0, j0 + jl)`` of one element, in the JAX package's
    order: ``((i - ci) inv_0 + (j - cj) inv_1 + (k - ck) inv_2 + c) -
    shift``, about the centre ``c = (shape - 1) / 2``."""
    si, sj, sk = spatial
    dev = inv.device
    center = torch.tensor([(si - 1) / 2, (sj - 1) / 2, (sk - 1) / 2], dtype=torch.float32,
                          device=dev)
    ri = torch.arange(si, dtype=torch.float32, device=dev)[:, None, None]
    rj = (torch.arange(jl, dtype=torch.float32, device=dev) + float(j0))[None, :, None]
    rk = torch.arange(sk, dtype=torch.float32, device=dev)[None, None, :]
    return tuple(
        (ri - center[0]) * inv[a, 0] + (rj - center[1]) * inv[a, 1]
        + (rk - center[2]) * inv[a, 2] + center[a] - shift[a]
        for a in range(3)
    )


def _coarse_shape(spatial) -> tuple[int, int, int]:
    return tuple(max(s // 8, 2) for s in spatial)


def _bias_and_noise(seed, b0: int, bl: int, shape, j0: int, jl: int, bias_std, noise_std,
                    device):
    """This rank's rows ``[b0, b0 + bl)`` and J rows ``[j0, j0 + jl)`` of
    ``exp(upsample(bias_std * normal(kb, (B, 1, *coarse))))`` and of
    ``noise_std * normal(kn, (B, C, I, J, K))``, ``kb, kn =
    split(PRNGKey(seed))``: both draws in one ``normals`` call (one
    threefry launch on a card), the coarse rows from their counter base,
    the noise as one strided segment of the rank's elements alone."""
    c, si, sj, sk = shape
    kb, kn = tio_random.split(tio_random.prng_key(int(seed)))
    small = _coarse_shape((si, sj, sk))
    per_coarse = math.prod(small)
    start, count, run, pitch = tio_random.slab_span((b0 + bl, c, si, sj, sk), b0, bl, j0, jl)
    flat = tio_random.normals(
        [kb, kn],
        [(bl, 1, *small), (count,)],
        [bias_std, noise_std],
        device,
        starts=[b0 * per_coarse, start],
        runs=[None, run],
        pitches=[None, pitch],
    )
    coarse = flat[: bl * per_coarse].reshape(bl, 1, *small)
    noise = flat[bl * per_coarse:].reshape(bl, c, si, jl, sk)
    field = _upsample_field_slab(coarse, (si, sj, sk), j0, jl, first=2)
    return torch.exp(field), noise


def _rescale(out: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (out - lo) / torch.clamp(hi - lo, min=1e-6)


def augment_step(data, rotations, shifts, seed, bias_std, noise_std) -> torch.Tensor:
    """The step on whole (B, C, I, J, K) tensors, on ``data``'s device (the
    reference of the sharded step): the resample is the dense-coordinate
    kernel at a zero fill."""
    data = torch.as_tensor(data)
    b, c, si, sj, sk = data.shape
    dev = data.device
    inv = torch.as_tensor(_inverse_rotations(rotations), device=dev)
    shift = torch.as_tensor(np.asarray(shifts, np.float32), device=dev)
    coords = torch.stack(
        [torch.stack(_step_planes(inv[e], shift[e], (si, sj, sk), 0, sj), dim=-1) for e in range(b)]
    )
    out = resample(data.to(torch.float32), coords, mode="linear", fill=0.0)
    field, noise = _bias_and_noise(seed, 0, b, (c, si, sj, sk), 0, sj, bias_std, noise_std, dev)
    out = out * field + noise
    return _rescale(out, out.min(), out.max())


def _step_maps(inv: np.ndarray, shifts, spatial) -> np.ndarray:
    """(B, 4, 4) float64 output -> input maps of the step (for the halo
    width only)."""
    center = (np.asarray(spatial, np.float64) - 1) / 2
    maps = np.tile(np.eye(4), (inv.shape[0], 1, 1))
    maps[:, :3, :3] = inv
    maps[:, :3, 3] = center - inv.astype(np.float64) @ center - np.asarray(shifts, np.float64)
    return maps


def _sharded_step(data, rotations, shifts, seed, *, mesh, bias_std, noise_std):
    sharding = batch_sharding(mesh)
    data_ax, space_ax = mesh.mesh_dim_names
    b, c, si, sj, sk = data.shape
    n_data, n_space = axis_size(mesh, data_ax), axis_size(mesh, space_ax)
    if b % n_data or sj % n_space:
        raise ValueError(f"(B, J) = ({b}, {sj}) not divisible by the mesh ({n_data}, {n_space})")
    bl, jl = b // n_data, sj // n_space
    b0, j0 = axis_index(mesh, data_ax) * bl, axis_index(mesh, space_ax) * jl
    dev = mesh_device(mesh)
    inv = _inverse_rotations(rotations)
    # one width for the whole batch: every rank must agree on it
    halo = _halo_width(_step_maps(inv, shifts, (si, sj, sk)), None, si, sj, sk)
    if halo >= jl:
        raise HaloUnsupported(f"halo {halo} >= local shard width {jl}")
    xs = place(data if is_dtensor(data) else torch.as_tensor(data), sharding)
    xs = xs.to_local().to(torch.float32)
    inv_t = torch.as_tensor(inv[b0:b0 + bl], device=dev)
    shift_t = torch.as_tensor(np.asarray(shifts, np.float32)[b0:b0 + bl], device=dev)
    planes = [_step_planes(inv_t[e], shift_t[e], (si, sj, sk), j0, jl) for e in range(bl)]
    ext = _exchange_halo_zero(xs, halo, mesh.get_group(space_ax))
    out = halo_resample_local(
        ext, planes, xs.new_zeros((bl, c)), j0=j0, halo=halo, spatial=(si, sj, sk),
        mode="linear", apply_fill=False,
    )
    field, noise = _bias_and_noise(seed, b0, bl, (c, si, sj, sk), j0, jl, bias_std, noise_std,
                                   dev)
    out = out * field + noise
    lo, hi = out.min(), out.max()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return from_local(_rescale(out, lo, hi), sharding, data.shape)


def make_augment_step(mesh, *, bias_std: float = 0.3, noise_std: float = 0.05):
    """The step on ``mesh``: a callable ``(data, rotations, shifts, seed)
    -> DTensor`` with the batch sharding (B over 'data', J over 'space').
    ``data`` is a DTensor or a whole tensor (every rank the same);
    ``rotations`` (B, 3, 3), ``shifts`` (B, 3) and ``seed`` are the same
    host values on every rank. Where the rotation's halo does not fit a
    J slab, it warns and runs the whole batch on every rank."""

    def step(data, rotations, shifts, seed):
        seed = int(seed)
        try:
            return _sharded_step(data, rotations, shifts, seed, mesh=mesh,
                                 bias_std=bias_std, noise_std=noise_std)
        except HaloUnsupported as reason:
            warnings.warn(
                f"Sharded augment step fell back to the all-gather path: {reason}",
                RuntimeWarning,
                stacklevel=2,
            )
        whole = data.full_tensor() if is_dtensor(data) else torch.as_tensor(data)
        out = augment_step(whole.to(mesh_device(mesh)), rotations, shifts, seed, bias_std,
                           noise_std)
        return place(out, batch_sharding(mesh))

    return step
