"""Volumes larger than one card's memory: file -> mesh -> file.

Counterpart of ``torchio_tpu/parallel/large.py``. The volume is read
LAZILY from disk in per-rank J slabs (the lazy ``Image.__getitem__``
region reads: uncompressed NIfTI windows through ``np.memmap``), each
slab lands on its own rank's device as that rank's region of a DTensor,
Spatial and Blur run through the halo-exchange programs (:mod:`.halo`),
and each rank writes its slab back into one ``.nii``. No host or device
ever holds the whole volume as one array.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .halo import halo_blur, halo_resample_spec
from .mesh import (
    NamedSharding,
    axis_index,
    axis_size,
    from_local,
    local_slices,
    mesh_device,
    sharding_of,
)


def shard_volume_from_file(image, mesh, *, space_axis: str = "space"):
    """A (1, C, I, J, K) float32 DTensor split along J over the mesh's
    ``space_axis``, each rank's slab read alone from ``image`` (a lazy
    ``tio.Image``): the whole volume is never read."""
    c, si, sj, sk = image.shape
    n_space = axis_size(mesh, space_axis)
    if sj % n_space:
        raise ValueError(f"J={sj} not divisible by space={n_space}")
    jl = sj // n_space
    j0 = axis_index(mesh, space_axis) * jl
    region = image[(slice(None), slice(None), slice(j0, j0 + jl), slice(None))]
    local = torch.as_tensor(region.data).to(device=mesh_device(mesh), dtype=torch.float32)
    sharding = NamedSharding(mesh, (None, None, None, space_axis, None))
    return from_local(local[None], sharding, (1, c, si, sj, sk))


def _writes_once(sharding: NamedSharding) -> bool:
    """Whether this rank writes its region: each region is written by the
    rank at coordinate 0 of every mesh axis that replicates it."""
    named = {a for a in sharding.spec if a is not None}
    coord = sharding.mesh.get_coordinate()
    return all(
        coord[d] == 0 for d, name in enumerate(sharding.mesh.mesh_dim_names) if name not in named
    )


def write_volume_sharded(out_path, sharded, affine=None) -> None:
    """Write a (1, C, I, J, K) DTensor to an uncompressed ``.nii``, each
    rank its own region (the host holds one slab): rank 0 writes the
    header and sizes the file, then every rank writes through
    ``np.memmap``. A whole tensor is written by the one process."""
    from ..io.nifti import _build_nifti1_header

    _, c, si, sj, sk = sharded.shape
    if affine is None:
        affine = np.eye(4)
    disk_shape = (si, sj, sk) if c == 1 else (si, sj, sk, c)
    header = _build_nifti1_header(disk_shape, np.dtype(np.float32), affine)
    out_path = Path(out_path)
    sharding = sharding_of(sharded)
    rank0 = sharding is None or dist.get_rank() == 0
    if rank0:
        with open(out_path, "wb") as f:
            f.write(header)
            f.truncate(len(header) + int(np.prod(disk_shape)) * 4)
    if sharding is not None:
        dist.barrier()
    if sharding is None or _writes_once(sharding):
        if sharding is None:
            slab, region = torch.as_tensor(sharded)[0], (slice(None),) * 3
        else:
            slab = sharded.to_local()[0]
            region = local_slices(sharded.shape, sharding)[2:]
        slab = slab.detach().to(torch.float32).cpu().numpy()  # (C, i, jl, k)
        mm = np.memmap(out_path, dtype=np.float32, mode="r+", offset=len(header),
                       shape=disk_shape, order="F")
        if c == 1:
            mm[region] = slab[0]
        else:
            mm[(*region, slice(None))] = np.moveaxis(slab, 0, -1)
        mm.flush()
        del mm
    if sharding is not None:
        dist.barrier()


def process_large_volume(
    source,
    out_path,
    *,
    mesh,
    space_axis: str = "space",
    matrix=None,
    control_points=None,
    sigma: float | None = None,
    mode: str = "linear",
    fill: float = 0.0,
):
    """Lazy file -> J-sharded mesh -> halo Spatial (+ Blur) -> file.

    ``matrix`` is a 4x4 output->input voxel map (augmentation-style:
    output space equals input space), ``control_points`` an optional
    coarse elastic displacement field, ``sigma`` an optional Gaussian
    blur (voxels) along the sharded axis. Returns the sharded result
    (also written to ``out_path``).
    """
    from ..data.image import ScalarImage

    image = source if hasattr(source, "shape") else ScalarImage(source)
    sharded = shard_volume_from_file(image, mesh, space_axis=space_axis)
    if matrix is not None or control_points is not None:
        m = np.eye(4) if matrix is None else np.asarray(matrix, np.float64)
        sharded = halo_resample_spec(
            sharded, [m], [control_points], sharding=sharding_of(sharded), mode=mode, fill=fill
        )
    if sigma is not None:
        sharded = halo_blur(sharded, sigma, mesh)
    write_volume_sharded(out_path, sharded, np.asarray(image.affine.data))
    return sharded
