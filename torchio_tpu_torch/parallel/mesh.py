"""Device mesh and sharding records for multi-GPU preprocessing.

Counterpart of ``torchio_tpu/parallel/mesh.py`` on PyTorch's own
distributed stack. The (B, C, I, J, K) batch is sharded over a 2D
:class:`~torch.distributed.device_mesh.DeviceMesh` of the job's ranks
(one GPU a rank):

- ``data``: batch-parallel; each rank augments its own subjects;
- ``space``: the J axis split into slabs, for volumes larger than one
  card's memory; stencils exchange halos with their neighbours
  (:mod:`.halo`), and global statistics take one ``all_reduce``.

A sharded tensor is a :class:`~torch.distributed.tensor.DTensor` of the
global shape. :class:`NamedSharding` is the port's record of where it
lies: a mesh and a 5-entry spec of mesh axis names or None, as the JAX
package's ``NamedSharding(mesh, PartitionSpec(...))``, with the DTensor
``placements`` it stands for.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any

import torch


def is_dtensor(value: Any) -> bool:
    """Whether ``value`` is a DTensor (never imports the DTensor module:
    where it is not imported, nothing can be one)."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(value, module.DTensor)


def make_mesh(
    device_type: str | None = None,
    *,
    axis_names: tuple[str, str] = ("data", "space"),
    space: int | None = None,
):
    """A ``(world // space, space)`` DeviceMesh over the job's ranks.

    ``device_type`` is ``"cuda"`` unless given (``"cpu"`` for gloo);
    ``space`` defaults to 2 when the world size is even and above 1,
    else 1. The process group must be initialised first (``torchrun``
    does it from its environment).
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised process group: start the job with"
            " `torchrun --nproc-per-node N ...` and call"
            " torch.distributed.init_process_group() (NCCL on GPUs, gloo on the"
            " CPU), or pass it init_method, world_size and rank yourself"
        )
    n = dist.get_world_size()
    if space is None:
        space = 2 if n % 2 == 0 and n > 1 else 1
    if n % space != 0:
        raise ValueError(f"{n} devices not divisible by space={space}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(
        device_type or "cuda", (n // space, space), mesh_dim_names=tuple(axis_names)
    )


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: entry ``d`` names the mesh axis that splits
    tensor dim ``d``, or is None (a short spec leaves the later dims
    whole)."""

    mesh: Any
    spec: tuple

    def padded(self, ndim: int = 5) -> tuple:
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    @property
    def placements(self) -> tuple:
        """The DTensor placements: ``Shard(d)`` on the mesh axis named at
        spec entry ``d``, ``Replicate()`` on a mesh axis named nowhere."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, axis in enumerate(self.spec) if axis == name]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def batch_sharding(mesh) -> NamedSharding:
    """(B, C, I, J, K): B over 'data', J over 'space'."""
    names = mesh.mesh_dim_names
    return NamedSharding(mesh, (names[0], None, None, names[1], None))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def param_sharding(mesh) -> NamedSharding:
    """Per-element parameter arrays (B, ...): B over 'data'."""
    return NamedSharding(mesh, (mesh.mesh_dim_names[0],))


def axis_size(mesh, name: str) -> int:
    """The number of ranks along the mesh axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the mesh axis ``name``."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """Rows ``[start, stop)`` of part ``index`` of ``n`` rows split into
    ``parts`` (``torch.chunk``'s split, which DTensor's ``Shard`` uses)."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


def local_slices(shape, sharding: NamedSharding) -> tuple[slice, ...]:
    """This rank's region of a tensor of ``shape`` placed by ``sharding``."""
    slices = [slice(None)] * len(shape)
    coord = sharding.mesh.get_coordinate()
    for mesh_dim, name in enumerate(sharding.mesh.mesh_dim_names):
        for dim, axis in enumerate(sharding.spec):
            if axis == name:
                start, stop = shard_range(
                    int(shape[dim]), sharding.mesh.size(mesh_dim), coord[mesh_dim]
                )
                slices[dim] = slice(start, stop)
    return tuple(slices)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= int(n)
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, sharding: NamedSharding, shape):
    """The DTensor of global ``shape`` whose region on this rank is
    ``local`` (no communication)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(s) for s in shape)
    return DTensor.from_local(
        local.contiguous(),
        sharding.mesh,
        sharding.placements,
        run_check=False,
        shape=torch.Size(shape),
        stride=_contiguous_stride(shape),
    )


def place(value: torch.Tensor, sharding: NamedSharding):
    """``value`` placed by ``sharding``. A whole tensor (the same on every
    rank) keeps only this rank's region, with no communication; a DTensor
    placed otherwise is gathered first."""
    if is_dtensor(value):
        if value.device_mesh == sharding.mesh and tuple(value.placements) == sharding.placements:
            return value
        value = value.full_tensor()
    device = mesh_device(sharding.mesh)
    if value.device != device:
        value = value.to(device)
    return from_local(value[local_slices(value.shape, sharding)], sharding, value.shape)


def shard_batch(data, mesh):
    """Place a (B, C, I, J, K) tensor on the mesh with batch + spatial
    sharding: a DTensor of the global shape."""
    from ..config import as_tensor

    return place(as_tensor(data), batch_sharding(mesh))


def sharding_of(value) -> NamedSharding | None:
    """The :class:`NamedSharding` of a DTensor (None for anything else):
    each ``Shard(d)`` names its mesh axis at spec entry ``d``."""
    if not is_dtensor(value):
        return None
    spec: list = [None] * value.ndim
    for name, placement in zip(value.device_mesh.mesh_dim_names, value.placements):
        if placement.is_shard():
            spec[placement.dim] = name
    return NamedSharding(value.device_mesh, tuple(spec))
