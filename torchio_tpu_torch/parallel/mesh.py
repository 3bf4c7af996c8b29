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

import numpy as np
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
    def splits_c_i_or_k(self) -> bool:
        """Whether a mesh axis of more than one rank splits C, I or K of the
        (B, C, I, J, K) batch. The stages' region paths split B and J only,
        so on such a sharding each stage runs on the whole tensor (gathered
        for it, then placed again), as XLA all-gathers where it cannot
        partition. A spec entry naming a one-rank axis leaves its dim whole
        and counts for nothing."""
        padded = self.padded()
        return any(
            padded[d] is not None and axis_size(self.mesh, padded[d]) > 1 for d in (1, 2, 4)
        )

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


@dataclass(frozen=True)
class Region:
    """A stage's view of a tensor on this rank: its block of the global
    tensor (``local``), the block's first index along each dim
    (``starts``: ``b0`` on B, ``j0`` on J of a (B, C, I, J, K) batch), the
    global ``shape``, and the sharding that placed it (None for a plain
    tensor, which is its own whole region, or for a block a caller cut
    by hand: the local program of one shard).

    A pointwise stage maps ``local`` and :meth:`wrap` s the result; a draw
    reads ``shape`` and ``starts``; a statistic reduces over the process
    groups of the mesh axes that split the dims it reads (:meth:`group`).
    """

    local: torch.Tensor
    shape: tuple[int, ...]
    starts: tuple[int, ...]
    sharding: NamedSharding | None = None

    @property
    def b0(self) -> int:
        return self.starts[0]

    @property
    def j0(self) -> int:
        return self.starts[3]

    @property
    def rows(self) -> slice:
        """This region's B rows of the global tensor."""
        return slice(self.b0, self.b0 + int(self.local.shape[0]))

    @property
    def cols(self) -> slice:
        """This region's J columns of the global (B, C, I, J, K) tensor."""
        return slice(self.j0, self.j0 + int(self.local.shape[3]))

    @property
    def whole(self) -> bool:
        """Whether the region is the whole tensor."""
        return tuple(self.local.shape) == tuple(self.shape)

    def split(self, dim: int) -> bool:
        """Whether the mesh splits ``dim`` (a region cut by hand: whether
        it is part of ``dim``)."""
        if self.sharding is None:
            return int(self.local.shape[dim]) != int(self.shape[dim])
        return self.sharding.padded(len(self.shape))[dim] is not None

    def group(self, dim: int):
        """The process group of the mesh axis that splits ``dim`` (None
        where no mesh axis does)."""
        if self.sharding is None:
            return None
        name = self.sharding.padded(len(self.shape))[dim]
        return None if name is None else self.sharding.mesh.get_group(name)

    @property
    def data_group(self):
        return self.group(0)

    @property
    def space_group(self):
        return self.group(3)

    @property
    def holds_first(self) -> bool:
        """Whether this rank holds (its columns of) batch element 0, which
        the batch-wide statistics read."""
        return self.b0 == 0 and int(self.local.shape[0]) > 0

    def check_aligned(self, other: "Region") -> None:
        """Raise unless ``other`` (a mask's region) covers the same spatial
        block as this region: its voxels pair with this region's."""
        if other.starts[2:] != self.starts[2:] or (
            tuple(other.local.shape[2:]) != tuple(self.local.shape[2:])
        ):
            raise ValueError(
                f"the mask's region at {other.starts} is not the image's at {self.starts}:"
                " shard both with the same batch"
            )

    def take(self, value: Any) -> Any:
        """This region's rows of a per-element value: a list, array or
        tensor with one entry for each element of the global batch. A
        value every element shares comes as a scalar (a number, None, or
        a 0-d array or tensor) and passes through. A batch-wide vector (a
        statistic, an input range) is neither and must not come here: the
        caller says what is per-element by passing it, and a value whose
        length is not the batch's raises."""
        if value is None or isinstance(value, (int, float, np.generic)):
            return value
        if not isinstance(value, (list, np.ndarray, torch.Tensor)):
            raise TypeError(f"a per-element value is a list, array or tensor, not {type(value)}")
        if not isinstance(value, list) and value.ndim == 0:
            return value
        b = int(self.shape[0])
        if len(value) != b:
            raise ValueError(f"a per-element value has {len(value)} entries for a batch of {b}")
        return value if int(self.local.shape[0]) == b else value[self.rows]

    def wrap(self, local: torch.Tensor, shape=None):
        """The global tensor (a DTensor placed as this region's) whose
        block here is ``local``: of this region's shape, or this rank's
        block of a result of global ``shape`` (B and J placed as this
        region's: its rows, and :meth:`columns` of the new J extent);
        ``local`` itself for a region without a sharding."""
        if self.sharding is None:
            return local
        if shape is not None:
            self.check_rows()  # a new extent is placed along B and J only
        return from_local(local, self.sharding, self.shape if shape is None else shape)

    def parts(self, dim: int) -> int:
        """The number of blocks the mesh splits ``dim`` into: 1 where no
        mesh axis splits it, or where that axis has one rank."""
        group = self.group(dim)
        if group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(group)

    def columns(self, size: int) -> tuple[int, int]:
        """This rank's J columns ``[start, stop)`` of a result whose J
        extent is ``size``, placed as this region's (the whole extent where
        J is whole)."""
        self.check_rows()
        parts = self.parts(3)
        if parts == 1:
            return 0, int(size)
        import torch.distributed as dist

        return shard_range(int(size), parts, dist.get_rank(self.space_group))

    def reduce_max(self, value: torch.Tensor) -> torch.Tensor:
        """A partial maximum of this rank's block reduced over the whole
        mesh: one ``all_reduce(MAX)`` over each mesh axis that splits B or
        J into more than one block (none where the region is whole)."""
        return self._reduce(value, "max")

    def reduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        """A partial sum of this rank's block reduced over the whole mesh,
        as :meth:`reduce_max` (``all_reduce(SUM)``)."""
        return self._reduce(value, "sum")

    def _reduce(self, value: torch.Tensor, op: str) -> torch.Tensor:
        import torch.distributed as dist

        value = value.contiguous()
        reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        for dim in range(len(self.shape)):
            if self.parts(dim) > 1:
                dist.all_reduce(value, op=reduce_op, group=self.group(dim))
        return value

    @property
    def splits_c_i_or_k(self) -> bool:
        """Whether C, I or K of the (B, C, I, J, K) tensor is in more than
        one block (:attr:`NamedSharding.splits_c_i_or_k`; a region cut by
        hand: whether it is part of one of them)."""
        if self.sharding is not None:
            return self.sharding.splits_c_i_or_k
        return any(self.split(d) for d in (1, 2, 4))

    def check_rows(self) -> None:
        """Raise where :attr:`splits_c_i_or_k` holds. Only B and J splits
        stay on each rank's region: a stage that reads each element whole
        (a draw of one strided segment, an element's J columns gathered, a
        statistic over J) has no path for a split C, I or K, and the
        public entries (``Transform.forward``, a fused run) hand such a
        stage the whole tensor instead. This guards the region paths."""
        if self.splits_c_i_or_k:
            raise ValueError(
                f"a region of {self.shape} at {self.starts} is split along C, I or K"
                " (splits_c_i_or_k): its stages run on the whole tensor; only B and J"
                " splits stay on each rank's region"
            )

    def fetch_columns(self, x: torch.Tensor, size: int, need) -> torch.Tensor:
        """For this rank's columns ``[start, stop)`` of a result whose J
        extent is ``size`` (:meth:`columns`), the input columns ``need(start,
        stop)`` (global J indices into this region's extent, in the order
        the result reads them) of ``x``, this rank's J block (any B, C, I
        and K): its own by an index select, the others' point to point
        from the ranks that hold them (one ``batch_isend_irecv`` on the
        group of the mesh axis that splits J, and none where no rank needs
        another's columns). Every rank of that group calls it alike: each
        computes every rank's ``need`` to know what to send."""
        self.check_rows()
        from ..core.dtypes import movable

        parts = self.parts(3)
        moved = movable(x)
        if parts == 1:
            index = torch.as_tensor(np.asarray(need(0, int(size)), np.int64), device=x.device)
            return moved.index_select(3, index).view(x.dtype)
        from .halo import move_columns

        needs = [np.asarray(need(*shard_range(int(size), parts, p)), np.int64)
                 for p in range(parts)]
        return move_columns(moved, int(self.shape[3]), needs, self.space_group).view(x.dtype)

    def fetch_index_columns(self, x: torch.Tensor, size: int, indices) -> list[torch.Tensor]:
        """For each array of ``indices`` (the input column each output
        column of a J extent ``size`` reads, one entry an output column),
        the columns of ``x`` this rank's output columns read, all in one
        :meth:`fetch_columns` of the distinct columns they name."""
        def need(start, stop):
            return np.unique(np.concatenate([np.asarray(i[start:stop], np.int64)
                                             for i in indices]))

        start, stop = self.columns(size)
        columns = self.fetch_columns(x, size, need)
        mine = need(start, stop)
        return [
            columns.index_select(3, torch.as_tensor(
                np.searchsorted(mine, np.asarray(i[start:stop], np.int64)), device=x.device))
            for i in indices
        ]

    def gather_columns(self, rows: torch.Tensor | None = None) -> torch.Tensor:
        """This rank's rows whole along J: ``rows`` (this rank's (bl, C, I,
        jl, K) block, or a tensor of its layout; the local block where
        None) gathered over the mesh axis that splits J (one
        ``all_gather`` of the rows' columns, never over ``data``; nothing
        where J is one block). Every rank of that group calls it alike."""
        self.check_rows()
        rows = self.local if rows is None else rows
        if self.parts(3) == 1:
            return rows
        import torch.distributed as dist

        group = self.space_group
        parts = dist.get_world_size(group)
        sj = int(self.shape[3])
        widths = [stop - start for start, stop in
                  (shard_range(sj, parts, p) for p in range(parts))]
        wide = max(widths)
        padded = rows
        if rows.shape[3] < wide:
            pad = rows.new_zeros((*rows.shape[:3], wide - rows.shape[3], *rows.shape[4:]))
            padded = torch.cat([rows, pad], dim=3)
        pieces = [torch.empty_like(padded) for _ in range(parts)]
        dist.all_gather(pieces, padded.contiguous(), group=group)
        return torch.cat([piece[:, :, :, :w] for piece, w in zip(pieces, widths)], dim=3)

    def share_first(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` as the ranks holding element 0 computed it, on every
        rank: one ``broadcast`` over the group of the mesh axis that splits
        B (from its coordinate 0, which holds element 0); nothing where B
        is whole."""
        self.check_rows()
        group = self.data_group
        if group is not None:
            import torch.distributed as dist

            value = value.contiguous()
            dist.broadcast(value, src=dist.get_global_rank(group, 0), group=group)
        return value

    def share_first_labels(self, labels: list[int] | None) -> list[int]:
        """A list of ints as the ranks holding element 0 computed it
        (``labels``; None on the other ranks), on every rank: its length,
        then its values, each one ``broadcast`` over the mesh axis that
        splits B (nothing where B is one block)."""
        self.check_rows()
        if self.parts(0) == 1:
            return labels
        import torch.distributed as dist

        group = self.data_group
        src = dist.get_global_rank(group, 0)
        device = self.local.device
        count = torch.tensor([0 if labels is None else len(labels)], dtype=torch.int64,
                             device=device)
        dist.broadcast(count, src=src, group=group)
        if labels is None:
            values = torch.empty(int(count[0]), dtype=torch.int64, device=device)
        else:
            values = torch.tensor(labels, dtype=torch.int64, device=device)
        dist.broadcast(values, src=src, group=group)
        return [int(v) for v in values.tolist()]

    def reduce_columns(self, value: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A partial statistic of this rank's J columns reduced over the
        group of the mesh axis that splits J (one ``all_reduce``; nothing
        where J is whole). ``op``: "sum" or "max"."""
        self.check_rows()
        group = self.space_group
        if group is not None:
            import torch.distributed as dist

            value = value.contiguous()
            reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            dist.all_reduce(value, op=reduce_op, group=group)
        return value

    def gather_first(self, first: torch.Tensor | None = None) -> torch.Tensor:
        """Element 0 whole, (1, C, I, J, K), on the ranks that hold it: its
        J columns (``first``, this rank's (1, C, I, jl, K) columns of it or
        of a tensor of its layout; the local block's where None) gathered
        over the mesh axis that splits J (:meth:`gather_columns` of one
        element). Only the ranks of :attr:`holds_first` may call it."""
        return self.gather_columns(self.local[:1] if first is None else first)


def region_of(value) -> Region:
    """This rank's :class:`Region` of ``value``: a DTensor's local block
    and offsets (no communication), or a plain tensor whole."""
    if not is_dtensor(value):
        return Region(value, tuple(int(n) for n in value.shape), (0,) * value.ndim)
    sharding = sharding_of(value)
    slices = local_slices(value.shape, sharding)
    return Region(
        value.to_local(),
        tuple(int(n) for n in value.shape),
        tuple(int(s.start or 0) for s in slices),
        sharding,
    )


def map_region(fn, value, *per_element):
    """``fn(local, *values)`` on this rank's region of ``value``, each of
    ``per_element`` a per-element value or a scalar taken to the region's
    rows (:meth:`Region.take`), the result placed as ``value`` is: the
    pointwise stages' sharded path (a plain tensor is its own region). A
    batch-wide value goes into ``fn``'s closure, never here."""
    region = region_of(value)
    return region.wrap(fn(region.local, *(region.take(v) for v in per_element)))


def map_rows(fn, value):
    """``fn(rows)`` on this rank's rows whole along J (gathered over the
    mesh axis that splits J, :meth:`Region.gather_columns`; no
    communication where J is one block); the result, of any C, I, J and
    K, placed as ``value`` is: each rank keeps its columns of the result's
    J extent. The path of a stage that reads a whole element along J (an
    element's statistics)."""
    region = region_of(value)
    region.check_rows()
    out = fn(region.gather_columns())
    start, stop = region.columns(int(out.shape[3]))
    shape = (int(region.shape[0]), *(int(n) for n in out.shape[1:]))
    return region.wrap(out[:, :, :, start:stop], shape)


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
