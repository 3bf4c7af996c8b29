"""Distributed subject sharding for multi-process data loading.

Counterpart of ``torchio_tpu/parallel/sampler.py``: a deterministic
per-rank shard of the subject indices, for ``Queue(subject_sampler=...)``
on each rank of a ``torch.distributed`` job (the role of
``torch.utils.data.distributed.DistributedSampler``). Its orders are the
JAX package's, element for element.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _world() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedSubjectSampler:
    """Per-rank shard of ``range(num_subjects)``.

    Args:
        num_subjects: dataset size.
        rank: this process's rank (default ``dist.get_rank()``, or 0
            without a process group).
        world_size: number of ranks (default ``dist.get_world_size()``,
            or 1).
        shuffle: shuffle the global order each epoch (seeded by
            ``seed + epoch`` so every rank draws the SAME permutation).
        seed: base seed for the per-epoch permutation.
        drop_last: drop the tail so every rank gets the same count;
            otherwise the tail wraps around (every rank sees
            ``ceil(N / world)`` subjects, like DistributedSampler).

    Call :meth:`set_epoch` before each epoch so shuffling differs across
    epochs but stays identical across ranks.
    """

    def __init__(
        self,
        num_subjects: int,
        *,
        rank: int | None = None,
        world_size: int | None = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ) -> None:
        if rank is None or world_size is None:
            default_rank, default_world = _world()
            rank = default_rank if rank is None else rank
            world_size = default_world if world_size is None else world_size
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self.num_subjects = int(num_subjects)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _global_order(self) -> np.ndarray:
        order = np.arange(self.num_subjects)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        return order

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_subjects // self.world_size
        return -(-self.num_subjects // self.world_size)

    def __iter__(self) -> Iterator[int]:
        order = self._global_order()
        if self.drop_last:
            usable = (self.num_subjects // self.world_size) * self.world_size
            order = order[:usable]
        else:
            target = len(self) * self.world_size
            if target > order.size and order.size:
                order = np.concatenate([order, order[: target - order.size]])
        return iter(int(i) for i in order[self.rank :: self.world_size])
