"""Patch extraction and a device-resident ring buffer of patches.

Counterpart of ``torchio_tpu/ops/patches.py``. The JAX package slices a
subject's patches with a ``lax.scan`` of ``dynamic_slice`` and keeps its
patch pool in a donated buffer updated by ``dynamic_update_slice``; both
are XLA there, not Pallas, so plain torch ops are the port:

- :func:`extract_patches` and :func:`extract_patches_multi`: one gather
  from the strided window view of a volume at all N corners (an exact
  copy, the volume's dtype);
- :class:`RingPatchBuffer`: ``push`` is one ``index_copy_`` at the
  cursor's rows, ``sample`` draws its rows with
  :func:`~torchio_tpu_torch.random.key_randint` (``jax.random.randint``,
  the threefry kernel's bits mode on a card), ``gather`` is one
  ``index_select``. The buffer lives on the device it is given.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .. import random as tio_random


def _corner_tensors(corners, device) -> tuple[torch.Tensor, ...]:
    """(N, 3) corners -> three (N,) int64 index tensors on ``device``."""
    host = np.asarray(corners, np.int64).reshape(-1, 3)
    index = torch.as_tensor(host, device=device)
    return index[:, 0], index[:, 1], index[:, 2]


def _windows(volume: torch.Tensor, patch_size) -> torch.Tensor:
    """(C, I', J', K', pi, pj, pk) view: every patch-sized window of a
    (C, I, J, K) volume, ``I' = I - pi + 1`` (no copy)."""
    pi, pj, pk = patch_size
    return volume.unfold(1, pi, 1).unfold(2, pj, 1).unfold(3, pk, 1)


def _gather(volume: torch.Tensor, corners: tuple[torch.Tensor, ...], patch_size) -> torch.Tensor:
    """(N, C, *patch_size) copy of the windows at the (N,) corner index
    tensors: one advanced-index gather of the window view."""
    i, j, k = corners
    # (C, N, pi, pj, pk): the advanced indices meet in one axis after C
    patches = _windows(volume, patch_size)[:, i, j, k]
    return patches.transpose(0, 1).contiguous()


def extract_patches(volume: torch.Tensor, corners, patch_size) -> torch.Tensor:
    """Slice ``(N, C, *patch_size)`` patches from a ``(C, I, J, K)`` volume.

    Args:
        volume: (C, I, J, K) tensor, on any device.
        corners: (N, 3) patch corner indices (``corner + patch_size <=``
            the spatial shape).
        patch_size: (pi, pj, pk).

    One advanced-index gather of the window view at the N corners: the
    patches are an exact copy in the volume's dtype.
    """
    patch_size = tuple(int(p) for p in patch_size)
    return _gather(volume, _corner_tensors(corners, volume.device), patch_size)


def extract_patches_multi(volumes: Sequence[torch.Tensor], corners, patch_size) -> tuple:
    """Slice the same patch grid from several volumes of one spatial shape
    (any channel counts and dtypes): a tuple of ``(N, C_i, *patch_size)``
    tensors, one per volume, the corners copied to each device once."""
    patch_size = tuple(int(p) for p in patch_size)
    index: dict[torch.device, tuple[torch.Tensor, ...]] = {}
    out = []
    for volume in volumes:
        if volume.device not in index:
            index[volume.device] = _corner_tensors(corners, volume.device)
        out.append(_gather(volume, index[volume.device], patch_size))
    return tuple(out)


class RingPatchBuffer:
    """Fixed-capacity device-resident patch pool.

    ``push`` overwrites the oldest rows in place; ``sample`` draws a
    uniformly random batch with replacement from the filled region; the
    host never touches a patch voxel.
    """

    def __init__(self, capacity: int, patch_shape, dtype=torch.float32, device=None) -> None:
        self.capacity = int(capacity)
        device = tio_random._device(device)
        self._buffer = torch.zeros((self.capacity, *patch_shape), dtype=dtype, device=device)
        self._cursor = 0
        self._filled = 0

    @property
    def filled(self) -> int:
        return self._filled

    def push(self, patches: torch.Tensor) -> None:
        patches = torch.as_tensor(patches, device=self._buffer.device).to(self._buffer.dtype)
        if patches.shape[1:] != self._buffer.shape[1:]:
            raise ValueError(
                f"patch shape {tuple(patches.shape[1:])} does not match buffer"
                f" {tuple(self._buffer.shape[1:])}"
            )
        n = int(patches.shape[0])
        if n > self.capacity:
            patches = patches[-self.capacity :]
            n = self.capacity
        rows = (self._cursor + torch.arange(n, device=self._buffer.device)) % self.capacity
        self._buffer.index_copy_(0, rows, patches)
        self._cursor = (self._cursor + n) % self.capacity
        self._filled = min(self._filled + n, self.capacity)

    def sample(self, n: int, *, seed: int | None = None) -> torch.Tensor:
        """(n, *patch_shape) random batch from the filled region: rows
        ``jax.random.randint(PRNGKey(seed), (n,), 0, max(filled, 1))``."""
        if self._filled == 0:
            raise RuntimeError("RingPatchBuffer is empty")
        if seed is None:
            seed = tio_random.draw_seed()
        rows = tio_random.key_randint(
            tio_random.prng_key(seed), (int(n),), 0, max(self._filled, 1),
            device=self._buffer.device,
        )
        return self._buffer.index_select(0, rows)

    def gather(self, indices: Any) -> torch.Tensor:
        """(n, *patch_shape) rows at ``indices`` (a device-side gather):
        the same slots of the per-image buffers of one subject keep its
        images aligned in a batch."""
        if self._filled == 0:
            raise RuntimeError("RingPatchBuffer is empty")
        if isinstance(indices, torch.Tensor):
            rows = indices.to(device=self._buffer.device, dtype=torch.int64)
        else:
            rows = torch.as_tensor(np.asarray(indices, np.int64), device=self._buffer.device)
        return self._buffer.index_select(0, rows)
