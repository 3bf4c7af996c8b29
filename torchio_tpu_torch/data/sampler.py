"""Patch samplers: grid (inference) and random/weighted/label (training).

Counterpart of ``torchio_tpu/data/sampler.py``: GridSampler's regular
grid with overlap, end snap and optional pre-padding; UniformSampler;
WeightedSampler's draw from a flattened probability map with its borders
masked and each centre moved to a corner; LabelSampler's map from label
values.

A port image is always a tensor, so the weighted draws take the JAX
package's device branch: the map in float32 on the image's device, its
cumulative sum in float32 in XLA:CPU's order (:func:`xla_cumsum`), the
host's ``rng.random(n) * total`` cast to float32,
``torch.searchsorted(right=True)`` and one device-to-host copy of the N
indices. The random samplers are torch ``IterableDataset``s;
GridSampler stays map-style (``__len__`` and ``__getitem__``).
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch.utils.data import IterableDataset

from .. import random as tio_random
from .patch import PatchLocation
from .subject import Subject


#: XLA:CPU lowers a cumulative sum to windows of this many elements
CUMSUM_BLOCK = 16


def xla_cumsum(values: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a 1-D float32 tensor, summed in the
    order of ``jnp.cumsum`` on XLA:CPU, so that its bits equal it.

    XLA rewrites the scan as windows of 16: each block of 16 is scanned
    in order, the block totals are scanned the same way (recursively),
    and each block's exclusive prefix is added once. The scan inside a
    block is 15 column adds on an ``(n / 16, 16)`` view (a CUDA
    ``cumsum`` need not add in order). The tail is padded with zeros,
    which change no sum.
    """
    n = values.shape[0]
    rows = -(-n // CUMSUM_BLOCK)
    blocks = torch.zeros(rows * CUMSUM_BLOCK, dtype=values.dtype, device=values.device)
    blocks[:n] = values
    blocks = blocks.reshape(rows, CUMSUM_BLOCK)
    for col in range(1, CUMSUM_BLOCK):
        blocks[:, col] += blocks[:, col - 1]
    if rows > 1:
        totals = xla_cumsum(blocks[:, -1].contiguous())
        blocks[1:] += totals[:-1, None]
    return blocks.reshape(-1)[:n]


class PatchSampler:
    """Base: patch extraction by spatial slicing of a whole subject."""

    def __init__(self, patch_size) -> None:
        if isinstance(patch_size, (int, np.integer)):
            patch_size = (int(patch_size),) * 3
        self.patch_size: tuple[int, int, int] = tuple(int(p) for p in patch_size)

    def __call__(self, subject: Subject, num_patches: int | None = None):
        raise NotImplementedError(f"{type(self).__name__} must implement __call__")

    def _extract_patch(self, subject: Subject, location: PatchLocation) -> Subject:
        si, sj, sk = location.to_slices()
        kwargs: dict[str, Any] = {
            name: image[:, si, sj, sk] for name, image in subject.images.items()
        }
        kwargs.update(subject.metadata)
        kwargs["patch_location"] = location
        return Subject(**kwargs)

    def sample_locations(self, subject: Subject, num_patches: int) -> list[PatchLocation]:
        """Corner locations only, no voxel extraction: the Queue slices
        every patch of a subject in one gather from them."""
        return [
            PatchLocation(index=corner, size=self.patch_size)
            for corner in self._sample_corners(subject, num_patches)
        ]

    def _sample_corners(self, subject: Subject, num_patches: int):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement corner sampling"
        )


def shifted_affine(affine: np.ndarray, corner) -> np.ndarray:
    """A copy of the float64 ``affine`` with its origin moved to voxel
    ``corner``."""
    shifted = np.array(affine, np.float64)
    shifted[:3, 3] = affine[:3, :3] @ np.asarray(corner, np.float64) + affine[:3, 3]
    return shifted


class GridSampler(PatchSampler):
    """Regular-grid patches for dense inference (map-style: len + index).

    ``patch_overlap`` controls adjacent-patch overlap; a final position
    is snapped so the grid always covers the full volume. Optional
    pre-padding by ``overlap // 2`` per side.
    """

    def __init__(
        self,
        subject: Subject,
        patch_size,
        patch_overlap=0,
        padding_mode: str | None = None,
        fill: float = 0,
    ) -> None:
        super().__init__(patch_size)
        if isinstance(patch_overlap, (int, np.integer)):
            patch_overlap = (int(patch_overlap),) * 3
        self.patch_overlap = tuple(int(v) for v in patch_overlap)
        self.padding_mode = padding_mode
        self.fill = fill
        self.subject = self._maybe_pad(subject)
        self.locations = self._compute_locations(self.subject.spatial_shape)

    def __len__(self) -> int:
        return len(self.locations)

    def __getitem__(self, index: int) -> Subject:
        return self._extract_patch(self.subject, self.locations[index])

    def __iter__(self) -> Iterator[Subject]:
        for i in range(len(self)):
            yield self[i]

    def get_batch(self, indices) -> Any:
        """The patches at ``indices`` as ONE :class:`SubjectsBatch`: every
        image sliced by one gather at all the chunk's corners
        (:func:`..ops.patches.extract_patches_multi`), not one slice a
        patch an image; the loader's batched fetch."""
        from ..core.affine import AffineMatrix
        from ..ops.patches import extract_patches_multi
        from .batch import ImagesBatch, SubjectsBatch

        images = self.subject.images
        locs = [self.locations[i] for i in indices]
        corners = np.asarray([loc.index for loc in locs], np.int32)
        all_patches = extract_patches_multi(
            [img.data for img in images.values()], corners, self.patch_size
        )
        batched: dict[str, ImagesBatch] = {}
        for (name, img), patches in zip(images.items(), all_patches):
            aff = np.asarray(img.affine.data, np.float64)
            affines = [AffineMatrix(shifted_affine(aff, corner)) for corner in corners]
            batched[name] = ImagesBatch(patches, affines, image_class=type(img))
        metadata: dict[str, list[Any]] = {
            key: [value] * len(locs) for key, value in self.subject.metadata.items()
        }
        metadata["patch_location"] = locs
        return SubjectsBatch(batched, metadata=metadata)

    def _maybe_pad(self, subject: Subject) -> Subject:
        if self.padding_mode is None:
            return subject
        from ..transforms.spatial.pad import Pad

        border = tuple(v // 2 for v in self.patch_overlap)
        padding = (border[0], border[0], border[1], border[1], border[2], border[2])
        return Pad(
            padding=padding, padding_mode=self.padding_mode, fill=self.fill, copy=False
        )(subject)

    def _compute_locations(self, spatial_shape) -> list[PatchLocation]:
        axes: list[list[int]] = []
        for dim in range(3):
            size = spatial_shape[dim]
            patch = self.patch_size[dim]
            overlap = self.patch_overlap[dim]
            step = max(patch - overlap, 1)
            indices = list(range(0, size - patch + 1, step))
            if not indices or indices[-1] != size - patch:
                indices.append(max(size - patch, 0))
            axes.append(indices)
        return [
            PatchLocation(index=(i, j, k), size=self.patch_size)
            for i in axes[0]
            for j in axes[1]
            for k in axes[2]
        ]


class UniformSampler(PatchSampler, IterableDataset):
    """Random patches with uniform spatial probability (iterable)."""

    def __init__(
        self,
        subject: Subject | None = None,
        patch_size=None,
        num_patches: int | None = None,
    ) -> None:
        if patch_size is None:
            raise TypeError("patch_size is required")
        super().__init__(patch_size)
        self.subject = subject
        self.num_patches = num_patches

    def __call__(self, subject: Subject, num_patches: int | None = None):
        limit = num_patches or self.num_patches
        count = 0
        while limit is None or count < limit:
            index = self._random_index(subject.spatial_shape)
            yield self._extract_patch(
                subject, PatchLocation(index=index, size=self.patch_size)
            )
            count += 1

    def __iter__(self) -> Iterator[Subject]:
        if self.subject is None:
            raise RuntimeError("UniformSampler needs a subject to iterate")
        return self(self.subject, self.num_patches)

    def _random_index(self, spatial_shape) -> tuple[int, int, int]:
        rng = tio_random.get_rng()
        out = []
        for d in range(3):
            hi = max(spatial_shape[d] - self.patch_size[d], 0) + 1
            out.append(int(rng.integers(0, hi)))
        return (out[0], out[1], out[2])

    def _sample_corners(self, subject: Subject, num_patches: int):
        return [self._random_index(subject.spatial_shape) for _ in range(num_patches)]


def _mask_borders_device(prob: torch.Tensor, spatial_shape, patch_size) -> torch.Tensor:
    """Zero the probability where a patch centred there would overflow."""
    for d in range(3):
        half = patch_size[d] // 2
        tail = spatial_shape[d] - half
        pos = torch.arange(spatial_shape[d], device=prob.device)
        valid = (pos >= half) & (pos < tail)
        shape = [1, 1, 1]
        shape[d] = -1
        prob = prob * valid.reshape(shape).to(prob.dtype)
    return prob


def _center_to_corner(center, spatial_shape, patch_size) -> tuple[int, int, int]:
    out = []
    for d in range(3):
        corner = max(0, center[d] - patch_size[d] // 2)
        out.append(min(corner, spatial_shape[d] - patch_size[d]))
    return (out[0], out[1], out[2])


class WeightedSampler(PatchSampler, IterableDataset):
    """Random patches with probability proportional to a map image."""

    def __init__(
        self,
        subject: Subject | None = None,
        patch_size=None,
        probability_map: str | None = None,
        num_patches: int | None = None,
    ) -> None:
        if patch_size is None:
            raise TypeError("patch_size is required")
        if probability_map is None:
            raise TypeError("probability_map is required")
        super().__init__(patch_size)
        self.subject = subject
        self.probability_map = probability_map
        self.num_patches = num_patches

    def _corners_from_cdf(self, subject, shape, cdf, total, n):
        rng = tio_random.get_rng()
        draws = rng.random(n) * total
        draws = torch.as_tensor(draws.astype(np.float32), device=cdf.device)
        # the one device-to-host copy of a draw: n indices, not voxels
        idxs = torch.searchsorted(cdf, draws, right=True).cpu().numpy()
        idxs = np.minimum(idxs, int(np.prod(shape)) - 1)
        corners = []
        for idx_flat in idxs:
            center = tuple(int(x) for x in np.unravel_index(int(idx_flat), shape))
            corners.append(_center_to_corner(center, subject.spatial_shape, self.patch_size))
        return corners

    def _build_cdf(self, subject: Subject):
        """(map shape, cumulative distribution, total): one O(N) pass a
        subject on its device, O(log N) a draw."""
        prob = self._device_probability_map_for(subject)
        cdf = xla_cumsum(prob.reshape(-1))
        total = float(cdf[-1])
        if total == 0:
            raise RuntimeError(f"Probability map '{self.probability_map}' is all zeros")
        return tuple(int(s) for s in prob.shape), cdf, total

    def _device_probability_map_for(self, subject: Subject) -> torch.Tensor:
        prob = subject.images[self.probability_map].data[0].to(torch.float32)
        return _mask_borders_device(prob, subject.spatial_shape, self.patch_size)

    def _sample_corners(self, subject: Subject, num_patches: int):
        shape, cdf, total = self._build_cdf(subject)
        return self._corners_from_cdf(subject, shape, cdf, total, num_patches)

    def __call__(self, subject: Subject, num_patches: int | None = None):
        shape, cdf, total = self._build_cdf(subject)
        limit = num_patches or self.num_patches
        count = 0
        pending: list = []
        while limit is None or count < limit:
            if not pending:
                chunk = 64 if limit is None else min(64, limit - count)
                pending = self._corners_from_cdf(subject, shape, cdf, total, chunk)
            index = pending.pop(0)
            yield self._extract_patch(
                subject, PatchLocation(index=index, size=self.patch_size)
            )
            count += 1

    def __iter__(self) -> Iterator[Subject]:
        if self.subject is None:
            raise RuntimeError("WeightedSampler needs a subject to iterate")
        return self(self.subject, self.num_patches)


class LabelSampler(WeightedSampler):
    """Random patches centered on labeled voxels (class-imbalance aid)."""

    def __init__(
        self,
        subject: Subject | None = None,
        patch_size=None,
        label_name: str | None = None,
        label_probabilities: dict[int, float] | None = None,
        num_patches: int | None = None,
    ) -> None:
        if label_name is None:
            raise TypeError("label_name is required")
        super().__init__(
            subject, patch_size, probability_map=label_name, num_patches=num_patches
        )
        self.label_name = label_name
        self.label_probabilities = label_probabilities

    def _device_probability_map_for(self, subject: Subject) -> torch.Tensor:
        label = subject.images[self.label_name].data[0]
        if self.label_probabilities is not None:
            prob = torch.zeros(label.shape, dtype=torch.float32, device=label.device)
            for value, weight in self.label_probabilities.items():
                prob = prob.masked_fill(label == value, weight)
        else:
            prob = (label > 0).to(torch.float32)
        return _mask_borders_device(prob, subject.spatial_shape, self.patch_size)
