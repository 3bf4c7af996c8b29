"""Queue: a buffer of patches drawn from a rotating set of subjects.

Counterpart of ``torchio_tpu/data/queue.py``: a per-epoch subject
iterator (shuffled with the stdlib ``random``, or an injected
``subject_sampler`` for data-parallel shards), a thread pool that loads
and transforms subjects ahead (the first one in the calling thread), a
buffer flushed and shuffled at ``max_length``, ``patches_per_volume``
patches a subject, and a memory estimate.

A subject of files is read where the JAX Queue reads it: ``subject.load()``
in :meth:`Queue._prepare` (a worker thread) and in the grouped path of
``device_batches``, nowhere else. As there, the dataset's own subjects
are loaded in place and never unloaded: a caller who wants each epoch to
read from disk calls ``Subject.unload()`` between epochs. The decode
runs in native code that releases the interpreter lock, so the workers'
reads overlap.

Every port image is a tensor, so a subject's patches are always sliced
by one gather an image (:func:`..ops.patches.extract_patches_multi`).
:meth:`Queue.device_batches` keeps the patches on the device end to end:
one :class:`..ops.patches.RingPatchBuffer` an image name, a metadata
ring in lockstep, and batches gathered at host-drawn rows. Images not yet
on the Queue's device (the package's default device) are copied there
one subject ahead, from pinned memory when that device is a card.
"""

from __future__ import annotations

import random as _pyrandom
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from itertools import islice
from typing import Any, Iterator, Sequence

import numpy as np
import torch
from torch.utils.data import IterableDataset

from .. import config
from .. import random as tio_random
from .sampler import PatchSampler, shifted_affine
from .subject import Subject


class Queue(IterableDataset):
    """Iterable buffer of patches drawn from a rotating set of subjects.

    Args:
        subjects: subjects to sample patches from.
        patch_sampler: e.g. :class:`UniformSampler` / :class:`LabelSampler`.
        max_length: max patches held in the buffer (diversity vs memory).
        patches_per_volume: patches extracted per subject per epoch.
        num_workers: background loading threads (0 = synchronous).
        shuffle_subjects / shuffle_patches: epoch-level shuffling.
        transform: applied to each subject after load, before sampling.
        subject_sampler: iterable of subject indices (e.g. a
            per-process shard for data-parallel training). Requires
            ``shuffle_subjects=False``.
    """

    def __init__(
        self,
        subjects: Sequence[Subject],
        patch_sampler: PatchSampler,
        max_length: int = 300,
        patches_per_volume: int = 10,
        num_workers: int = 0,
        shuffle_subjects: bool = True,
        shuffle_patches: bool = True,
        transform: Any | None = None,
        subject_sampler: Any | None = None,
    ) -> None:
        if subject_sampler is not None and shuffle_subjects:
            raise ValueError(
                "shuffle_subjects must be False when subject_sampler is"
                " provided (the sampler controls the order)"
            )
        self.subjects = subjects
        self.patch_sampler = patch_sampler
        self.max_length = max_length
        self.patches_per_volume = patches_per_volume
        self.num_workers = num_workers
        self.shuffle_subjects = shuffle_subjects
        self.shuffle_patches = shuffle_patches
        self.transform = transform
        self.subject_sampler = subject_sampler

    def __iter__(self) -> Iterator[Subject]:
        buffer: list[Subject] = []
        subject_iter = self._make_subject_iter()
        if self.num_workers > 0:
            yield from self._iter_threaded(subject_iter, buffer)
        else:
            yield from self._iter_sync(subject_iter, buffer)

    def _iter_sync(self, subject_iter, buffer) -> Iterator[Subject]:
        for raw in subject_iter:
            buffer.extend(self._sample_patches(self._prepare(raw)))
            if len(buffer) >= self.max_length:
                yield from self._flush(buffer)
        yield from self._flush(buffer)

    def _iter_threaded(self, subject_iter, buffer) -> Iterator[Subject]:
        # the first subject runs in this thread, alone: whatever it sets
        # up once (a kernel build) is done before the workers start
        first = next(subject_iter, None)
        if first is not None:
            buffer.extend(self._sample_patches(self._prepare(first)))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures: deque[Future] = deque()
            for raw in subject_iter:
                futures.append(pool.submit(self._prepare, raw))
                while futures and futures[0].done():
                    buffer.extend(self._sample_patches(futures.popleft().result()))
                if len(buffer) >= self.max_length:
                    yield from self._flush(buffer)
            for future in futures:
                buffer.extend(self._sample_patches(future.result()))
        yield from self._flush(buffer)

    def _flush(self, buffer: list[Subject]) -> Iterator[Subject]:
        if self.shuffle_patches:
            _pyrandom.shuffle(buffer)
        while buffer:
            yield buffer.pop()

    def _prepare(self, subject: Subject) -> Subject:
        subject.load()
        if self.transform is not None:
            subject = self.transform(subject)
        return subject

    def _sample_patches(self, subject: Subject) -> list[Subject]:
        fast = self._sample_patches_on_device(subject)
        if fast is not None:
            return fast
        return list(islice(iter(self.patch_sampler(subject)), self.patches_per_volume))

    def _sample_patches_on_device(self, subject: Subject) -> list[Subject] | None:
        """All of a subject's patches in one gather an image, or None
        where the sampler draws no corners (then the sampler's own
        iteration slices them)."""
        from ..ops.patches import extract_patches_multi

        images = subject.images
        if not images:
            return None
        try:
            locations = self.patch_sampler.sample_locations(
                subject, self.patches_per_volume
            )
        except NotImplementedError:
            return None
        if not locations:
            return None
        corners = np.asarray([loc.index for loc in locations], np.int32)
        patch_size = tuple(int(p) for p in locations[0].size)
        per_image = dict(zip(
            images, extract_patches_multi([img.data for img in images.values()], corners, patch_size)
        ))
        patches = []
        for i, loc in enumerate(locations):
            kwargs: dict[str, Any] = {
                name: img.new_like(
                    data=per_image[name][i], affine=shifted_affine(img.affine.data, loc.index)
                )
                for name, img in images.items()
            }
            kwargs.update(subject.metadata)
            kwargs["patch_location"] = loc
            patches.append(Subject(**kwargs))
        return patches

    def _batched_prepared(self, group_size: int) -> Iterator[Subject]:
        """Load subjects and run the transform on groups of
        ``group_size`` stacked into one batch. Every transform of the
        pipeline, nested composers included, must gate per element
        (``p == 1``, or per-instance p on this instance) so that grouping
        cannot couple the subjects' p-coins; a group whose shapes differ
        is prepared subject by subject."""
        from .batch import SubjectsBatch

        if self.transform is not None:
            _check_gates_per_element(self.transform)

        def prepared(group: list[Subject]) -> list[Subject]:
            if not group or self.transform is None:
                return group
            if len(group) == 1:
                return [self.transform(group[0])]
            try:
                batch = SubjectsBatch.from_subjects(group)
            except (RuntimeError, ValueError, KeyError):
                return [self.transform(s) for s in group]
            return self.transform(batch).unbatch()

        group: list[Subject] = []
        for subject in self._make_subject_iter():
            subject.load()
            group.append(subject)
            if len(group) >= group_size:
                yield from prepared(group)
                group = []
        yield from prepared(group)

    def device_batches(
        self, batch_size: int, *, epochs: int = 1, prep_batch: int = 1
    ) -> Iterator[Any]:
        """Training batches that stay on the device, through ring buffers.

        Each subject's patches are sliced by one gather an image and
        pushed into a :class:`..ops.patches.RingPatchBuffer` of capacity
        ``max(max_length, batch_size)`` an image name; each batch gathers
        the same host-drawn rows (``get_rng().integers``) from every ring,
        so a batch's images stay aligned. The only host work is the row
        draw and the affine bookkeeping.

        Yields :class:`~torchio_tpu_torch.data.batch.SubjectsBatch` objects
        of ``(batch_size, C, *patch_size)`` tensors, with per-patch affines
        and ``patch_location`` metadata. An epoch yields
        ``patches_per_epoch // batch_size`` batches (at least one), paced
        as subjects stream in so the pool keeps refreshing.

        ``prep_batch > 1`` transforms that many subjects as one stacked
        batch (the pipeline must gate per element).
        """
        from ..core.affine import AffineMatrix
        from ..ops.patches import RingPatchBuffer, extract_patches_multi
        from .batch import ImagesBatch, SubjectsBatch

        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        patch_size = tuple(int(p) for p in self.patch_sampler.patch_size)
        capacity = max(self.max_length, batch_size)
        device = config.default_device()
        buffers: dict[str, RingPatchBuffer] = {}
        image_classes: dict[str, type] = {}
        meta_ring: list[Any] = [None] * capacity
        cursor = 0
        filled = 0

        n_subjects = self.num_subjects
        total_batches = max(1, self.patches_per_epoch // batch_size)

        def push_subject(subject: Subject, staged: dict[str, torch.Tensor]) -> int:
            nonlocal cursor, filled
            try:
                locations = self.patch_sampler.sample_locations(
                    subject, self.patches_per_volume
                )
            except NotImplementedError:
                raise ValueError(
                    "device_batches needs a sampler that can produce"
                    " corner locations (sample_locations); "
                    f"{type(self.patch_sampler).__name__} only supports"
                    " host iteration — use the SubjectsLoader path"
                ) from None
            if not locations:
                return 0
            # the voxel rings truncate an over-capacity push to its LAST
            # rows: truncate the locations the same way, so that the
            # metadata ring stays in lockstep with them
            locations = locations[-capacity:]
            if buffers and set(subject.images) != set(buffers):
                raise ValueError(
                    "device_batches needs every subject to carry the same"
                    f" image names; first subject had {sorted(buffers)},"
                    f" got {sorted(subject.images)}"
                )
            corners = np.asarray([loc.index for loc in locations], np.int32)
            volumes = {name: staged.get(name, img.data) for name, img in subject.images.items()}
            patches = extract_patches_multi(list(volumes.values()), corners, patch_size)
            for (name, data), block in zip(volumes.items(), patches):
                if name not in buffers:
                    buffers[name] = RingPatchBuffer(
                        capacity, (data.shape[0], *patch_size), data.dtype, device=data.device
                    )
                    image_classes[name] = type(subject.images[name])
                buffers[name].push(block)
            for loc in locations:
                affines = {
                    name: shifted_affine(img.affine.data, loc.index)
                    for name, img in subject.images.items()
                }
                meta_ring[cursor] = (affines, loc, dict(subject.metadata))
                cursor = (cursor + 1) % capacity
                filled = min(filled + 1, capacity)
            return len(locations)

        def draw_batch() -> Any:
            rng = tio_random.get_rng()
            idx = rng.integers(0, filled, size=batch_size)
            rows = torch.as_tensor(idx, device=device)
            images = {}
            for name, buffer in buffers.items():
                affines = [AffineMatrix(meta_ring[i][0][name]) for i in idx]
                images[name] = ImagesBatch(
                    buffer.gather(rows), affines, image_class=image_classes[name]
                )
            metadata: dict[str, list[Any]] = {
                "patch_location": [meta_ring[i][1] for i in idx]
            }
            for key in meta_ring[idx[0]][2]:
                metadata[key] = [meta_ring[i][2].get(key) for i in idx]
            return SubjectsBatch(images, metadata=metadata)

        for _epoch in range(epochs):
            yielded = 0
            seen = 0
            if prep_batch > 1:
                prepared: Iterator[Subject] = self._batched_prepared(prep_batch)
            elif self.num_workers > 0:
                prepared = self._prefetched_subjects()
            else:
                prepared = (self._prepare(s) for s in self._make_subject_iter())
            for subject, staged in self._device_staged(prepared, device):
                push_subject(subject, staged)
                seen += 1
                target = total_batches * seen // n_subjects
                while yielded < target and filled:
                    yield draw_batch()
                    yielded += 1
            while yielded < total_batches and filled:
                yield draw_batch()
                yielded += 1

    @staticmethod
    def _device_staged(
        prepared: Iterator[Subject], device: torch.device
    ) -> Iterator[tuple[Subject, dict[str, torch.Tensor]]]:
        """One subject of lookahead: the NEXT subject's copies to
        ``device`` start (``non_blocking``, from pinned memory when
        ``device`` is a card) before the CURRENT subject's patches are
        sliced. Subjects are not changed: the copies ride beside them in a
        dict (empty for a subject already on ``device``)."""

        def stage(subject: Subject) -> tuple[Subject, dict[str, torch.Tensor]]:
            staged: dict[str, torch.Tensor] = {}
            for name, img in subject.images.items():
                data = img.data
                if data.device != device:
                    if data.device.type == "cpu" and device.type == "cuda":
                        data = data.pin_memory()
                    staged[name] = data.to(device, non_blocking=True)
            return subject, staged

        current = next(prepared, None)
        if current is None:
            return
        current_pair = stage(current)
        for upcoming in prepared:
            upcoming_pair = stage(upcoming)  # the copies start now...
            yield current_pair  # ...and overlap this subject's slicing
            current_pair = upcoming_pair
        yield current_pair

    def _prefetched_subjects(self) -> Iterator[Subject]:
        """Subjects loaded and transformed by the worker pool, the first
        one in the calling thread (see :meth:`_iter_threaded`)."""
        subject_iter = self._make_subject_iter()
        first = next(subject_iter, None)
        if first is None:
            return
        yield self._prepare(first)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures: deque[Future] = deque()
            for raw in subject_iter:
                futures.append(pool.submit(self._prepare, raw))
                while len(futures) > self.num_workers + 2:
                    yield futures.popleft().result()
                while futures and futures[0].done():
                    yield futures.popleft().result()
            while futures:
                yield futures.popleft().result()

    def _make_subject_iter(self) -> Iterator[Subject]:
        if self.subject_sampler is not None:
            return (self.subjects[i] for i in self.subject_sampler)
        subjects = list(self.subjects)
        if self.shuffle_subjects:
            _pyrandom.shuffle(subjects)
        return iter(subjects)

    @property
    def num_subjects(self) -> int:
        if self.subject_sampler is not None:
            return len(self.subject_sampler)  # type: ignore[arg-type]
        return len(self.subjects)

    @property
    def patches_per_epoch(self) -> int:
        return self.num_subjects * self.patches_per_volume

    @property
    def max_memory(self) -> int:
        """Estimated peak buffer memory in bytes (float32 voxels)."""
        sample = self.subjects[0]
        channels = sum(img.num_channels for img in sample.images.values())
        voxels = 1
        for s in self.patch_sampler.patch_size:
            voxels *= s
        return 4 * channels * voxels * self.max_length

    @property
    def max_memory_pretty(self) -> str:
        size = float(self.max_memory)
        for unit in ("B", "KiB", "MiB", "GiB"):
            if size < 1024:
                return f"{size:.1f} {unit}"
            size /= 1024
        return f"{size:.1f} TiB"


def _check_gates_per_element(transform: Any) -> None:
    """Raise unless every transform of the pipeline (the children of
    Compose, OneOf and SomeOf included) gates each element alone: ``p ==
    1``, or per-instance p on this instance (``per_instance`` and
    ``supports_per_instance_p``). A per-instance OneOf or SomeOf draws a
    coin for each element and runs its children on one element at a
    time, so any gating of theirs is per element too."""
    pending = [transform]
    while pending:
        t = pending.pop()
        per_element = t.per_instance and getattr(t, "runs_children_per_element", False)
        if not per_element:
            pending.extend(getattr(t, "transforms", ()))
        if t.p < 1.0 and not (per_element or (t.per_instance and t.supports_per_instance_p)):
            raise ValueError(
                f"prep_batch > 1 needs per-element p-gating, but"
                f" {type(t).__name__}(p={t.p}) gates batch-wide —"
                " use prep_batch=1 for this pipeline"
            )
