"""Batched loaders collating Subjects/Images into batches.

Counterpart of ``torchio_tpu/data/loader.py``: a loader without
``torch.utils.data.DataLoader``'s worker processes (the heavy work is
already on the device, and threads share it), with an optional bounded
thread window for map-style datasets and the batched-fetch fast path of
a dataset with ``get_batch`` (GridSampler). The collate functions also
serve as a ``DataLoader``'s ``collate_fn``.
"""

from __future__ import annotations

import random as _pyrandom
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Sequence

from .batch import ImagesBatch, SubjectsBatch


def collate_subjects(batch: Sequence[Any]) -> SubjectsBatch:
    """Stack Subjects into a SubjectsBatch."""
    return SubjectsBatch.from_subjects(list(batch))


def collate_images(batch: Sequence[Any]) -> ImagesBatch:
    """Stack Images into an ImagesBatch."""
    return ImagesBatch.from_images(list(batch))


class _Loader:
    """Iterate a dataset in batches with optional thread prefetch.

    Accepts map-style datasets (``__len__`` + ``__getitem__``) or
    iterables (e.g. :class:`~torchio_tpu_torch.data.queue.Queue`).
    """

    _collate = staticmethod(collate_subjects)

    def __init__(
        self,
        dataset: Any,
        batch_size: int = 1,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 0,
        collate_fn: Any = None,
    ) -> None:
        if collate_fn is not None:
            raise ValueError(
                f"{type(self).__name__} sets collate_fn automatically;"
                " iterate the dataset yourself for custom collation"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers

    def _item_iter(self) -> Iterator[Any]:
        if hasattr(self.dataset, "__len__") and hasattr(self.dataset, "__getitem__"):
            indices = list(range(len(self.dataset)))
            if self.shuffle:
                _pyrandom.shuffle(indices)
            if self.num_workers > 0:
                # at most num_workers + 2 items loaded and not yet
                # consumed, so a slow consumer cannot pull the whole
                # dataset into memory
                window = self.num_workers + 2
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    inflight: deque = deque()
                    for i in indices:
                        inflight.append(pool.submit(self.dataset.__getitem__, i))
                        if len(inflight) >= window:
                            yield inflight.popleft().result()
                    while inflight:
                        yield inflight.popleft().result()
            else:
                for i in indices:
                    yield self.dataset[i]
        else:
            if self.shuffle:
                raise ValueError("shuffle requires a map-style dataset")
            yield from self.dataset

    def __iter__(self):
        get_batch = getattr(self.dataset, "get_batch", None)
        if (
            get_batch is not None
            and type(self)._collate is collate_subjects
            and self.num_workers == 0
            and hasattr(self.dataset, "__len__")
        ):
            # batched fetch (GridSampler): one gather an image a batch
            indices = list(range(len(self.dataset)))
            if self.shuffle:
                _pyrandom.shuffle(indices)
            for start in range(0, len(indices), self.batch_size):
                chunk_idx = indices[start : start + self.batch_size]
                if len(chunk_idx) < self.batch_size and self.drop_last:
                    break
                yield get_batch(chunk_idx)
            return
        chunk: list[Any] = []
        for item in self._item_iter():
            chunk.append(item)
            if len(chunk) == self.batch_size:
                yield type(self)._collate(chunk)
                chunk = []
        if chunk and not self.drop_last:
            yield type(self)._collate(chunk)

    def __len__(self) -> int:
        if not hasattr(self.dataset, "__len__"):
            raise TypeError("Loader over an iterable dataset has no length")
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class SubjectsLoader(_Loader):
    """Yields :class:`SubjectsBatch` instances."""

    _collate = staticmethod(collate_subjects)


class ImagesLoader(_Loader):
    """Yields :class:`ImagesBatch` instances."""

    _collate = staticmethod(collate_images)


# DICOM terminology aliases.
StudiesLoader = SubjectsLoader
collate_studies = collate_subjects
