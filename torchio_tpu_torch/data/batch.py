"""Batch containers: 5D stacked image tensors with per-sample affines.

Counterpart of ``torchio_tpu/data/batch.py``: ``ImagesBatch`` and
``SubjectsBatch`` with per-element history slicing at :meth:`unbatch`.
Data is one ``(B, C, I, J, K)`` torch tensor; a batch runs where that
tensor lives. Affines stay float64 on the host, one per sample.

Transforms never write into a batch's tensor in place: every stage
assigns a new tensor. So a deep copy shares the tensor (as the JAX
package shares its immutable arrays) and copies only the metadata.
Mesh sharding (``shard_``) comes later.
"""

from __future__ import annotations

import copy as _copy
from typing import Any

import torch

from ..config import as_tensor
from ..core.affine import AffineMatrix
from .image import Image, ScalarImage
from .invertible import Invertible
from .subject import Subject

#: Reserved param keys used for per-instance history bookkeeping.
_BATCH_META_KEYS = ("_batch_size", "_batched_keys", "_keep")


class ImagesBatch(Invertible):
    """5D tensor ``(B, C, I, J, K)`` + per-sample affines + image class."""

    def __init__(
        self,
        data: Any,
        affines: list[AffineMatrix],
        *,
        image_class: type[Image] = ScalarImage,
    ) -> None:
        data = as_tensor(data)
        if data.ndim != 5:
            raise ValueError(f"Expected 5D (B, C, I, J, K) data, got {data.ndim}D")
        if len(affines) != data.shape[0]:
            raise ValueError(f"Expected {data.shape[0]} affines, got {len(affines)}")
        self._data = data
        self._affines = affines
        self._image_class = image_class
        self.applied_transforms: list[Any] = []

    @classmethod
    def from_images(cls, images: list[Image]) -> "ImagesBatch":
        if not images:
            raise ValueError("Cannot create batch from empty list")
        stacked = torch.stack([img.data for img in images])
        affines = [img.affine.clone() for img in images]
        return cls(stacked, affines, image_class=type(images[0]))

    @property
    def data(self) -> torch.Tensor:
        return self._data

    @data.setter
    def data(self, value: Any) -> None:
        value = as_tensor(value)
        if value.ndim != 5:
            raise ValueError(f"Expected 5D tensor, got {value.ndim}D")
        self._data = value

    def __deepcopy__(self, memo: dict) -> "ImagesBatch":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        new._data = self._data
        new._affines = [a.clone() for a in self._affines]
        new._image_class = self._image_class
        new.applied_transforms = _copy.deepcopy(self.applied_transforms, memo)
        return new

    @property
    def affines(self) -> list[AffineMatrix]:
        return self._affines

    @affines.setter
    def affines(self, value: list[AffineMatrix]) -> None:
        self._affines = value

    @property
    def image_class(self) -> type[Image]:
        return self._image_class

    @property
    def batch_size(self) -> int:
        return int(self._data.shape[0])

    @property
    def device(self) -> torch.device:
        return self._data.device

    def to(self, device: Any = None, dtype: Any = None) -> "ImagesBatch":
        self._data = self._data.to(device=device, dtype=dtype)
        return self

    def __getitem__(self, index: int) -> Image:
        return self._image_class(self._data[index], affine=self._affines[index].clone())

    def __len__(self) -> int:
        return self.batch_size

    def __repr__(self) -> str:
        b, c, i, j, k = self._data.shape
        return (
            f"ImagesBatch({self._image_class.__name__}, batch_size={b},"
            f" shape=({c}, {i}, {j}, {k}), device={self.device})"
        )


class SubjectsBatch(Invertible):
    """Named image batches + per-sample metadata lists.

    The unit every transform operates on. Supports per-element history
    slicing on :meth:`unbatch`.
    """

    def __init__(
        self,
        images: dict[str, ImagesBatch],
        *,
        metadata: dict[str, list[Any]] | None = None,
    ) -> None:
        self._images = images
        self._metadata: dict[str, list[Any]] = metadata or {}
        self.applied_transforms: list[Any] = []

    @classmethod
    def from_subjects(cls, subjects: list[Subject]) -> "SubjectsBatch":
        if not subjects:
            raise ValueError("Cannot create batch from empty list")
        first = subjects[0]
        images = {
            name: ImagesBatch.from_images([s.images[name] for s in subjects])
            for name in first.images
        }
        metadata = {key: [s.metadata[key] for s in subjects] for key in first.metadata}
        return cls(images, metadata=metadata)

    # --- Properties ---

    @property
    def batch_size(self) -> int:
        if self._images:
            return next(iter(self._images.values())).batch_size
        for values in self._metadata.values():
            return len(values)
        raise ValueError("Batch has no images or metadata")

    @property
    def images(self) -> dict[str, ImagesBatch]:
        return self._images

    @property
    def metadata(self) -> dict[str, list[Any]]:
        return self._metadata

    @property
    def device(self) -> torch.device:
        return next(iter(self._images.values())).device

    def to(self, device: Any = None, dtype: Any = None) -> "SubjectsBatch":
        for batch in self._images.values():
            batch.to(device, dtype)
        return self

    def __getitem__(self, key: str) -> ImagesBatch:
        return self._images[key]

    def __getattr__(self, name: str) -> ImagesBatch:
        if name.startswith("_"):
            raise AttributeError(name)
        images = self.__dict__.get("_images") or {}
        if name in images:
            return images[name]
        raise AttributeError(f"SubjectsBatch has no attribute {name!r}")

    def __len__(self) -> int:
        return self.batch_size

    # --- Unbatch ---

    def unbatch(self) -> list[Subject]:
        """Split into Subjects, slicing per-instance history per element."""
        subjects = []
        for i in range(self.batch_size):
            kwargs: dict[str, Any] = {name: ib[i] for name, ib in self._images.items()}
            for key, values in self._metadata.items():
                kwargs[key] = values[i]
            sub = Subject(**kwargs)
            sub.applied_transforms = _slice_history(self.applied_transforms, i)
            subjects.append(sub)
        return subjects

    def __repr__(self) -> str:
        names = ", ".join(self._images)
        return f"SubjectsBatch(batch_size={self.batch_size}, images=[{names}])"


def _slice_params(
    params: dict[str, Any], index: int, batched_keys: list[str]
) -> dict[str, Any]:
    """One element's view of a per-instance params dict.

    Keys named in ``batched_keys`` hold one list entry per element and
    are indexed; everything else is shared verbatim. The bookkeeping
    keys (``_BATCH_META_KEYS``) never survive into a per-subject record.
    """
    per_element = {k for k in batched_keys if isinstance(params.get(k), list)}
    return {
        key: value[index] if key in per_element else value
        for key, value in params.items()
        if key not in _BATCH_META_KEYS
    }


def _trace_for_element(trace: Any, index: int) -> Any | None:
    """The element's version of one history record.

    Batch-shared records (no ``_batched_keys`` tag) pass through as-is.
    Per-instance records come back with their params sliced to the
    element; ``None`` means the record's keep-mask gated this element
    out and the record should be dropped from that subject's history.
    """
    peek = trace.raw_params() if hasattr(trace, "raw_params") else None
    params = peek if peek is not None else getattr(trace, "params", None)
    if not isinstance(params, dict) or "_batched_keys" not in params:
        return trace
    recorded_for = params.get("_batch_size")
    if recorded_for is not None and index not in range(recorded_for):
        raise IndexError(
            f"Element {index} is outside the batch of size {recorded_for}"
            " this per-instance transform was recorded for"
        )
    keep = params.get("_keep")
    if keep is not None and not keep[index]:
        return None
    element_params = _slice_params(params, index, params["_batched_keys"])
    return trace.replace_params(element_params)


def _slice_history(history: list[Any], index: int) -> list[Any]:
    """Per-subject history for batch element ``index``."""
    views = (_trace_for_element(trace, index) for trace in history)
    return [view for view in views if view is not None]
