"""Batch containers: 5D stacked image tensors with per-sample affines.

Counterpart of ``torchio_tpu/data/batch.py``: ``ImagesBatch`` and
``SubjectsBatch`` with per-element history slicing at :meth:`unbatch`,
and the per-element histories that a per-instance OneOf or SomeOf
freezes when it re-stacks its elements (``StudiesBatch`` is another
name of ``SubjectsBatch``). Building a batch from subjects loads any
image still on disk, through its ``data``.
Data is one ``(B, C, I, J, K)`` torch tensor; a batch runs where that
tensor lives. Affines stay float64 on the host, one per sample.

Transforms never write into a batch's tensor in place: every stage
assigns a new tensor. So a deep copy shares the tensor (as the JAX
package shares its immutable arrays) and copies only the metadata.

``shard_`` places a batch on a :mod:`torch.distributed` device mesh
(:mod:`..parallel.mesh`): its data becomes a ``DTensor`` of the global
shape, and every stage's output is placed the same way until the batch
size changes or ``unshard_`` is called; a stage that changes C or a
spatial extent keeps its placement (a new extent by ``torch.chunk``'s
split). Splits of B and J stay on each rank's region: stages with a
sharded path (``Transform.takes_sharded``: every stage but Lambda and
the MONAI/Cornucopia adapters) take the DTensors, the others run on the
whole tensors inside :func:`gathered`. A sharding that splits C, I or K
over a mesh axis of more than one rank
(``NamedSharding.splits_c_i_or_k``) runs every stage inside
:func:`gathered`: each rank holds the whole batch while the stage runs
and keeps its region after it, with the unsharded call's results (a
spec entry naming a one-rank axis leaves its dim whole). ``to`` casts a
sharded batch on each rank's block; a move to another device gathers it
and drops the sharding.
"""

from __future__ import annotations

import contextlib
import copy as _copy
from typing import Any

import numpy as np
import torch

from ..config import as_tensor
from ..core.affine import AffineMatrix
from ..parallel.mesh import NamedSharding, is_dtensor, mesh_device, place, region_of
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
        self._sharding: NamedSharding | None = None
        #: inside :func:`gathered`: ``data`` holds the whole tensor and the
        #: setter does not place what a stage assigns
        self._gathered = False
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
        if self._sharding is not None and value.shape[0] == self._data.shape[0]:
            # a sharded batch keeps every stage's output on the mesh: each
            # rank keeps its region of a whole result, with no
            # communication (a shape-changing stage is placed too; only a
            # batch-size change drops the sharding)
            if not self._gathered:
                value = place(value, self._sharding)
        elif self._sharding is not None:
            self._sharding = None
            if is_dtensor(value):
                value = value.full_tensor()
        self._data = value

    @property
    def sharding(self) -> NamedSharding | None:
        """The mesh placement enforced on ``data`` (None: unmanaged)."""
        return self._sharding

    @property
    def stages_take_whole(self) -> bool:
        """Whether each stage takes this batch's whole tensor: its sharding
        splits C, I or K over more than one rank
        (:attr:`~..parallel.mesh.NamedSharding.splits_c_i_or_k`)."""
        return self._sharding is not None and self._sharding.splits_c_i_or_k

    def shard_(self, mesh_or_sharding: Any, *, spatial: bool = False) -> "ImagesBatch":
        """Place ``data`` on a mesh and keep transform outputs there.

        Args:
            mesh_or_sharding: a DeviceMesh (the batch axis goes over its
                first axis; with ``spatial=True`` the J axis goes over its
                second) or a :class:`~..parallel.mesh.NamedSharding`, any
                spec of the mesh's axes over (B, C, I, J, K).
            spatial: also shard the J axis (for volumes larger than one
                card's memory; Spatial and Blur then exchange halos).

        Every rank must hold the same whole batch; each keeps its region.
        Splits of B and J stay on each rank's region while the stages run.
        A spec that splits C, I or K over a mesh axis of more than one rank
        (:attr:`stages_take_whole`) gives each stage the whole tensor
        (gathered once a stage, the counterpart of XLA's all-gather where
        it cannot partition), and each rank keeps its region of the
        result: the same results, at the memory of the whole batch on
        every rank while a stage runs.
        """
        if isinstance(mesh_or_sharding, NamedSharding):
            sharding = mesh_or_sharding
        else:
            mesh = mesh_or_sharding
            names = mesh.mesh_dim_names
            space = names[1] if spatial and len(names) > 1 else None
            sharding = NamedSharding(mesh, (names[0], None, None, space, None))
        self._sharding = sharding
        self._data = place(self._whole().to(mesh_device(sharding.mesh)), sharding)
        return self

    def unshard_(self) -> "ImagesBatch":
        """Stop enforcing the mesh placement: ``data`` becomes the whole
        tensor on every rank (one all-gather)."""
        self._sharding = None
        self._data = self._whole()
        return self

    def _whole(self) -> torch.Tensor:
        """The whole tensor (gathered from the mesh if sharded)."""
        return self._data.full_tensor() if is_dtensor(self._data) else self._data

    def __deepcopy__(self, memo: dict) -> "ImagesBatch":
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        new._data = self._data
        new._affines = [a.clone() for a in self._affines]
        new._image_class = self._image_class
        new._sharding = self._sharding
        new._gathered = self._gathered
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

    def affines_array(self, dtype=np.float32) -> np.ndarray:
        """(B, 4, 4) stacked affines, on the host, in ``dtype``."""
        return np.stack([a.data for a in self._affines]).astype(dtype)

    def to(self, device: Any = None, dtype: Any = None) -> "ImagesBatch":
        """Move or cast ``data``. A sharded batch cast on its mesh's device
        stays sharded, each rank casting its block (no communication); one
        moved elsewhere is gathered and drops the sharding."""
        if self._sharding is not None and is_dtensor(self._data) and self._on_mesh(device):
            region = region_of(self._data)
            self._data = region.wrap(region.local.to(dtype=dtype))
            return self
        data = self._whole().to(device=device, dtype=dtype)
        if self._sharding is not None and data.device != mesh_device(self._sharding.mesh):
            self._sharding = None
        self.data = data
        return self

    def _on_mesh(self, device: Any) -> bool:
        """Whether ``device`` (None: where the data is) is the device of
        this rank's shards."""
        if device is None:
            return True
        device, here = torch.device(device), mesh_device(self._sharding.mesh)
        return device.type == here.type and device.index in (None, here.index)

    def __getitem__(self, index: int) -> Image:
        """Element ``index`` as an Image: a view of the batch's (whole)
        tensor on its device, with a cloned affine."""
        return self._image_class(self._whole()[index], affine=self._affines[index].clone())

    def __len__(self) -> int:
        return self.batch_size

    def unbatch(self) -> list[Image]:
        """One Image per element (see ``__getitem__``; a sharded batch is
        gathered once)."""
        whole = self._whole()
        return [
            self._image_class(whole[i], affine=self._affines[i].clone())
            for i in range(self.batch_size)
        ]

    def __repr__(self) -> str:
        b, c, i, j, k = self._data.shape
        return (
            f"ImagesBatch({self._image_class.__name__}, batch_size={b},"
            f" shape=({c}, {i}, {j}, {k}), device={self.device})"
        )


class SubjectsBatch(Invertible):
    """Named image batches + per-sample metadata lists.

    The unit every transform operates on. Supports per-element history
    slicing on :meth:`unbatch` and per-element branch histories from
    per-instance OneOf/SomeOf.
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
        self._per_element_history: list[list[Any]] | None = None

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

    @property
    def stages_take_whole(self) -> bool:
        """Whether each stage takes the whole tensors: an image's sharding
        splits C, I or K over more than one rank
        (:attr:`ImagesBatch.stages_take_whole`)."""
        return any(ib.stages_take_whole for ib in self._images.values())

    def shard_(self, mesh_or_sharding: Any, *, spatial: bool = False) -> "SubjectsBatch":
        """Place every image batch on a mesh; transform outputs stay there
        (see :meth:`ImagesBatch.shard_`): B and J splits on each rank's
        region, and a spec that splits C, I or K over more than one rank
        gathered for each stage, each rank keeping its region after it."""
        for batch in self._images.values():
            batch.shard_(mesh_or_sharding, spatial=spatial)
        return self

    def unshard_(self) -> "SubjectsBatch":
        for batch in self._images.values():
            batch.unshard_()
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

    # --- Per-element history ---

    def set_per_element_history(self, histories: list[list[Any]]) -> None:
        """Freeze distinct per-element histories (per-instance OneOf path)."""
        if len(histories) != self.batch_size:
            raise ValueError(
                f"Expected {self.batch_size} per-element histories,"
                f" got {len(histories)}"
            )
        self._per_element_history = [list(h) for h in histories]
        self.applied_transforms = []

    def adopt_history(self, source: "SubjectsBatch", subjects: list[Any]) -> None:
        """Carry history over after an unbatch -> process -> re-stack round trip."""
        if source._per_element_history is not None:
            self.set_per_element_history([s.applied_transforms for s in subjects])
        else:
            self.applied_transforms = list(source.applied_transforms)

    def clear_history(self) -> None:
        self.applied_transforms = []
        self._per_element_history = None

    # --- Unbatch ---

    def unbatch(self) -> list[Subject]:
        """Split into Subjects, slicing per-instance history per element;
        a frozen per-element history comes before the batch-wide suffix."""
        subjects = []
        for i in range(self.batch_size):
            kwargs: dict[str, Any] = {name: ib[i] for name, ib in self._images.items()}
            for key, values in self._metadata.items():
                kwargs[key] = values[i]
            sub = Subject(**kwargs)
            suffix = _slice_history(self.applied_transforms, i)
            if self._per_element_history is not None:
                sub.applied_transforms = list(self._per_element_history[i]) + suffix
            else:
                sub.applied_transforms = suffix
            subjects.append(sub)
        return subjects

    # --- Inversion ---

    def get_inverse_transform(self, **kwargs: Any):
        if self._per_element_history is not None:
            raise RuntimeError(
                "This batch has per-element transform histories; a single"
                " batch inverse is ambiguous. Use apply_inverse_transform()"
                " or unbatch() and invert per subject."
            )
        return super().get_inverse_transform(**kwargs)

    def apply_inverse_transform(self, **kwargs: Any) -> "SubjectsBatch":
        if self._per_element_history is not None:
            inverted = [s.apply_inverse_transform(**kwargs) for s in self.unbatch()]
            return type(self).from_subjects(inverted)
        return super().apply_inverse_transform(**kwargs)

    def __repr__(self) -> str:
        names = ", ".join(self._images)
        return f"SubjectsBatch(batch_size={self.batch_size}, images=[{names}])"


@contextlib.contextmanager
def gathered(batch: SubjectsBatch):
    """Run a stage that has no sharded path on whole tensors.

    Each sharded image's DTensor is gathered (``full_tensor()``, the
    counterpart of the all-gather XLA inserts where it cannot partition),
    the stage reads and assigns whole tensors, and on exit each rank keeps
    its region of what the stage left (of a new image given a sharding
    too). Every rank runs the same program from the same host draws, so
    the result equals the unsharded one."""
    images = [
        ib for ib in batch.images.values()
        if ib._sharding is not None and is_dtensor(ib._data)
    ]
    for ib in images:
        ib._data = ib._data.full_tensor()
        ib._gathered = True
    try:
        yield
    finally:
        for ib in images:
            ib._gathered = False
        for ib in batch.images.values():
            if ib._sharding is not None and not is_dtensor(ib._data):
                ib.data = ib._data


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


StudiesBatch = SubjectsBatch
