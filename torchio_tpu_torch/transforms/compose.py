"""Compose, OneOf, SomeOf.

Counterpart of ``torchio_tpu/transforms/compose.py``: one deep copy up
front and children run with ``copy=False``; ``fuse=True`` runs
consecutive elementwise transforms as one fused chain; OneOf's weighted
choice and SomeOf's random subsets. Per instance on a batch of more than
one element, OneOf and SomeOf unbatch, run each element as a batch of
one seeded with its history, and re-stack the elements with their
histories frozen per element (after a schema check).
"""

from __future__ import annotations

import contextlib
import copy as _copy
from collections.abc import Mapping, Sequence
from typing import Any

from .. import random as tio_random
from ..profiling import span
from .transform import Transform, apply_drawn


@contextlib.contextmanager
def _disabled_copy(transforms: Sequence[Transform]):
    """Children must not re-copy: the composer copied once already."""
    saved = [t.copy for t in transforms]
    for t in transforms:
        t.copy = False
    try:
        yield
    finally:
        for t, prev in zip(transforms, saved):
            t.copy = prev


class Compose(Transform):
    """Apply transforms sequentially (one deep copy up front).

    With ``fuse=True``, consecutive elementwise transforms (anything
    providing :meth:`Transform.fused_stage`: Flip, Noise, BiasField,
    Normalize, Gamma and the per-instance Blur in this package) run as
    one chain through :func:`.fuse.run_fused`; results
    and recorded history are identical to unfused execution (same host
    RNG stream). Transforms with host geometry (Spatial) break the run.
    """

    def __init__(
        self,
        transforms: Sequence[Transform] | Mapping[str, Transform] | None = None,
        *,
        copy: bool = True,
        fuse: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(copy=copy, **kwargs)
        if transforms is None:
            self.transforms: list[Transform] = []
        elif isinstance(transforms, Mapping):
            self.transforms = list(transforms.values())
        else:
            self.transforms = list(transforms)
        self.fuse = fuse

    def forward(self, data: Any) -> Any:
        if self.copy:
            with span(self, "copy"):
                data = _copy.deepcopy(data)
        batch, unwrap = self._wrap(data)
        if self.fuse:
            return unwrap(self._forward_fused(batch))
        for t in self.transforms:
            batch = _run_child(t, batch)
        return unwrap(batch)

    def _forward_fused(self, batch):
        from .fuse import gate_coin, run_fused

        pending: list = []
        for t in self.transforms:
            coin_drawn = False
            if t.fusable(batch):
                # Transform.forward's RNG order: coin, then make_params
                # (inside fused_stage)
                with span(t, "draw"):
                    if not gate_coin(t, batch):
                        continue
                    stage = t.fused_stage(batch)
                if stage is not None:
                    pending.append((t, stage))
                    continue
                # no stage after all: fused_stage draws nothing before it
                # decides, so t runs eagerly on the coin already drawn
                coin_drawn = True
            batch = run_fused(batch, pending)
            pending = []
            batch = apply_drawn(t, batch) if coin_drawn else _run_child(t, batch)
        return run_fused(batch, pending)

    def __iter__(self):
        return iter(self.transforms)

    def __len__(self) -> int:
        return len(self.transforms)

    def to_hydra(self) -> dict[str, Any]:
        cfg = super().to_hydra()
        cfg["transforms"] = [t.to_hydra() for t in self.transforms]
        return cfg


class _PerElementComposer(Transform):
    """Base of OneOf and SomeOf: per instance, every element draws its own
    p-coin and its own choice, and the children run on batches of one."""

    #: per instance, the composer gates each element alone and its children
    #: see one element at a time (``Queue.device_batches(prep_batch > 1)``
    #: reads this)
    runs_children_per_element = True

    def forward(self, data: Any) -> Any:
        if self.copy:
            with span(self, "copy"):
                data = _copy.deepcopy(data)
        batch, unwrap = self._wrap(data)
        with _disabled_copy(self.transforms):
            if self.per_instance and batch.batch_size > 1:
                return unwrap(self._forward_per_element(batch))
            if float(tio_random.random()) >= self.p:
                return unwrap(batch)
            return unwrap(self._apply_drawn_branch(batch))

    def _apply_drawn_branch(self, batch):
        raise NotImplementedError

    def _forward_per_element(self, batch):
        if self.p == 0:
            return batch
        out, any_applied = [], False
        for subject in batch.unbatch():
            if float(tio_random.random()) < self.p:
                any_applied = True
                subject = _apply_to_element(subject, self._apply_drawn_branch)
            out.append(subject)
        if not any_applied:
            return batch
        return _rebatch_with_history(out, type(self).__name__)

    def __iter__(self):
        return iter(self.transforms)

    def __len__(self) -> int:
        return len(self.transforms)

    def to_hydra(self) -> dict[str, Any]:
        cfg = super().to_hydra()
        cfg["transforms"] = [t.to_hydra() for t in self.transforms]
        return cfg


class OneOf(_PerElementComposer):
    """Apply one randomly chosen transform (optionally weighted).

    With ``per_instance=True`` (default) and a multi-element batch, each
    element independently draws its transform; elements are unbatched,
    transformed with their own history seeded, and re-stacked with
    per-element histories frozen.
    """

    def __init__(
        self,
        transforms: Sequence[Transform] | dict[Transform, float],
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(transforms, dict):
            self.transforms = list(transforms.keys())
            weights = [float(w) for w in transforms.values()]
            total = sum(weights)
            self.weights = [w / total for w in weights]
        else:
            self.transforms = list(transforms)
            n = len(self.transforms)
            self.weights = [1.0 / n] * n

    def _draw_index(self) -> int:
        return int(tio_random.get_rng().choice(len(self.transforms), p=self.weights))

    def _apply_drawn_branch(self, batch):
        return self.transforms[self._draw_index()](batch)


class SomeOf(_PerElementComposer):
    """Apply a random subset of transforms (fixed count or range)."""

    def __init__(
        self,
        transforms: Sequence[Transform] | None = None,
        *,
        num_transforms: int | tuple[int, int] = 1,
        replace: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.transforms = list(transforms) if transforms else []
        self.num_transforms = num_transforms
        self.replace = replace

    @property
    def _min_n(self) -> int:
        nt = self.num_transforms
        return nt if isinstance(nt, int) else nt[0]

    @property
    def _max_n(self) -> int:
        nt = self.num_transforms
        return nt if isinstance(nt, int) else nt[1]

    def _apply_drawn_branch(self, batch):
        rng = tio_random.get_rng()
        n = int(rng.integers(self._min_n, self._max_n + 1))
        total = len(self.transforms)
        if self.replace:
            indices = rng.integers(0, total, n)
        else:
            n = min(n, total)
            indices = rng.permutation(total)[:n]
        for idx in indices:
            batch = self.transforms[int(idx)](batch)
        return batch


def _apply_to_element(subject: Any, apply_fn: Any) -> Any:
    """Transform a single subject via a one-element batch seeded with
    the subject's prior history (so the history accumulates)."""
    from ..data.batch import SubjectsBatch

    element = SubjectsBatch.from_subjects([subject])
    element.applied_transforms = list(subject.applied_transforms)
    element = apply_fn(element)
    return element.unbatch()[0]


def _rebatch_with_history(subjects: list[Any], name: str) -> Any:
    from ..data.batch import SubjectsBatch

    _check_consistent_schema(subjects, name)
    try:
        batch = SubjectsBatch.from_subjects(subjects)
    except (RuntimeError, KeyError, ValueError) as error:
        raise RuntimeError(
            f"Per-instance {name} produced batch elements with different"
            " shapes or schemas, which cannot be re-stacked. Use only"
            " shape- and schema-preserving transforms with per-instance"
            f" {name}, or pass per_instance=False."
        ) from error
    batch.set_per_element_history([s.applied_transforms for s in subjects])
    return batch


def _check_consistent_schema(subjects: list[Any], name: str) -> None:
    if not subjects:
        return
    ref = {n: type(img) for n, img in subjects[0].images.items()}
    for subject in subjects[1:]:
        cur = {n: type(img) for n, img in subject.images.items()}
        if cur != ref:
            raise RuntimeError(
                f"Per-instance {name} produced batch elements with different"
                " image names or types, which cannot be re-stacked. Use only"
                f" schema-preserving transforms with per-instance {name},"
                " or pass per_instance=False."
            )


def _run_child(transform: Transform, batch):
    """Run a child without its own deep copy (the composer copied once)."""
    prev = transform.copy
    transform.copy = False
    try:
        return transform(batch)
    finally:
        transform.copy = prev
