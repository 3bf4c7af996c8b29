"""Compose: apply transforms in sequence.

Counterpart of ``torchio_tpu/transforms/compose.py`` (one deep copy up
front, children run with ``copy=False``; ``fuse=True`` runs consecutive
elementwise transforms as one fused chain). OneOf and SomeOf come later.
"""

from __future__ import annotations

import copy as _copy
from collections.abc import Mapping, Sequence
from typing import Any

from .transform import Transform


class Compose(Transform):
    """Apply transforms sequentially (one deep copy up front).

    With ``fuse=True``, consecutive elementwise transforms (anything
    providing :meth:`Transform.fused_stage`: Noise and BiasField in this
    package) run as one chain through :func:`.fuse.run_fused`; results
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
            if t.fusable(batch):
                # Transform.forward's RNG order: coin, then make_params
                # (inside fused_stage)
                if gate_coin(t, batch):
                    pending.append((t, t.fused_stage(batch)))
                continue
            batch = run_fused(batch, pending)
            pending = []
            batch = _run_child(t, batch)
        return run_fused(batch, pending)

    def __iter__(self):
        return iter(self.transforms)

    def __len__(self) -> int:
        return len(self.transforms)


def _run_child(transform: Transform, batch):
    """Run a child without its own deep copy (the composer copied once)."""
    prev = transform.copy
    transform.copy = False
    try:
        return transform(batch)
    finally:
        transform.copy = prev
