"""Multi-GPU preprocessing on ``torch.distributed``.

Counterpart of ``torchio_tpu/parallel``: a (data, space) DeviceMesh,
DTensor placement of a batch, halo-exchange stencils on J-sharded
volumes, the fused augmentation step, sharded patch inference, volumes
larger than one card streamed file to file, and a per-rank subject
sampler. The modules load on first use (the batch and the ops import
:mod:`.mesh` on their own).
"""

from __future__ import annotations

import importlib

_SOURCES = {
    "DistributedSubjectSampler": "sampler",
    "batch_sharding": "mesh",
    "halo_blur": "halo",
    "halo_resample_affine": "halo",
    "make_augment_step": "step",
    "make_mesh": "mesh",
    "process_large_volume": "large",
    "replicated_sharding": "mesh",
    "sample_step_params": "step",
    "shard_batch": "mesh",
    "shard_volume_from_file": "large",
    "sharded_grid_inference": "patches",
    "write_volume_sharded": "large",
}

__all__ = sorted(_SOURCES)


def __getattr__(name: str):
    if name not in _SOURCES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_SOURCES[name]}", __name__), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
