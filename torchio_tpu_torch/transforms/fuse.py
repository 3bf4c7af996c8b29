"""Fused elementwise transform chains.

Counterpart of ``torchio_tpu/transforms/fuse.py`` for the families this
package has: Flip, Noise, BiasField, Normalize/RescaleIntensity, Gamma,
the per-instance Blur, Clamp, Standardize and Mask. ``Compose(..., fuse=True)`` collects
consecutive elementwise transforms into one chain. In the JAX package
the chain is one jit-compiled program; here it runs eagerly, stage by
stage, and keeps the contract that matters to users:

- eligibility is decided WITHOUT consuming RNG (the caller draws the
  p-gate coin between the check and the build, exactly like
  ``Transform.forward``);
- the build calls ``make_params`` (or draws in its order), so the host
  RNG stream and the recorded history are identical to unfused
  execution;
- every apply mirrors the unfused arithmetic op for op (gated-out
  elements bit-exact); statistics computed on the device come back as
  the apply's aux output, and the stage's ``finish`` puts them into the
  history as :class:`DeferredParam` entries.

On a sharded batch a stage with ``takes_sharded`` takes the DTensors and
computes on each rank's region: Noise and BiasField draw only their
region's elements, Gamma and Clamp map it, Flip takes the mirror columns
along a split axis, Blur takes halo taps there, and Normalize,
Standardize and Mask read element 0's statistic or mask where it lies
(one ``all_reduce``, ``broadcast`` or one element's ``all_gather``). A
run of other stages takes the whole tensors, gathered once, and the
batch's setter places what the chain leaves. A batch whose sharding
splits C, I or K over more than one rank runs the chain inside
:func:`..data.batch.gathered`: one gather an image for the run, and each
rank keeps its region of what the chain leaves.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import random as tio_random
from ..data.batch import gathered
from ..parallel.mesh import is_dtensor, place
from ..profiling import span
from .transform import DeferredParam, Transform, record_history


@dataclass
class FusedStage:
    """One transform's contribution to a fused chain."""

    #: names of the images the stage reads and writes
    names: tuple[str, ...]
    #: ``(datas, args) -> (datas, aux)`` on the batch's tensors
    apply: Callable
    #: the stage's arguments
    args: Any
    #: history params (JSON values; aux-backed entries filled by finish)
    params: dict
    #: optional ``(aux, params) -> None`` run after the chain
    finish: Callable | None = None
    #: the apply takes a sharded image's DTensor (else its whole tensor)
    takes_sharded: bool = False


def run_fused(batch, stages: list[tuple[Transform, FusedStage]]):
    """Execute a run of fused stages and record their history (the whole
    run inside :func:`..data.batch.gathered` where the batch splits C, I
    or K over more than one rank)."""
    if not stages:
        return batch
    scope = gathered(batch) if batch.stages_take_whole else contextlib.nullcontext()
    with scope:
        names = sorted({n for _, s in stages for n in s.names})
        datas = {n: batch.images[n].data for n in names}
        auxes = []
        with span("fused", "apply"):
            for _, stage in stages:
                datas = _as_stage_takes(batch, datas, stage.takes_sharded)
                datas, aux = stage.apply(datas, stage.args)
                auxes.append(aux)
            for n in names:
                batch.images[n].data = datas[n]
        for (transform, stage), aux in zip(stages, auxes):
            with span(transform, "record"):
                if stage.finish is not None:
                    stage.finish(aux, stage.params)
                record_history(batch, transform, stage.params)
    return batch


def _as_stage_takes(batch, datas: dict, takes_sharded: bool) -> dict:
    """Each sharded image's data as the next stage takes it: placed on the
    mesh (no communication) or whole (gathered, once for a run of such
    stages; inside ``gathered`` every stage takes it whole)."""
    out = {}
    for name, data in datas.items():
        sharding = batch.images[name].sharding
        if sharding is not None and takes_sharded and not batch.stages_take_whole:
            data = place(data, sharding)
        elif sharding is not None and is_dtensor(data):
            data = data.full_tensor()
        out[name] = data
    return out


def gate_coin(transform: Transform, batch) -> bool:
    """The p-gate exactly as ``Transform.forward`` draws it. Returns
    True when the transform applies (per-instance gating handles p
    inside params)."""
    return (
        transform._per_instance_p_active(batch)
        or float(tio_random.random()) < transform.p
    )


def _bparam(value: torch.Tensor, ndim: int) -> torch.Tensor:
    """A 0-d scalar, or a (B,) tensor reshaped to broadcast over (B, ...)."""
    if value.ndim == 0:
        return value
    return value.reshape((-1,) + (1,) * (ndim - 1))


def noise_apply(names: tuple[str, ...], rician: bool):
    from ._utils import restore_gated
    from .intensity.noise import add_noise

    def apply(datas, args):
        mean, std, keep, seed = args
        out = dict(datas)
        for n, nm in enumerate(names):
            data = out[nm]
            m, s = _bparam(mean, data.ndim), _bparam(std, data.ndim)
            out[nm] = restore_gated(add_noise(seed, n, data, m, s, rician), data, keep)
        return out, None

    return apply


def bias_apply(names: tuple[str, ...], scale: float, per_element: bool, all_identity: bool):
    from ._utils import restore_gated
    from .intensity.bias_field import bias_per_element, bias_shared

    def apply(datas, args):
        if all_identity:
            return datas, None
        out = dict(datas)
        stds, seeds, keep = args
        for nm in names:
            data = out[nm]
            if per_element:
                res = bias_per_element(data, stds, seeds, scale, False)
                out[nm] = restore_gated(res, data, keep)
            else:
                out[nm] = bias_shared(data, stds, seeds, scale, False)
        return out, None

    return apply


def flip_static_apply(names: tuple[str, ...], dims: tuple[int, ...]):
    from .spatial.flip import flip

    def apply(datas, args):
        if not dims:
            return datas, None
        return {**datas, **{nm: flip(datas[nm], dims) for nm in names}}, None

    return apply


def flip_per_element_apply(names: tuple[str, ...]):
    from .spatial.flip import flip_per_element

    def apply(datas, flags):
        return {**datas, **{nm: flip_per_element(datas[nm], flags) for nm in names}}, None

    return apply


def gamma_apply(names: tuple[str, ...]):
    from .intensity.gamma import gamma_pow

    def apply(datas, log_gamma):
        return {**datas, **{nm: gamma_pow(datas[nm], log_gamma) for nm in names}}, None

    return apply


def blur_apply(names: tuple[str, ...], truncate: float):
    """Per-element blur; ``args[name]`` is (B, 3) voxel sigmas, the static
    radii and the rows that blur (the others stay bit-exact)."""
    from ..ops.gaussian import _cast, blur_per_element
    from ._utils import restore_gated

    def apply(datas, args):
        out = dict(datas)
        for nm in names:
            sig_vox, radii, row_keep = args[nm]
            if not row_keep.any():
                continue
            data = out[nm]
            sig = torch.as_tensor(sig_vox.astype(np.float32), device=data.device)
            res = _cast(blur_per_element(data, sig, radii, truncate), data.dtype)
            out[nm] = restore_gated(res, data, row_keep)
        return out, None

    return apply


def normalize_apply(names: tuple[str, ...], percentiles: tuple[float, float] | None):
    """Rescale with the explicit input range of ``params`` (percentiles
    None) or with the percentiles of each image's first element, computed
    here on the device and returned as aux (deferred pairs)."""
    from .intensity.normalize import first_range, rescale_region

    def apply(datas, params):
        out = dict(datas)
        aux = {}
        for nm in names:
            data = out[nm]
            if percentiles is None:
                bounds = (params["in_min"], params["in_max"])
            else:
                bounds = first_range(data, None, *percentiles, nm)
                aux[nm] = bounds
            res = rescale_region(data, bounds, params["out_min"], params["out_max"], nm)
            if res is not None:
                out[nm] = res
        return out, aux

    return apply


def clamp_apply(names: tuple[str, ...], out_min: float | None, out_max: float | None):
    from .intensity.clamp import clamp_values

    def apply(datas, args):
        return {**datas, **{nm: clamp_values(datas[nm], out_min, out_max) for nm in names}}, None

    return apply


def standardize_apply(names: tuple[str, ...], mask_name: str | None):
    """Each image standardized by the statistics of its first element
    (within ``mask_name``'s non-zero voxels); the device triples return
    as aux."""
    from .intensity.standardize import first_stats, standardized

    def apply(datas, args):
        out = dict(datas)
        aux = {}
        mask = None if mask_name is None else datas[mask_name]
        for nm in names:
            triple = first_stats(out[nm], mask)
            aux[nm] = triple
            out[nm] = standardized(out[nm], triple)
        return out, aux

    return apply


def mask_apply(
    names: tuple[str, ...], mask_name: str, labels: tuple | None, outside_value: float
):
    from .intensity.mask import first_mask, masked

    def apply(datas, args):
        mask = first_mask(datas[mask_name], labels)
        return {**datas, **{nm: masked(datas[nm], mask, outside_value) for nm in names}}, None

    return apply


def install_standardize_params(aux: dict, params: dict) -> None:
    from .intensity.standardize import _finalize_stats

    params["stats"] = {
        nm: DeferredParam(triple, _finalize_stats(nm), eager=True)
        for nm, triple in aux.items()
    }


def finalize_range_warn(name: str):
    """Host finalizer of a deferred (low, high) pair: warns on a zero
    range."""
    import warnings

    def finalize(host: np.ndarray) -> tuple[float, float]:
        low, high = float(host[0]), float(host[1])
        if high - low == 0:
            warnings.warn(
                f'Cannot rescale "{name}": input range is zero.',
                RuntimeWarning,
                stacklevel=2,
            )
        return (low, high)

    return finalize


def install_range_params(aux: dict, params: dict) -> None:
    params["in_ranges"] = dict(aux)
