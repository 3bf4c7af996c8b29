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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import random as tio_random
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


def run_fused(batch, stages: list[tuple[Transform, FusedStage]]):
    """Execute a run of fused stages and record their history."""
    if not stages:
        return batch
    names = sorted({n for _, s in stages for n in s.names})
    datas = {n: batch.images[n].data for n in names}
    auxes = []
    for _, stage in stages:
        datas, aux = stage.apply(datas, stage.args)
        auxes.append(aux)
    for n in names:
        batch.images[n].data = datas[n]
    for (transform, stage), aux in zip(stages, auxes):
        if stage.finish is not None:
            stage.finish(aux, stage.params)
        record_history(batch, transform, stage.params)
    return batch


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


def noise_apply(names: tuple[str, ...], rician: bool, gated: bool):
    from .intensity.noise import add_noise

    def apply(datas, args):
        mean, std, keep, seed = args
        out = dict(datas)
        for n, nm in enumerate(names):
            data = out[nm]
            m = _bparam(mean, data.ndim)
            s = _bparam(std, data.ndim)
            res = add_noise(seed, n, data, m, s, rician)
            if gated:
                mask = keep.reshape((-1,) + (1,) * (data.ndim - 1))
                res = torch.where(mask > 0.5, res, data.to(res.dtype))
            out[nm] = res
        return out, None

    return apply


def bias_apply(
    names: tuple[str, ...],
    scale: float,
    per_element: bool,
    gated: bool,
    all_identity: bool,
):
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
                if gated:
                    mask = keep.reshape((-1,) + (1,) * (data.ndim - 1))
                    res = torch.where(mask > 0.5, res, data)
            else:
                res = bias_shared(data, stds, seeds, scale, False)
            out[nm] = res
        return out, None

    return apply


def flip_static_apply(names: tuple[str, ...], dims: tuple[int, ...]):
    def apply(datas, args):
        if not dims:
            return datas, None
        return {**datas, **{nm: torch.flip(datas[nm], dims) for nm in names}}, None

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
    from ..ops.gaussian import blur_per_element
    from ._utils import restore_gated

    def apply(datas, args):
        out = dict(datas)
        for nm in names:
            sig_vox, radii, row_keep = args[nm]
            if not row_keep.any():
                continue
            data = out[nm]
            sig = torch.as_tensor(sig_vox.astype(np.float32), device=data.device)
            res = blur_per_element(data, sig, radii, truncate).to(data.dtype)
            out[nm] = restore_gated(res, data, row_keep)
        return out, None

    return apply


def normalize_apply(names: tuple[str, ...], percentiles: tuple[float, float] | None):
    """Rescale with the explicit input range of ``params`` (percentiles
    None) or with the percentiles of each image's first element, computed
    here on the device and returned as aux (deferred pairs)."""
    from .intensity.normalize import range_pair, rescale

    def apply(datas, params):
        out = dict(datas)
        aux = {}
        for nm in names:
            data = out[nm]
            if percentiles is None:
                bounds = (params["in_min"], params["in_max"])
            else:
                flat = data[0].to(torch.float32).reshape(-1)
                bounds = DeferredParam(range_pair(flat, *percentiles), finalize_range_warn(nm))
                aux[nm] = bounds
            res = rescale(data, bounds, params["out_min"], params["out_max"], nm)
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
    from .intensity.standardize import standardize_stats, standardized

    def apply(datas, args):
        out = dict(datas)
        aux = {}
        mask = None if mask_name is None else datas[mask_name][0] != 0
        for nm in names:
            triple = standardize_stats(out[nm][0].to(torch.float32), mask)
            aux[nm] = triple
            out[nm] = standardized(out[nm], triple)
        return out, aux

    return apply


def mask_apply(
    names: tuple[str, ...], mask_name: str, labels: tuple | None, outside_value: float
):
    from .intensity.mask import label_mask

    def apply(datas, args):
        mask = label_mask(datas[mask_name][0], labels)
        return {
            **datas,
            **{nm: torch.where(mask, datas[nm], outside_value) for nm in names},
        }, None

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
