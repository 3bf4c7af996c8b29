"""Fused elementwise transform chains.

Counterpart of ``torchio_tpu/transforms/fuse.py`` for the families this
package has: Noise and BiasField. ``Compose(..., fuse=True)`` collects
consecutive elementwise transforms into one chain. In the JAX package
the chain is one jit-compiled program; here it runs eagerly, stage by
stage, and keeps the contract that matters to users:

- eligibility is decided WITHOUT consuming RNG (the caller draws the
  p-gate coin between the check and the build, exactly like
  ``Transform.forward``);
- the build calls ``make_params`` verbatim, so the host RNG stream and
  the recorded history are identical to unfused execution;
- every apply mirrors the unfused arithmetic op for op (gated-out
  elements bit-exact).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import random as tio_random
from .transform import Transform, record_history


@dataclass
class FusedStage:
    """One transform's contribution to a fused chain."""

    #: names of the images the stage reads and writes
    names: tuple[str, ...]
    #: ``(datas, args) -> datas`` on the batch's tensors
    apply: Callable
    #: the stage's tensor arguments
    args: Any
    #: history params (JSON values)
    params: dict


def run_fused(batch, stages: list[tuple[Transform, FusedStage]]):
    """Execute a run of fused stages and record their history."""
    if not stages:
        return batch
    names = sorted({n for _, s in stages for n in s.names})
    datas = {n: batch.images[n].data for n in names}
    for _, stage in stages:
        datas = stage.apply(datas, stage.args)
    for n in names:
        batch.images[n].data = datas[n]
    for transform, stage in stages:
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
    from .intensity.noise import noise_field

    def apply(datas, args):
        mean, std, keep, seed = args
        out = dict(datas)
        for n, nm in enumerate(names):
            data = out[nm]
            m = _bparam(mean, data.ndim)
            s = _bparam(std, data.ndim)
            noise = noise_field(seed, 2 * n + 1, data, m, s)
            if rician:
                noise2 = noise_field(seed, 2 * n + 2, data, m, s)
                res = torch.sqrt((data + noise) ** 2 + noise2**2)
            else:
                res = data + noise
            if gated:
                mask = keep.reshape((-1,) + (1,) * (data.ndim - 1))
                res = torch.where(mask > 0.5, res, data.to(res.dtype))
            out[nm] = res
        return out

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
            return datas
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
        return out

    return apply
