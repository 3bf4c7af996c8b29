"""Port parity: the B-spline prefilter and spline against the JAX package.

On the CPU the port runs its plain versions, :func:`prefilter_plain` and
:func:`bspline_resample_plain` (what the CUDA kernels are held to on the
card):

- the prefilter against ``torchio_tpu.ops.bspline.prefilter``: within
  1e-6 of the largest coefficient (float32 recursions and geometric sums
  taken in another order), on long axes (truncated start) and short ones
  (periodic start);
- the spline against ``bspline_resample`` (XLA) at the JAX package's own
  tolerances, 2e-5 for orders 2-3 and 5e-5 for orders 4-7
  (``tests/test_window_resample.py``), on an output grid unlike the
  input;
- orders 0-7 against the frozen oracle corpus
  ``tests/data/bspline_golden.npz`` at BASELINE.md's per-order budgets.
"""

from __future__ import annotations

import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from test_torch_label_spline import _maps
from torchio_tpu.ops import bspline as jax_bspline
from torchio_tpu.ops.resample import build_coords as jax_coords
from torchio_tpu.ops.resample import upsample_field as jax_upsample
from torchio_tpu_torch.ops import bspline as bs

# the ops package exports the function ``resample`` under its module's name
rs = importlib.import_module("torchio_tpu_torch.ops.resample")

PREFILTER_RTOL = 1e-6
SPLINE_ATOL = {2: 2e-5, 3: 2e-5, 4: 5e-5, 5: 5e-5, 6: 5e-5, 7: 5e-5}
#: BASELINE.md "B-spline parity budgets (orders 0-7, frozen corpus)"
CORPUS_BUDGETS = {0: 1e-6, 1: 1e-6, 2: 3e-6, 3: 5e-6, 4: 5e-6, 5: 1e-5, 6: 2e-5, 7: 4e-5}




@pytest.mark.parametrize("shape", [(2, 16, 18, 40), (1, 3, 5, 40)], ids=["long", "short"])
@pytest.mark.parametrize("order", range(2, 8))
def test_prefilter_matches_jax(order, shape):
    """The short volume's axes of 3 and 5 take the periodic start."""
    x = np.random.default_rng(order).random(shape, np.float32)
    want = np.asarray(jax_bspline.prefilter(jnp.asarray(x), order))
    got = bs.prefilter_plain(torch.as_tensor(x), order).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=PREFILTER_RTOL * scale)


def test_pole_constants_choose_the_periodic_start_on_short_axes():
    _, long_axis = bs.pole_constants(3, 40)
    _, short_axis = bs.pole_constants(3, 5)
    assert long_axis[0][1] < 40 <= long_axis[0][1] * 3
    assert short_axis[0][1] >= 5
    # a size-1 axis is left as it is; its constants are still defined
    lam, size_one = bs.pole_constants(7, 1)
    assert np.isfinite(lam) and all(np.isfinite(c).all() for c in size_one)


def _spline_case(seed=0, *, shape=(2, 2, 16, 18, 40), **kw):
    rng = np.random.default_rng(seed)
    data = rng.random(shape, np.float32)
    ms, cps = _maps(shape[2:], rng, **kw)
    fill = np.array([[0.3, -1.0], [2.0, 0.5]], np.float32)[: shape[0], : shape[1]]
    return data, ms, cps, fill


def _port_spline(data, ms, cps, fill, order, out=None) -> np.ndarray:
    got = bs.bspline_resample_fused(
        torch.as_tensor(data), ms, cps, order=order, out_shape=out,
        fill=torch.as_tensor(fill),
    )
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("order", range(2, 8))
def test_spline_matches_jax_bspline_resample(order):
    data, ms, cps, fill = _spline_case(order)
    out = (18, 15, 33)
    coords = np.stack([
        np.asarray(jax_coords(out, m) + (0.0 if c is None else jax_upsample(
            np.float32(c), out)))
        for m, c in zip(ms, cps)
    ])
    want = jax_bspline.bspline_resample(
        jnp.asarray(data), jnp.asarray(coords), order=order, fill=jnp.asarray(fill)
    )
    got = _port_spline(data, ms, cps, fill, order, out)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SPLINE_ATOL[order])


@pytest.mark.parametrize("order", range(8))
def test_frozen_golden_corpus(order):
    """The dense-collocation oracle values frozen in
    tests/data/bspline_golden.npz, at BASELINE.md's budgets."""
    corpus = np.load(pathlib.Path(__file__).parent / "data" / "bspline_golden.npz")
    vol = torch.as_tensor(corpus["volume"])[None]
    ci, cj, ck = (torch.as_tensor(corpus["points"][:, a]) for a in range(3))
    if order >= 2:
        coeffs = bs.prefilter_plain(vol, order)
        vals = bs.bspline_sample_plain(coeffs, ci, cj, ck, order)
        mask = bs._inbounds_mask((ci, cj, ck), vol.shape[-3:])
        got = torch.where(mask > 0.5, vals, 0.0)
    else:
        mode = "nearest" if order == 0 else "linear"
        got = rs._sample(vol, ci, cj, ck, torch.zeros(1), mode, True)
    np.testing.assert_allclose(
        got.reshape(-1).numpy(), corpus[f"order_{order}"], rtol=0,
        atol=CORPUS_BUDGETS[order],
    )


def test_spline_reproduces_samples_at_integer_coordinates():
    x = torch.as_tensor(np.random.default_rng(1).random((1, 2, 9, 7, 11), np.float32))
    out = bs.bspline_resample_fused(x, [np.eye(4)], [None], order=3)
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=0, atol=2e-6)


def test_spline_rejects_other_orders():
    with pytest.raises(ValueError, match="order must be 2-7"):
        bs.prefilter_plain(torch.zeros((4, 4, 4)), 1)
