"""Port parity: config 1 (Flip + Noise + RescaleIntensity) against the JAX
package.

BASELINE.json config 1 (``benchmarks/suite.py:96-111``) is
``Compose([Flip(axes=(0,), flip_probability=0.5), Noise(std=0.1),
RescaleIntensity(0, 1)], fuse=True)``. Each new module (Flip,
Normalize/RescaleIntensity and their inverses, the exact quantiles of
``_statistics``) and the pipeline as a whole run in both packages from
the same seed on the same numpy volumes (B=2, about 20^3), fused and
unfused:

- Flip is exact: outputs equal, params equal;
- the quantiles are equal bit for bit (``compute_quantiles``);
- rescaled outputs within rtol/atol 1e-6 (``tests/test_fuse.py:44``);
  the recorded input ranges within rtol 1e-6 (``tests/test_fuse.py:87``),
  every other param equal;
- the next host draw after the call is the same in both packages;
- elements gated out by a per-instance ``p`` stay bit-exact;
- each inverse, built with ``inverse(params)``, undoes its transform.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_intensity import make_batches
from torchio_tpu.transforms import _statistics as jax_statistics
from torchio_tpu_torch.transforms import _statistics as port_statistics

RTOL, ATOL = 1e-6, 1e-6
SHAPE = (1, 18, 20, 22)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def config1(pkg, fuse=True):
    return pkg.Compose(
        [
            pkg.Flip(axes=(0,), flip_probability=0.5),
            pkg.Noise(std=0.1),
            pkg.RescaleIntensity(out_min=0.0, out_max=1.0),
        ],
        fuse=fuse,
    )


def run_both(make, seed=7, b=2, fuse=False, **batch_kwargs):
    """``make(pkg)`` in both packages from one seed: (jax_out, port_out,
    the next host draw of each)."""
    jax_batch, port_batch = make_batches(b=b, shape=SHAPE, **batch_kwargs)
    outs, draws = [], []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        transform = make(pkg)
        if fuse:
            transform = pkg.Compose([transform], fuse=True)
        pkg.seed(seed)
        outs.append(transform(batch))
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1]
    return outs[0], outs[1]


def assert_params_match(jax_out, port_out):
    jh, ph = jax_out.applied_transforms, port_out.applied_transforms
    assert [h.name for h in jh] == [h.name for h in ph]
    for a, b in zip(jh, ph):
        pa, pb = a.params, b.params
        assert set(pa) == set(pb), a.name
        for key in pa:
            if key == "in_ranges":
                assert set(pa[key]) == set(pb[key])
                for nm in pa[key]:
                    assert isinstance(pb[key][nm], tuple)
                    np.testing.assert_allclose(pb[key][nm], pa[key][nm], rtol=1e-6)
            else:
                assert pa[key] == pb[key], (a.name, key)


def assert_outputs_match(jax_out, port_out, names=("t1",), exact=False):
    for n in names:
        got = port_out.images[n].data
        want = np.asarray(jax_out.images[n].data)
        assert got.numpy().dtype == want.dtype, n
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# --- _statistics -----------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "nan", "integers", "offset", "single"])
def test_quantiles_are_bit_equal_to_jax(case):
    rng = np.random.default_rng(["normal", "nan", "integers", "offset", "single"].index(case))
    x = (rng.normal(size=4000) * 30).astype(np.float32)
    if case == "nan":
        x[rng.random(x.size) < 0.4] = np.nan
    elif case == "integers":
        x = np.round(x)
    elif case == "offset":
        x = np.abs(x) + 1e6
    elif case == "single":
        x = x[:1]
    qs = [0.0, 0.005, 0.25, 0.5, 0.731, 0.995, 1.0]
    want = jax_statistics.compute_quantiles(x, qs)
    got = port_statistics.compute_quantiles(torch.as_tensor(x), qs)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert port_statistics.compute_quantile(torch.as_tensor(x), 0.731) == float(
        jax_statistics.compute_quantile(x, 0.731)
    )


def test_quantiles_of_nothing_are_nan():
    for x in (np.full(5, np.nan, np.float32), np.zeros(0, np.float32)):
        got = port_statistics.compute_quantiles(torch.as_tensor(x), [0.5])
        assert np.isnan(got).all() and np.isnan(jax_statistics.compute_quantiles(x, [0.5])).all()


# --- Flip ------------------------------------------------------------------

FLIPS = {
    "per-instance": lambda pkg: pkg.Flip(axes=(0, 1, 2), flip_probability=0.5),
    "shared": lambda pkg: pkg.Flip(axes=(0, 2), per_instance=False),
    "labels": lambda pkg: pkg.Flip(axes=("Left", "posterior", "S"), flip_probability=0.7),
    "gated": lambda pkg: pkg.Flip(axes=(1,), p=0.5),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(FLIPS))
def test_flip_matches_jax(name, fuse):
    jax_out, port_out = run_both(
        FLIPS[name], fuse=fuse, b=4 if name == "gated" else 2, labels=("seg",)
    )
    assert_params_match(jax_out, port_out)
    assert_outputs_match(jax_out, port_out, names=("t1", "seg"), exact=True)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_flip_gated_out_elements_are_bit_exact(fuse):
    _, batch = make_batches(b=4, shape=SHAPE, seed=3)
    transform = tt.Flip(axes=(0, 1), p=0.5)
    if fuse:
        transform = tt.Compose([transform], fuse=True)
    tt.seed(12)
    out = transform(batch)
    keep = out.applied_transforms[0].params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        assert torch.equal(out.t1.data[i], batch.t1.data[i]) != kept


def test_flip_resolves_labels_against_each_orientation():
    """'Left' is voxel axis 0 of a RAS image and axis 2 of an SPL one."""
    data = np.arange(2 * 3 * 4, dtype=np.float32).reshape(1, 2, 3, 4)
    spl = np.array([[0, 0, -1, 0], [0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]], float)
    for affine, dim in ((np.eye(4), 1), (spl, 3)):
        image = tt.ScalarImage(data, affine=affine)
        out = tt.Flip(axes="Left")(image)
        assert out.applied_transforms[0].params["axes"] == (dim - 1,)
        assert torch.equal(out.data, torch.flip(torch.as_tensor(data), (dim,)))


@pytest.mark.parametrize("per_instance", [True, False])
def test_flip_inverse_restores_the_input(per_instance):
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, seed=4)
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(5)
        flip = pkg.Flip(axes=(0, 1, 2), flip_probability=0.6, per_instance=per_instance)
        params = flip.make_params(batch)
        flipped = flip.apply_transform(batch, params)
        outs.append(flip.inverse(params)(flipped))
    assert type(tt.Flip().inverse(params)).__name__ == (
        "_FlipInverse" if per_instance else "Flip"
    )
    np.testing.assert_array_equal(outs[1].t1.data.numpy(), np.asarray(outs[0].t1.data))
    assert torch.equal(outs[1].t1.data, make_batches(b=2, shape=SHAPE, seed=4)[1].t1.data)


# --- Normalize / RescaleIntensity -------------------------------------------

RESCALES = {
    "minmax": lambda pkg: pkg.RescaleIntensity(out_min=0.0, out_max=1.0),
    "percentiles": lambda pkg: pkg.RescaleIntensity(
        out_min=-1.0, out_max=1.0, percentile_low=0.5, percentile_high=99.5
    ),
    "explicit": lambda pkg: pkg.Normalize(out_min=0.0, out_max=2.0, in_min=0.6, in_max=1.3),
    "random-out": lambda pkg: pkg.RescaleIntensity(out_min=(-1.0, 0.0), out_max=(1.0, 2.0)),
    "random-percentiles": lambda pkg: pkg.RescaleIntensity(
        out_min=0.0, out_max=1.0, percentile_low=(0.0, 5.0), percentile_high=(95.0, 100.0)
    ),
    "mask-key": lambda pkg: pkg.RescaleIntensity(
        out_min=0.0, out_max=1.0, percentile_low=1.0, percentile_high=99.0,
        masking_method="seg",
    ),
    "mask-key-minmax": lambda pkg: pkg.RescaleIntensity(masking_method="seg"),
    "mask-callable": lambda pkg: pkg.RescaleIntensity(
        percentile_low=2.0, percentile_high=98.0, masking_method=lambda x: x > 1.0
    ),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(RESCALES))
def test_rescale_matches_jax(name, fuse):
    jax_out, port_out = run_both(RESCALES[name], fuse=fuse, labels=("seg",))
    assert_params_match(jax_out, port_out)
    assert_outputs_match(jax_out, port_out)
    # labels are not intensities
    assert_outputs_match(jax_out, port_out, names=("seg",), exact=True)


@pytest.mark.parametrize("name", ["minmax", "percentiles", "explicit", "random-percentiles"])
def test_fused_rescale_stage_follows_the_jax_package(name):
    """Fused where the JAX package fuses: randomized percentiles and masks
    stay unfused (their program would change with the draw)."""
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, labels=("seg",))
    assert RESCALES[name](tt).fusable(port_batch) == RESCALES[name](tj).fusable(jax_batch)
    assert RESCALES[name](tt).fusable(port_batch) == (name != "random-percentiles")
    assert not RESCALES["mask-key"](tt).fusable(port_batch)


def test_deferred_range_resolves_once_after_the_output():
    """The input range stays a device pair until the history is read."""
    _, batch = make_batches(b=2, shape=SHAPE)
    tt.seed(1)
    out = tt.RescaleIntensity(out_min=0.0, out_max=1.0)(batch)
    record = out.applied_transforms[0]
    pair = record.raw_params()["in_ranges"]["t1"]
    assert isinstance(pair, tt.transforms.transform.DeferredParam)
    assert isinstance(pair.device, torch.Tensor) and pair.device.shape == (2,)
    low, high = record.params["in_ranges"]["t1"]
    first = batch.t1.data[0]
    assert (low, high) == (float(first.min()), float(first.max()))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_zero_input_range_warns_and_keeps_the_image(fuse):
    """A constant image: both packages warn and leave it as it is (an
    integer image keeps its dtype, in the port also when fused: the JAX
    package's fault ``normalize.py:92`` is not copied)."""
    for dtype in (np.float32, np.int16):
        data = np.full((1, 6, 7, 8), 3, dtype)
        transform = tt.RescaleIntensity(out_min=0.0, out_max=1.0)
        if fuse:
            transform = tt.Compose([transform], fuse=True)
        with pytest.warns(RuntimeWarning, match="input range is zero"):
            out = transform(tt.Subject(t1=tt.ScalarImage(data)))
            out.applied_transforms[0].params
        assert out.t1.data.dtype == torch.from_numpy(data).dtype
        assert torch.equal(out.t1.data, torch.from_numpy(data))


def test_empty_mask_warns_and_uses_the_full_range():
    _, batch = make_batches(b=1, shape=SHAPE, labels=("seg",))
    batch.seg.data = torch.zeros_like(batch.seg.data)
    with pytest.warns(RuntimeWarning, match="mask is empty"):
        out = tt.RescaleIntensity(masking_method="seg")(batch)
    low, high = out.applied_transforms[0].params["in_ranges"]["t1"]
    assert (low, high) == (float(batch.t1.data.min()), float(batch.t1.data.max()))


@pytest.mark.parametrize("name", ["minmax", "explicit", "random-out"])
def test_rescale_inverse_matches_jax(name):
    """``inverse(params)`` of the recorded params maps the output back in
    both packages the same way; the first element, whose range the
    statistics come from, is restored within float32 rounding."""
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, seed=6)
    original = port_batch.t1.data
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(8)
        out = RESCALES[name](pkg)(batch)
        params = out.applied_transforms[0].params
        outs.append(RESCALES[name](pkg).inverse(params)(out))
    assert type(RESCALES[name](tt).inverse(params)).__name__ == "_RescaleInverse"
    got = outs[1].t1.data
    np.testing.assert_allclose(got.numpy(), np.asarray(outs[0].t1.data), rtol=RTOL, atol=ATOL)
    if name != "explicit":  # an explicit range clips
        torch.testing.assert_close(got[0], original[0], rtol=1e-5, atol=1e-5)


def test_rescale_inverse_skips_a_zero_output_range():
    _, batch = make_batches(b=2, shape=SHAPE)
    data = batch.t1.data
    inverse = tt.transforms.intensity.normalize._RescaleInverse(
        out_min=[0.0, 1.0], out_max=[2.0, 1.0], in_min=0.5, in_max=1.5, in_ranges=None
    )
    out = inverse.apply_transform(batch, {}).t1.data
    assert torch.equal(out[1], data[1])
    assert torch.equal(out[0], (data[0] - 0.0) / 2.0 * 1.0 + 0.5)


# --- config 1 as a whole ------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config1_matches_jax(seed, fuse):
    jax_out, port_out = run_both(lambda pkg: config1(pkg, fuse), seed=seed)
    assert [h.name for h in port_out.applied_transforms] == ["Flip", "Noise", "Normalize"]
    assert_params_match(jax_out, port_out)
    assert_outputs_match(jax_out, port_out)
    got = port_out.t1.data
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_config1_fused_equals_unfused_in_the_port():
    _, batch = make_batches(b=2, shape=SHAPE, seed=9)
    outs = []
    for fuse in (False, True):
        tt.seed(4)
        outs.append(config1(tt, fuse)(batch))
    assert torch.equal(outs[0].t1.data, outs[1].t1.data)
    assert [h.params for h in outs[0].applied_transforms] == [
        h.params for h in outs[1].applied_transforms
    ]
