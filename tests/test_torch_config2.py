"""Port parity: config 2 (Blur + BiasField + Gamma) against the JAX package.

BASELINE.json config 2 (``benchmarks/suite.py:145-166``) is
``Compose([Blur(std=(0.5, 1.5)), BiasField(std=0.5), Gamma(log_gamma=
(-0.3, 0.3))])``, unfused. Each new module (the separable Gaussian of
``ops/gaussian.py``, Blur, Gamma and its inverse) and the pipeline as a
whole run in both packages from the same seed on the same numpy volumes
(B=2, about 20^3), fused and unfused:

- blurs within rtol/atol 1e-6 (``tests/test_fuse.py:44``: the band
  products sum in another order in torch than in XLA);
- Gamma within rtol/atol 1e-6; the pipeline within BiasField's rtol 1e-5,
  atol 1e-6 (``tests/test_torch_intensity.py``: ``exp`` rounds
  differently);
- params equal, and the next host draw after the call the same;
- elements gated out by a per-instance ``p``, or drawn with no blur,
  stay bit-exact;
- Gamma's inverse, built with ``inverse(params)``, undoes it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_intensity import make_batches
from torchio_tpu.ops import gaussian as jax_gaussian
from torchio_tpu_torch.ops import gaussian as port_gaussian

RTOL, ATOL = 1e-6, 1e-6
BIAS_RTOL = 1e-5
SHAPE = (1, 18, 20, 22)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def config2(pkg, fuse=False):
    return pkg.Compose(
        [
            pkg.Blur(std=(0.5, 1.5)),
            pkg.BiasField(std=0.5),
            pkg.Gamma(log_gamma=(-0.3, 0.3)),
        ],
        fuse=fuse,
    )


def batches(b=2, seed=0, spacing=None, signed=False):
    """The same numpy volumes in both packages; ``spacing`` gives each
    image an anisotropic affine; ``signed`` shifts values to [-0.5, 1.5)."""
    jax_batch, port_batch = make_batches(b=b, shape=SHAPE, seed=seed)
    for batch in (jax_batch, port_batch):
        if signed:
            batch.t1.data = batch.t1.data - 1.0
        if spacing is not None:
            from torchio_tpu.core.affine import AffineMatrix as JaxAffine
            from torchio_tpu_torch.core.affine import AffineMatrix as PortAffine

            cls = PortAffine if batch is port_batch else JaxAffine
            batch.t1.affines = [
                cls(np.diag([*s, 1.0])) for s in spacing[: batch.batch_size]
            ]
    return jax_batch, port_batch


def run_both(make, seed=7, fuse=False, **batch_kwargs):
    jax_batch, port_batch = batches(**batch_kwargs)
    outs, draws = [], []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        transform = make(pkg)
        if fuse:
            transform = pkg.Compose([transform], fuse=True)
        pkg.seed(seed)
        outs.append(transform(batch))
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1]
    jax_out, port_out = outs
    assert [(h.name, h.params) for h in jax_out.applied_transforms] == [
        (h.name, h.params) for h in port_out.applied_transforms
    ]
    return jax_out, port_out


def assert_close(jax_out, port_out, rtol=RTOL, atol=ATOL):
    got = port_out.t1.data.numpy()
    want = np.asarray(jax_out.t1.data)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --- ops/gaussian -------------------------------------------------------------


@pytest.mark.parametrize("sigma,radius", [(0.5, 2), (1.5, 5), (2.3, 9), (1e-12, 1)])
def test_kernel_and_radius_equal_the_jax_packages(sigma, radius):
    np.testing.assert_array_equal(
        port_gaussian.gaussian_kernel_1d(sigma, radius),
        jax_gaussian.gaussian_kernel_1d(sigma, radius),
    )
    assert port_gaussian.radius_for_sigma(sigma) == jax_gaussian.radius_for_sigma(sigma)
    np.testing.assert_array_equal(
        port_gaussian._band_matrix(port_gaussian.gaussian_kernel_1d(sigma, radius), 13),
        jax_gaussian._band_matrix(jax_gaussian.gaussian_kernel_1d(sigma, radius), 13),
    )


@pytest.mark.parametrize(
    "sigmas,radii",
    [((0.8, 1.2, 2.0), None), ((1.0, 0.0, 0.6), (4, 0, 5)), ((0.0, 0.0, 0.0), None)],
    ids=["own-radii", "widened-one-axis-off", "all-off"],
)
def test_gaussian_blur_matches_jax(sigmas, radii):
    x = np.random.default_rng(1).random((2, 2, *SHAPE[1:]), np.float32)
    want = np.asarray(jax_gaussian.gaussian_blur(x, sigmas, radii=radii))
    got = port_gaussian.gaussian_blur(torch.as_tensor(x), sigmas, radii=radii)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    unbatched = port_gaussian.gaussian_blur(torch.as_tensor(x[0]), sigmas, radii=radii)
    torch.testing.assert_close(unbatched, got[0], rtol=0, atol=0)


@pytest.mark.parametrize(
    "sigmas,radii",
    [
        ([[0.5, 1.0, 1.5], [1.4, 0.3, 0.0]], None),
        ([[0.5, 1.0, 1.5], [0.0, 0.0, 0.0]], (6, 6, 6)),
        ([[2.0, 0.0, 0.7], [0.9, 0.0, 1.1]], (7, 0, 4)),
    ],
    ids=["drawn", "widened-identity-row", "axis-off"],
)
def test_gaussian_blur_per_element_matches_jax(sigmas, radii):
    x = np.random.default_rng(2).random((2, 1, *SHAPE[1:]), np.float32)
    want = np.asarray(jax_gaussian.gaussian_blur_per_element(x, np.asarray(sigmas), radii=radii))
    got = port_gaussian.gaussian_blur_per_element(torch.as_tensor(x), np.asarray(sigmas), radii=radii)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_widened_radii_give_the_same_blur():
    """Taps beyond each sigma's own radius are zero: a wider support (a
    range's upper bound) changes nothing but the summation."""
    x = torch.as_tensor(np.random.default_rng(3).random((2, 1, *SHAPE[1:]), np.float32))
    sig = np.asarray([[0.6, 1.1, 0.4], [1.3, 0.2, 0.9]])
    own = port_gaussian.gaussian_blur_per_element(x, sig)
    wide = port_gaussian.gaussian_blur_per_element(x, sig, radii=(8, 8, 8))
    torch.testing.assert_close(wide, own, rtol=1e-6, atol=1e-6)
    shared = port_gaussian.gaussian_blur(x, sig[0], radii=(8, 8, 8))
    torch.testing.assert_close(shared[0], own[0], rtol=1e-6, atol=1e-6)


def test_blur_keeps_an_integer_dtype_as_the_jax_package_does():
    """Sums in float32, cast back (truncated) to the input's dtype."""
    x = np.random.default_rng(4).integers(0, 50, (1, 1, 9, 10, 11)).astype(np.int32)
    want = np.asarray(jax_gaussian.gaussian_blur(x, (1.0, 0.5, 1.5)))
    got = port_gaussian.gaussian_blur(torch.as_tensor(x), (1.0, 0.5, 1.5))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert (got.numpy() == want).mean() > 0.99


# --- Blur --------------------------------------------------------------------

BLURS = {
    "per-instance": lambda pkg: pkg.Blur(std=(0.5, 1.5)),
    "shared": lambda pkg: pkg.Blur(std=(0.3, 1.2), per_instance=False),
    "gated": lambda pkg: pkg.Blur(std=0.8, p=0.5),
    "anisotropic": lambda pkg: pkg.Blur(std=(0.5, 1.0, 0.5, 1.0, 1.0, 2.0)),
    "axis-off": lambda pkg: pkg.Blur(std=(0.0, 0.0, 0.5, 1.5, 0.7, 0.9)),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(BLURS))
def test_blur_matches_jax(name, fuse):
    kwargs = {"b": 4 if name == "gated" else 2}
    if name == "anisotropic":
        kwargs["spacing"] = [(1.0, 1.0, 2.0), (0.8, 1.2, 1.5)]
    jax_out, port_out = run_both(BLURS[name], fuse=fuse, seed=13, **kwargs)
    assert_close(jax_out, port_out)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_blur_gated_out_elements_are_bit_exact(fuse):
    _, batch = batches(b=4, seed=3)
    transform = tt.Blur(std=0.8, p=0.5)
    if fuse:
        transform = tt.Compose([transform], fuse=True)
    tt.seed(13)
    out = transform(batch)
    keep = out.applied_transforms[0].params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        assert torch.equal(out.t1.data[i], batch.t1.data[i]) != kept


def test_blur_fuses_only_per_instance():
    jax_batch, port_batch = batches()
    for make in (BLURS["per-instance"], BLURS["shared"]):
        assert make(tt).fusable(port_batch) == make(tj).fusable(jax_batch)
    assert BLURS["per-instance"](tt).fusable(port_batch)
    assert not BLURS["shared"](tt).fusable(port_batch)


def test_blur_radius_bound_equals_the_jax_packages():
    jax_batch, port_batch = batches(spacing=[(1.0, 1.0, 2.0), (0.8, 1.2, 1.5)])
    for make in BLURS.values():
        assert make(tt)._radius_bound(port_batch.t1) == make(tj)._radius_bound(jax_batch.t1)


# --- Gamma -------------------------------------------------------------------

GAMMAS = {
    "per-instance": lambda pkg: pkg.Gamma(log_gamma=(-0.3, 0.3)),
    "shared": lambda pkg: pkg.Gamma(log_gamma=(-0.3, 0.3), per_instance=False),
    "gated": lambda pkg: pkg.Gamma(log_gamma=0.25, p=0.5),
}


@pytest.mark.parametrize("signed", [False, True], ids=["positive", "signed"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(GAMMAS))
def test_gamma_matches_jax(name, fuse, signed):
    jax_out, port_out = run_both(
        GAMMAS[name], fuse=fuse, b=4 if name == "gated" else 2, signed=signed
    )
    assert_close(jax_out, port_out)
    if signed:
        got, was = port_out.t1.data, batches(b=4 if name == "gated" else 2, signed=True)[1]
        assert torch.equal(torch.sign(got), torch.sign(was.t1.data))


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_gamma_gated_out_elements_are_bit_exact(fuse):
    _, batch = batches(b=4, seed=5)
    transform = tt.Gamma(log_gamma=0.25, p=0.5)
    if fuse:
        transform = tt.Compose([transform], fuse=True)
    tt.seed(7)
    out = transform(batch)
    keep = out.applied_transforms[0].params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        assert torch.equal(out.t1.data[i], batch.t1.data[i]) != kept


@pytest.mark.parametrize("name", ["per-instance", "shared"])
def test_gamma_inverse_matches_jax(name):
    jax_batch, port_batch = batches(seed=6)
    original = port_batch.t1.data
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(8)
        out = GAMMAS[name](pkg)(batch)
        inverse = GAMMAS[name](pkg).inverse(out.applied_transforms[0].params)
        outs.append(inverse(out))
    assert type(inverse).__name__ == "_GammaInverse"
    got = outs[1].t1.data
    np.testing.assert_allclose(got.numpy(), np.asarray(outs[0].t1.data), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got, original, rtol=1e-5, atol=1e-6)


def test_gamma_warns_when_it_is_a_noop():
    with pytest.warns(RuntimeWarning, match="no-op"):
        tt.Gamma()


# --- config 2 as a whole --------------------------------------------------------


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config2_matches_jax(seed, fuse):
    jax_out, port_out = run_both(lambda pkg: config2(pkg, fuse), seed=seed)
    assert [h.name for h in port_out.applied_transforms] == ["Blur", "BiasField", "Gamma"]
    assert_close(jax_out, port_out, rtol=BIAS_RTOL)
    assert bool(torch.isfinite(port_out.t1.data).all())


def test_config2_fused_equals_unfused_in_the_port():
    _, batch = batches(seed=9)
    outs = []
    for fuse in (False, True):
        tt.seed(4)
        outs.append(config2(tt, fuse)(batch))
    assert torch.equal(outs[0].t1.data, outs[1].t1.data)
    assert [h.params for h in outs[0].applied_transforms] == [
        h.params for h in outs[1].applied_transforms
    ]
