"""Port parity: the threefry draws of ``torchio_tpu_torch.random`` against
``jax.random``.

Keys, splits, bits and uniforms are equal bit for bit. Normals agree
within 1e-6 abs: both evaluate Giles' ``erf_inv`` polynomial, and
``log1p`` rounds differently in XLA and in PyTorch. Noise and BiasField
then match the JAX package with the port's own draws, at
``test_torch_intensity.py``'s tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu_torch as tt
from test_torch_intensity import RTOL, ATOL, make_batches, run_both
from torchio_tpu_torch import random as tr

NORMAL_ATOL = 1e-6
SEEDS = [0, 7, 2**31 - 2, 2**31 + 5, 2**32 + 3, -5]
#: 4 x 64^3: over 2^16 elements, a counter's low word past 2^20
BIG = (4, 64, 64, 64)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def jax_key_words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def jax_draw_key(seed: int, index: int):
    """The JAX package's key of draw ``index`` of ``seed``, spelled as its
    BiasField (index 0) and Noise (``key, k1, k2 = split(key, 3)`` per
    image) spell it."""
    key = jax.random.PRNGKey(seed)
    if index > 0:
        for _ in range((index - 1) // 2 + 1):
            key, k1, k2 = jax.random.split(key, 3)
        key = k1 if index % 2 == 1 else k2
    return key


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert tr.prng_key(seed) == jax_key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_split_matches_jax(seed, num):
    want = [jax_key_words(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert tr.split(tr.prng_key(seed), num) == want


@pytest.mark.parametrize(
    "seed,shape",
    [(42, BIG), (2**31 + 5, (3, 5, 7)), (0, (1,)), (9, (2, 0, 3))],
    ids=["4x64^3", "seed-past-2^31", "one", "empty"],
)
def test_random_bits_match_jax(seed, shape):
    got = tr.random_bits(tr.prng_key(seed), shape)
    assert got.dtype == torch.uint32 and tuple(got.shape) == shape
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_from_a_split_key_match_jax():
    jax_key = jax.random.split(jax.random.PRNGKey(11), 3)[2]
    key = tr.split(tr.prng_key(11), 3)[2]
    want = np.asarray(jax.random.bits(jax_key, (70001,)))
    np.testing.assert_array_equal(tr.random_bits(key, (70001,)).numpy(), want)


def test_counter_high_word_is_carried():
    """Elements past 2^32 take the counter pair (1, e - 2^32): the block
    of the pair, not of the low word alone."""
    key = tr.prng_key(3)
    past = tr.bits_plain(key, 2**32 + 10, 4, "cpu")
    x0, x1 = tr.threefry2x32(
        key, torch.ones(4, dtype=torch.int64), torch.arange(10, 14, dtype=torch.int64)
    )
    assert torch.equal(past, x0 ^ x1)
    assert not torch.equal(past, tr.bits_plain(key, 10, 4, "cpu"))


def jax_uniform(lo, hi):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(5), BIG, jnp.float32, lo, hi))


@pytest.mark.parametrize(
    "lo,hi", [(tr.NORMAL_LO, 1.0), (0.0, 1.0), (-3.0, 1.0)], ids=["normal", "unit", "width-4"]
)
def test_uniform_is_bit_equal_to_jax(lo, hi):
    """Ranges whose width rounds to a power of two: the product is exact."""
    got = tr.key_uniform(tr.prng_key(5), BIG, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jax_uniform(lo, hi))


def test_uniform_on_other_ranges_rounds_the_product_once_more():
    """XLA's CPU backend fuses the multiply and add into an FMA; the port
    rounds the product first, as the kernel does: the two differ by at
    most half an ulp of the product and half an ulp of the sum, one ulp
    of the width 5.75."""
    got = tr.key_uniform(tr.prng_key(5), BIG, -3.5, 2.25).numpy()
    want = jax_uniform(-3.5, 2.25)
    ulp = float(np.spacing(np.float32(5.75)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
    assert (got == want).mean() > 0.4


@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_normal_matches_jax(seed):
    got = tr.normal(tr.prng_key(seed), BIG).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), BIG, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    # Giles' polynomial, not torch.special.erfinv (which misses by up to 2e-5)
    assert (got == want).mean() > 0.9


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999], dtype=torch.float32)
    got = tr.erf_inv(x)
    assert got[0] == -torch.inf and got[1] == torch.inf and got[2] == 0.0
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy()[2:], want[2:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("index", [0, 1, 2, 3, 4])
def test_device_normal_is_the_jax_packages_draw(index):
    """Draw ``index`` of a seed is the JAX package's: ``PRNGKey(seed)``
    for BiasField, ``k1``/``k2`` of the ``(n + 1)``-th split for Noise's
    image ``n``."""
    shape = (2, 1, 9, 10, 11)
    got = tr.device_normal(1234, shape, "cpu", index)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert tr.draw_key(1234, index) == jax_key_words(jax_draw_key(1234, index))
    want = np.asarray(jax.random.normal(jax_draw_key(1234, index), shape, jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_ATOL)


def test_draws_refuse_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        tr.normal((0, 1), (3,), "meta")


@pytest.mark.parametrize(
    "make",
    [
        lambda pkg: pkg.BiasField(std=(0.2, 0.8)),
        lambda pkg: pkg.BiasField(std=0.5, per_instance=False),
        lambda pkg: pkg.Noise(std=(0.05, 0.2)),
        lambda pkg: pkg.Noise(std=0.1, rician=True),
    ],
    ids=["bias-per-element", "bias-shared", "noise", "noise-rician"],
)
def test_noise_and_bias_match_jax_with_the_ports_own_draws(make):
    """With its own device draws, the port's Noise and BiasField give the
    JAX package's output on two images (Noise's second image takes the
    key after the first's split)."""
    jax_batch, port_batch = make_batches(b=2, names=("t1", "t2"))
    jax_out, port_out = run_both(make, jax_batch, port_batch, seed=21)
    for name in ("t1", "t2"):
        np.testing.assert_allclose(
            port_out.images[name].data.numpy(),
            np.asarray(jax_out.images[name].data),
            rtol=RTOL, atol=ATOL,
        )
    assert jax_out.applied_transforms[0].params == port_out.applied_transforms[0].params


def test_cuda_wrappers_need_a_cuda_device():
    from torchio_tpu_torch.ops import threefry_kernel

    with pytest.raises(ValueError, match="CUDA device"):
        threefry_kernel.threefry_normal_cuda((0, 1), (4,), "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        threefry_kernel.threefry_bits_cuda((0, 1), (4,), "cpu")


def test_the_kernel_library_is_registered():
    from torchio_tpu_torch.ops import kernel_lib, threefry_kernel

    assert threefry_kernel.THREEFRY in kernel_lib.LIBRARIES
    assert threefry_kernel.THREEFRY.source.exists()
    assert {"threefry_normal", "threefry_bits"} <= set(kernel_lib.LAUNCHES)
    assert "-fmad=false" in kernel_lib.FLAGS
