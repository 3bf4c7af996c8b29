"""Port parity: integer images through Blur, Motion, Ghosting and Spike, and
through this part of the zoo (Swap, Anisotropy, Resize, Reorient,
RemapLabels, and Flip, which moves data as Reorient does), against the
JAX package.

Each runs on int16, uint16 and uint32 images in both packages on the CPU
from one seed (B=2 x 12x14x10 blocks of values near each type's range
and noise, so that the k-space artifacts ring below 0 and above the
maximum). The JAX package computes in float32 and converts back with
XLA's saturating cast (below the range to its minimum, above to its
maximum, NaN to 0); the port's ``core.dtypes.cast_like_jax`` does the
same, where torch's own cast wraps. Pinned: the dtype; the voxels whose
float32 value lies outside the range, at the range's end; and the
others within 1 + 1e-5 of the image's largest magnitude (the float32
values agree within 1e-5 of it, not bit for bit: an FFT's rounding is
relative to the whole image, and a float32 near 2^32 has an ulp of 512).
Swap, Reorient, RemapLabels and Flip are equal.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu_torch as tt
from test_torch_zoo_spatial import both, oblique
from torchio_tpu_torch.core.dtypes import cast_like_jax

DTYPES = (np.int16, np.uint16, np.uint32)
TRUNCATION_RTOL = 1e-5
SHAPE = (12, 14, 10)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def edges(dtype, b=2, shape=SHAPE, seed=0):
    """(B, 1, *shape) blocks at the bottom and near the top of ``dtype``'s
    range, plus noise: the k-space artifacts overshoot both ends."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    top = float(info.max) * 0.97
    bottom = float(max(info.min, -top))
    blocks = ((np.indices(shape) // 3).sum(axis=0) % 2).astype(np.float64)
    data = bottom + (top - bottom) * blocks + rng.random((b, 1, *shape)) * 0.01 * top
    return np.clip(data, info.min, info.max).astype(dtype)


def test_cast_like_jax():
    values = np.array(
        [np.nan, np.inf, -np.inf, -1.5, -0.5, 0.7, 255.9, 32767.5, 65535.9, 70000.3,
         2147483647.0, 4294967295.0, 5e9, -2147483649.0, -3.7e4],
        np.float32,
    )
    for dtype in (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32):
        want = np.asarray(jnp.asarray(values).astype(dtype))
        got = cast_like_jax(torch.as_tensor(values), getattr(torch, np.dtype(dtype).name))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want, err_msg=np.dtype(dtype).name)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32])
@pytest.mark.parametrize("source", [np.float16, np.float32])  # JAX has no float64 here
def test_cast_like_jax_in_range(dtype, source):
    """Values inside the type's range (torch's own cast after one
    ``aminmax``): equal to XLA's conversion, truncating toward zero."""
    info = np.iinfo(dtype)
    top = min(float(info.max), float(np.finfo(source).max))
    bottom = max(float(info.min), -top)
    edges = np.array([bottom, top, 0.0, -0.9, 0.9], np.float64).astype(source)
    values = np.random.default_rng(0).uniform(bottom, top, 200).astype(source)
    values = np.concatenate([values, edges[(edges >= info.min) & (edges <= info.max)]])
    want = np.asarray(jnp.asarray(values).astype(dtype))
    got = cast_like_jax(torch.as_tensor(values), getattr(torch, np.dtype(dtype).name))
    np.testing.assert_array_equal(got.numpy(), want)


def float_reference(make, images, seed, name):
    """The JAX package's float32 result: the same transform, params and
    draws on the float32 image (it computes in float32 before casting)."""
    floats = {k: (kind, a.astype(np.float32) if k == name else a) for k, (kind, a) in images.items()}
    out, _ = both(make, floats, seed=seed)
    return np.asarray(out.images[name].data)


def assert_integer_close(got, want, reference):
    """Equal dtype; the voxels whose float32 reference lies beyond the
    range (by more than the band) at the range's ends in both; the others
    within 1 + the band, TRUNCATION_RTOL of the largest magnitude."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    info = np.iinfo(got.dtype)
    band = TRUNCATION_RTOL * max(1.0, float(np.abs(reference).max()))
    for beyond, end in ((reference < info.min - band, info.min), (reference > info.max + band, info.max)):
        assert np.all(got[beyond] == end) and np.all(want[beyond] == end)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= 1 + band


ARTIFACTS = {
    "Blur": lambda pkg: pkg.Blur(std=(0.5, 1.5)),
    "Motion": lambda pkg: pkg.Motion(degrees=10, translation=5, num_transforms=2),
    "Ghosting": lambda pkg: pkg.Ghosting(intensity=(0.5, 1)),
    "Spike": lambda pkg: pkg.Spike(intensity=(1, 3)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_integer_artifacts(name, dtype):
    images = {"t1": ("scalar", edges(dtype))}
    make = ARTIFACTS[name]
    jax_out, port_out = both(make, images, seed=2)
    reference = float_reference(make, images, 2, "t1")
    info = np.iinfo(dtype)
    if name != "Blur":  # the k-space artifacts leave the type's range
        assert reference.min() < info.min - 1 or reference.max() > info.max + 1
    assert_integer_close(port_out.t1.data, jax_out.t1.data, reference)


ZOO = {
    "Swap": (lambda pkg: pkg.Swap(patch_size=4, num_iterations=5), "t1"),
    "Anisotropy": (lambda pkg: pkg.Anisotropy(downsampling=(2, 4)), "t1"),
    "Resize": (lambda pkg: pkg.Resize((9, 17, 8)), "t1"),
    "Reorient": (lambda pkg: pkg.Reorient("RAS"), "t1"),
    "RemapLabels": (lambda pkg: pkg.RemapLabels({3: 9, 0: 2}), "seg"),
    # Reorient's flip: torch has no flip kernel for uint16 and uint32
    "Flip": (lambda pkg: pkg.Flip(axes=(0, 2), flip_probability=0.7), "t1"),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(ZOO))
def test_integer_zoo(name, dtype):
    make, key = ZOO[name]
    labels = ((np.indices(SHAPE) // 4).sum(axis=0) % 4)[None, None].repeat(2, axis=0)
    images = {
        "t1": ("scalar", edges(dtype)),
        "seg": ("label", labels.astype(dtype)),
    }
    affine = oblique(codes="LPS", perm=(2, 0, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Swap warns of the label map
        jax_out, port_out = both(make, images, seed=1, affine=affine)
    want = np.asarray(jax_out.images[key].data)
    got = port_out.images[key].data
    assert got.numpy().dtype == want.dtype == np.dtype(dtype)
    if name in ("Anisotropy", "Resize"):  # linear: float32 then a cast
        floats = {k: (kind, a.astype(np.float32)) for k, (kind, a) in images.items()}
        jax_float, _ = both(make, floats, seed=1, affine=affine)
        assert_integer_close(got, want, np.asarray(jax_float.images[key].data))
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    for name_, image in jax_out.images.items():
        assert np.asarray(image.data).dtype == port_out.images[name_].data.numpy().dtype


def step_edge(dtype, b=2, shape=SHAPE):
    """(B, 1, *shape) blocks at the two ends of ``dtype``'s range: a
    B-spline overshoots and undershoots at every edge between them."""
    info = np.iinfo(dtype)
    blocks = ((np.indices(shape) // 3).sum(axis=0) % 2).astype(bool)
    data = np.where(blocks, info.max, info.min).astype(dtype)
    return np.repeat(data[None, None], b, axis=0)


def near_top(dtype, b=2, shape=SHAPE, seed=0):
    """(B, 1, *shape) values within 10 % of the range's top, and of its
    bottom for a signed type: a bias field above 1.1 leaves the range."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    magnitude = float(info.max) * (0.9 + 0.1 * rng.random((b, 1, *shape)))
    if info.min < 0:
        blocks = ((np.indices(shape) // 4).sum(axis=0) % 2).astype(bool)
        magnitude = np.where(blocks, -magnitude, magnitude)
    return np.clip(magnitude, info.min, info.max).astype(dtype)


SATURATING = {
    "BiasField": (lambda pkg: pkg.BiasField(std=1.0, scale=0.5), near_top),
    "Spatial": (
        lambda pkg: pkg.Spatial(scales=(0.9, 1.1), degrees=10, image_interpolation="cubic"),
        step_edge,
    ),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(SATURATING))
def test_integer_cast_back_saturates(name, dtype):
    """BiasField and Spatial convert their float32 result back to the
    image's integer type as XLA does: beyond the range to its ends."""
    make, volume = SATURATING[name]
    images = {"t1": ("scalar", volume(dtype))}
    jax_out, port_out = both(make, images, seed=4)
    reference = float_reference(make, images, 4, "t1")
    info = np.iinfo(dtype)
    assert reference.max() > info.max + 1  # the result leaves the range
    if info.min < 0 or name == "Spatial":
        assert reference.min() < info.min - 1
    assert_integer_close(port_out.t1.data, jax_out.t1.data, reference)
