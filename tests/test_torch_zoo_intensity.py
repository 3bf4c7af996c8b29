"""Port parity: Clamp, Standardize (ZNormalization) and Mask against the JAX
package, unfused and fused.

The same numpy volumes (B=3 x 20x22x16 at 1 mm unless stated) go through
``torchio_tpu`` and ``torchio_tpu_torch`` on the CPU:

- Clamp (both bounds, one, integer and float bounds) and Mask (LabelMap
  key with and without ``labels``, a float and an integer
  ``outside_value``, a callable) are equal to the JAX package, data and
  dtype, on int16, uint16, uint32 and float32 images: the result dtype
  follows JAX's weak-typed ``jnp.clip``/``jnp.where`` (an integer image
  keeps its dtype under integer bounds and values, a float one makes it
  float32);
- Standardize's statistics (first element; ``ddof=1``; ``count - 1``
  under a mask) within 1e-5 relative, its output within 1e-5 absolute
  (the JAX package's own tests hold it to 1e-4 against TorchIO; 1e-5 is
  the bound of the port's other single steps; float32 sums in another
  order than XLA's), and its inverse within 1e-5 (relative and absolute);
- the fused chain equals the unfused one in the port, data and history;
- the empty-mask and zero-std errors (raised when the history is
  recorded), the masking errors, with the JAX package's messages;
- the brats-preprocess chain (``Clamp(out_min=0.0)``,
  ``ZNormalization(masking_method="seg")``, ``Mask(masking_method="seg",
  labels=[1, 2, 4])``, fused; the members of the fused chain of
  ``docs/concepts/performance.md:144-150``) at 2 x 4 x 20x22x16.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_config3 import make_batches

STAT_RTOL = 1e-5
STANDARDIZED_ATOL = 1e-5
SHAPE = (20, 22, 16)
ISO = (1.0, 1.0, 1.0)
DTYPES = (np.int16, np.uint16, np.uint32, np.float32)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def brats_seg(shape):
    """(1, *shape) int32 block labels in {0, 1, 2, 4}."""
    i, j, k = np.meshgrid(*(np.arange(n) // 5 for n in shape), indexing="ij")
    seg = ((i + j + k) % 4).astype(np.int32)
    seg[seg == 3] = 4
    return seg[None]


def pair(dtype=np.float32, b=3, channels=1, shape=SHAPE, seed=0, seg=None):
    """(jax batch, port batch) of a ScalarImage ``t1`` (integers in [0,
    100) or floats in [0, 1)) and an int32 LabelMap ``seg``."""
    jax_batch, port_batch = make_batches(
        b=b, shape=shape, spacing=ISO, channels=channels, name="t1", seed=seed, dtype=dtype
    )
    if seg is not None:
        for batch, conv in ((jax_batch, np.asarray), (port_batch, torch.as_tensor)):
            data = np.broadcast_to(seg, (b, *seg.shape)).copy()
            batch.seg.data = conv(data)
    return jax_batch, port_batch


def above(threshold):
    """A callable mask for both packages (the JAX package hands it host
    numpy, the port the first element's tensor). It compares in float64:
    torch has no comparison kernels for uint16 and uint32."""

    def mask(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64) > threshold
        return np.asarray(x, np.float64) > threshold

    return mask


def run(pkg, transform, batch, fuse):
    pkg.seed(0)
    return pkg.Compose([transform], fuse=fuse)(batch)


def history_json(out):
    return json.dumps([[h.name, h.params] for h in out.applied_transforms], sort_keys=True)


def assert_equal_to_jax(jax_out, port_out, name="t1"):
    want = np.asarray(jax_out.images[name].data)
    got = port_out.images[name].data.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def port_runs(transform_of, batch):
    """The port's unfused and fused outputs of ``transform_of(tt)``:
    equal data and equal history."""
    unfused = run(tt, transform_of(tt), batch, False)
    fused = run(tt, transform_of(tt), batch, True)
    for name in unfused.images:
        a, b = unfused.images[name].data, fused.images[name].data
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert history_json(unfused) == history_json(fused)
    return unfused


# --- Clamp -----------------------------------------------------------------------

CLAMPS = {
    "float-both": dict(out_min=10.0, out_max=60.0),
    "float-min": dict(out_min=20.0),
    "float-max": dict(out_max=40.0),
    "int-both": dict(out_min=10, out_max=60),
    "int-min": dict(out_min=5),
    "mixed": dict(out_min=3, out_max=70.5),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(CLAMPS))
def test_clamp_matches_jax(name, dtype):
    jax_batch, port_batch = pair(dtype)
    if dtype == np.float32:  # floats in [0, 1): scale the bounds
        kwargs = {k: v / 100 for k, v in CLAMPS[name].items()}
    else:
        kwargs = CLAMPS[name]
    want = run(tj, tj.Clamp(**kwargs), jax_batch, False)
    got = port_runs(lambda pkg: pkg.Clamp(**kwargs), port_batch)
    assert_equal_to_jax(want, got)
    assert_equal_to_jax(want, got, "seg")  # a LabelMap is left alone
    assert history_json(got) == history_json(want)


def test_clamp_without_bounds_warns_and_keeps_the_data():
    jax_batch, port_batch = pair(np.uint16)
    with pytest.warns(RuntimeWarning, match="Clamp with default arguments is a no-op"):
        clamp = tt.Clamp()
    out = run(tt, clamp, port_batch, True)
    assert out.t1.data.dtype == torch.uint16
    assert_equal_to_jax(run(tj, tj.Clamp(), jax_batch, False), out)
    with pytest.raises(ValueError, match=r"out_min \(2\) must be <= out_max \(1\)"):
        tt.Clamp(out_min=2, out_max=1)


# --- Mask ------------------------------------------------------------------------

MASKS = {
    "key": dict(masking_method="seg"),
    "labels": dict(masking_method="seg", labels=[1, 3]),
    "int-outside": dict(masking_method="seg", labels=[2], outside_value=7),
    "float-outside": dict(masking_method="seg", outside_value=-1.5),
    "callable": dict(masking_method=above(30)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(MASKS))
def test_mask_matches_jax(name, dtype):
    jax_batch, port_batch = pair(dtype)
    kwargs = dict(MASKS[name])
    if name == "callable" and dtype == np.float32:
        kwargs["masking_method"] = above(0.3)
    want = run(tj, tj.Mask(**kwargs), jax_batch, False)
    got = port_runs(lambda pkg: pkg.Mask(**kwargs), port_batch)
    assert_equal_to_jax(want, got)
    assert_equal_to_jax(want, got, "seg")
    assert history_json(got) == history_json(want)


@pytest.mark.parametrize(
    "kwargs, error",
    [
        (dict(masking_method="brain"), KeyError),
        (dict(masking_method="t1"), TypeError),
        (dict(masking_method=None), TypeError),
    ],
    ids=["missing-key", "not-a-label-map", "none"],
)
def test_mask_errors_equal_jax(kwargs, error):
    messages = []
    for pkg, batch in zip((tj, tt), pair()):
        with pytest.raises(error) as caught:
            run(pkg, pkg.Mask(**kwargs), batch, True)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]


# --- Standardize -------------------------------------------------------------------

STANDARDIZES = {
    "plain": dict(),
    "key": dict(masking_method="seg"),
    "callable": dict(masking_method=above(0.4)),
}


def assert_standardized_close(jax_out, port_out):
    want = np.asarray(jax_out.t1.data)
    got = port_out.t1.data.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=STANDARDIZED_ATOL)
    (jax_record,), (port_record,) = jax_out.applied_transforms, port_out.applied_transforms
    assert port_record.name == jax_record.name == "Standardize"
    stats_j, stats_p = jax_record.params["stats"], port_record.params["stats"]
    assert list(stats_p) == list(stats_j)
    for name in stats_j:
        np.testing.assert_allclose(stats_p[name], stats_j[name], rtol=STAT_RTOL, atol=0)


@pytest.mark.parametrize("alias", ["Standardize", "ZNormalization"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", list(STANDARDIZES))
def test_standardize_matches_jax(name, dtype, alias):
    jax_batch, port_batch = pair(dtype, channels=2)
    kwargs = dict(STANDARDIZES[name])
    if name == "callable" and dtype != np.float32:
        kwargs["masking_method"] = above(40)
    want = run(tj, getattr(tj, alias)(**kwargs), jax_batch, False)
    got = port_runs(lambda pkg: getattr(pkg, alias)(**kwargs), port_batch)
    assert_standardized_close(want, got)
    assert_equal_to_jax(want, got, "seg")
    back = got.apply_inverse_transform()
    np.testing.assert_allclose(
        back.t1.data.numpy(), port_batch.t1.data.numpy().astype(np.float32),
        rtol=STAT_RTOL, atol=STANDARDIZED_ATOL,
    )
    jax_back = want.apply_inverse_transform()
    np.testing.assert_allclose(
        back.t1.data.numpy(), np.asarray(jax_back.t1.data), rtol=STAT_RTOL, atol=STAT_RTOL
    )


def test_standardize_uses_the_first_element_and_ddof_one():
    _, port_batch = pair(b=2)
    first = port_batch.t1.data[0].double()
    out = run(tt, tt.Standardize(), port_batch, False)
    mean, std = out.applied_transforms[0].params["stats"]["t1"]
    np.testing.assert_allclose(mean, float(first.mean()), rtol=STAT_RTOL)
    np.testing.assert_allclose(std, float(first.std(correction=1)), rtol=STAT_RTOL)
    masked = run(tt, tt.Standardize(masking_method="seg"), pair(b=2)[1], False)
    voxels = first[port_batch.seg.data[0].expand_as(first) != 0]
    mean, std = masked.applied_transforms[0].params["stats"]["t1"]
    np.testing.assert_allclose(mean, float(voxels.mean()), rtol=STAT_RTOL)
    np.testing.assert_allclose(std, float(voxels.std(correction=1)), rtol=STAT_RTOL)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("case", ["empty-mask", "zero-std", "zero-std-masked"])
def test_standardize_errors_at_resolution_equal_jax(case, fuse):
    messages = []
    for pkg, batch in zip((tj, tt), pair(b=2)):
        kwargs = {}
        if case == "empty-mask":
            batch.seg.data = batch.seg.data * 0
            kwargs["masking_method"] = "seg"
        else:
            batch.t1.data = batch.t1.data * 0 + 3
            if case == "zero-std-masked":
                kwargs["masking_method"] = "seg"
        with pytest.raises(RuntimeError) as caught:
            run(pkg, pkg.Standardize(**kwargs), batch, fuse)
        messages.append(str(caught.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("kind", ["label-key", "scalar-key", "callable"])
def test_standardize_fuses_only_label_map_keys(kind):
    _, port_batch = pair()
    method = {"label-key": "seg", "scalar-key": "t1", "callable": lambda x: x > 0.5}[kind]
    assert tt.Standardize(masking_method=method).fusable(port_batch) == (kind == "label-key")


# --- the brats-preprocess chain --------------------------------------------------------


def brats_preprocess(pkg, fuse=True):
    return pkg.Compose(
        [
            pkg.Clamp(out_min=0.0),
            pkg.ZNormalization(masking_method="seg"),
            pkg.Mask(masking_method="seg", labels=[1, 2, 4]),
        ],
        fuse=fuse,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_brats_preprocess_chain_matches_jax(seed):
    jax_batch, port_batch = pair(b=2, channels=4, seed=seed, seg=brats_seg(SHAPE))
    for batch in (jax_batch, port_batch):  # MRI-like: some negative values to clamp
        batch.t1.data = batch.t1.data * 2 - 0.25
    tj.seed(0)
    want = brats_preprocess(tj)(jax_batch)
    outs = []
    for fuse in (False, True):
        tt.seed(0)
        outs.append(brats_preprocess(tt, fuse)(port_batch))
    unfused, fused = outs
    assert torch.equal(unfused.t1.data, fused.t1.data)
    assert history_json(unfused) == history_json(fused)
    got = fused.t1.data.numpy()
    np.testing.assert_allclose(got, np.asarray(want.t1.data), rtol=0, atol=STANDARDIZED_ATOL)
    assert [h.name for h in fused.applied_transforms] == ["Clamp", "Standardize", "Mask"]
    outside = np.broadcast_to(port_batch.seg.data.numpy() == 0, got.shape)
    assert (got[outside] == 0).all() and (got[~outside] != 0).any()
    stats_j = want.applied_transforms[1].params["stats"]["t1"]
    stats_p = fused.applied_transforms[1].params["stats"]["t1"]
    np.testing.assert_allclose(stats_p, stats_j, rtol=STAT_RTOL, atol=0)
