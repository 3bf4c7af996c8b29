"""Port parity: PatchAggregator, and the config 5 slice end to end.

The same GridSampler patches (numpy-seeded volumes, the JAX package's
device branch) go into both packages' aggregators on the CPU:

- crop mode and the counts of the average and hann modes are EQUAL (the
  port adds the patches in the JAX scan's order);
- the average and hann values agree at rtol 1e-6: XLA's CPU backend
  contracts ``region + patch * window`` into an FMA, where torch rounds
  the product first (an ulp a patch);
- dict outputs, ``output_shape`` scaling, the automatic flush at a small
  ``flush_bytes``, ``dtype=float16``, ``device=True`` without aliasing
  the crop buffer, and identity reconstruction within the JAX package's
  own tolerances (``tests/test_patch_pipeline.py``'s TestAggregator);
- the slice as a whole: a Queue behind Motion + Ghosting through
  ``device_batches`` and an identity "model", then a GridSampler and a
  hann PatchAggregator over each transformed subject, equal to the JAX
  package's run on the same seeds.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu.config as jax_config
import torchio_tpu_torch as tt
from test_torch_queue import KSPACE_ATOL, assert_batch_equal, config5, subjects

VALUE_RTOL = 1e-6
SHAPE = (17, 20, 22)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build images from numpy and compare on the CPU: ask the
    port to put host data there (its default is the card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference (Motion's dense resample) to its exact
    float32 corner gather (see ``tests/test_torch_queue.py``)."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def pair(channels=1, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(channels, *shape)).astype(np.float32)
    return (
        tj.Subject(t1=tj.ScalarImage(jnp.asarray(data))),
        tt.Subject(t1=tt.ScalarImage(torch.as_tensor(data))),
        data,
    )


def aggregate(pkg, subject, mode, patch=8, overlap=4, batch_size=3, model=None, **kwargs):
    """GridSampler -> SubjectsLoader -> ``model`` -> PatchAggregator."""
    sampler = pkg.GridSampler(subject, patch_size=patch, patch_overlap=overlap)
    agg = pkg.PatchAggregator(
        subject.spatial_shape, overlap_mode=mode, patch_overlap=overlap, **kwargs
    )
    for batch in pkg.SubjectsLoader(sampler, batch_size=batch_size):
        out = batch.images["t1"].data
        agg.add_batch(model(out) if model else out, batch.metadata["patch_location"])
    return agg


def assert_output_matches(jax_agg, port_agg, key=None):
    got, want = port_agg.get_output(key), jax_agg.get_output(key)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
    resolved = "__default__" if key is None else key
    if port_agg.overlap_mode == "crop":
        np.testing.assert_array_equal(got, want)
        return got
    np.testing.assert_array_equal(
        port_agg._counts[resolved].numpy(), np.asarray(jax_agg._counts[resolved])
    )
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL, atol=0)
    return got


@pytest.mark.parametrize("mode", ["crop", "average", "hann"])
@pytest.mark.parametrize(
    "patch, overlap, batch_size",
    [(8, 4, 3), ((6, 8, 10), (2, 4, 6), 4), (7, 0, 5)],
    ids=["overlap-4", "anisotropic", "no-overlap"],
)
def test_aggregator_matches_jax(mode, patch, overlap, batch_size):
    jax_subject, port_subject, data = pair(channels=2, seed=1)
    jax_agg = aggregate(tj, jax_subject, mode, patch, overlap, batch_size)
    port_agg = aggregate(tt, port_subject, mode, patch, overlap, batch_size)
    got = assert_output_matches(jax_agg, port_agg)
    tolerance = {"crop": (1e-5, 0), "average": (1e-4, 1e-5), "hann": (1e-3, 1e-4)}[mode]
    np.testing.assert_allclose(got, data, rtol=tolerance[0], atol=tolerance[1])


@pytest.mark.parametrize("mode", ["average", "hann"])
def test_dict_outputs_and_automatic_flush_match_jax(mode):
    jax_subject, port_subject, _ = pair(seed=2)
    aggs = []
    for pkg, subject in ((tj, jax_subject), (tt, port_subject)):
        # 3 patches of 8^3 float32 = 6 KiB a batch: every other batch flushes
        agg = aggregate(
            pkg, subject, mode, model=lambda x: {"a": x, "b": x * 2}, flush_bytes=10_000
        )
        aggs.append(agg)
    assert len(aggs[1]._pending.get("a", [])) <= 1  # 27 batches added
    for key in ("a", "b"):
        assert_output_matches(*aggs, key=key)
    for agg in aggs:
        with pytest.raises(KeyError, match="Available"):
            agg.get_output("c")


def test_automatic_flush_runs_before_get_output():
    _, subject, _ = pair(seed=3)
    agg = aggregate(tt, subject, "hann", flush_bytes=1)
    assert agg._pending == {}
    lazy = aggregate(tt, subject, "hann")
    assert len(lazy._pending["__default__"]) > 1
    np.testing.assert_array_equal(agg.get_output(), lazy.get_output())


@pytest.mark.parametrize("mode", ["crop", "average", "hann"])
def test_output_shape_scaling_matches_jax(mode):
    jax_subject, port_subject, _ = pair(seed=4, shape=(16, 16, 24))

    def halve(x):
        return x[:, :, ::2, ::2, ::2]

    aggs = [
        aggregate(pkg, s, mode, patch=8, overlap=4, model=halve, output_shape=(8, 8, 12))
        for pkg, s in ((tj, jax_subject), (tt, port_subject))
    ]
    out = assert_output_matches(*aggs)
    assert out.shape == (1, 8, 8, 12)


@pytest.mark.parametrize("mode", ["crop", "hann"])
def test_float16_and_device_outputs(mode):
    jax_subject, port_subject, _ = pair(seed=5)
    jax_agg = aggregate(tj, jax_subject, mode)
    port_agg = aggregate(tt, port_subject, mode)
    half = port_agg.get_output(dtype=np.float16)
    assert half.dtype == np.float16
    want = jax_agg.get_output(dtype=np.float16)
    if mode == "crop":
        np.testing.assert_array_equal(half, want)
    else:  # float16 of values within an ulp of float32: at most an ulp apart
        np.testing.assert_allclose(half, want, rtol=2**-10, atol=0)
    on_device = port_agg.get_output(device=True, dtype=torch.float16)
    assert isinstance(on_device, torch.Tensor) and on_device.dtype == torch.float16
    np.testing.assert_array_equal(on_device.numpy(), half)


def test_crop_device_output_never_aliases_the_buffer():
    _, subject, _ = pair(seed=6)
    agg = aggregate(tt, subject, "crop", overlap=0)
    first = agg.get_output(device=True)
    host = agg.get_output()
    snapshot = first.clone()
    loc = tt.PatchLocation((0, 0, 0), (8, 8, 8))
    agg.add_batch(torch.full((1, 1, 8, 8, 8), 99.0), [loc])
    torch.testing.assert_close(first, snapshot, rtol=0, atol=0)
    np.testing.assert_array_equal(host, snapshot.numpy())
    assert agg.get_output(device=True)[0, 0, 0, 0] == 99.0
    assert first.data_ptr() != agg._outputs["__default__"].data_ptr()


def test_hann_window_matches_jax():
    from torchio_tpu.data import aggregator as jax_aggregator
    from torchio_tpu_torch.data import aggregator as port_aggregator

    for size in [(8, 8, 8), (5, 9, 12), (1, 2, 64)]:
        np.testing.assert_array_equal(
            port_aggregator._build_hann_3d(size), jax_aggregator._build_hann_3d(size)
        )


def test_aggregator_errors_match_jax():
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match="overlap_mode"):
            pkg.PatchAggregator((8, 8, 8), overlap_mode="max")
        with pytest.raises(KeyError, match="No output"):
            pkg.PatchAggregator((8, 8, 8)).get_output()


# --- the slice as a whole ---------------------------------------------------


def test_config5_slice_matches_jax(monkeypatch):
    """Queue (Motion + Ghosting) -> ``device_batches`` -> an identity
    model, then each transformed subject through GridSampler and a hann
    PatchAggregator; the JAX package's run on the same seeds."""
    motion = []
    apply = tt.Motion.apply_transform
    monkeypatch.setattr(
        tt.Motion, "apply_transform", lambda self, b, p: motion.append(1) or apply(self, b, p)
    )
    runs = []
    for pkg in (tj, tt):
        random.seed(12)
        pkg.seed(12)
        pool = subjects(pkg, 2, size=32)
        queue = pkg.Queue(
            pool,
            pkg.LabelSampler(patch_size=16, label_name="seg"),
            max_length=8,
            patches_per_volume=4,
            transform=config5(pkg),
        )
        batches = list(queue.device_batches(batch_size=4, epochs=2))
        for batch in batches:  # the identity "model" of a training step
            batch.images["t1"].data = batch.images["t1"].data * 1
        outputs = []
        for subject in pool:
            transformed = config5(pkg)(subject)
            agg = aggregate(pkg, transformed, "hann", patch=16, overlap=8, batch_size=4)
            outputs.append((transformed.t1.data, agg.get_output()))
        runs.append((batches, outputs))
    (jax_batches, jax_outs), (port_batches, port_outs) = runs
    assert motion
    assert len(port_batches) == len(jax_batches) == 4
    for a, b in zip(jax_batches, port_batches):
        assert_batch_equal(a, b, 4, patch=16)
        assert (b.images["seg"].data[:, 0, 8, 8, 8] > 0).all()
    for (jax_in, jax_out), (port_in, port_out) in zip(jax_outs, port_outs):
        np.testing.assert_allclose(port_in.numpy(), np.asarray(jax_in), rtol=0, atol=KSPACE_ATOL)
        # the transformed inputs agree within KSPACE_ATOL, and the
        # reassembly adds an ulp a patch (VALUE_RTOL) on top
        np.testing.assert_allclose(port_out, jax_out, rtol=VALUE_RTOL, atol=KSPACE_ATOL)
        np.testing.assert_allclose(port_out, port_in.numpy(), rtol=1e-3, atol=1e-4)
