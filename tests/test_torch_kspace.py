"""Port parity: Motion, Ghosting and Spike (the k-space transforms)
against the JAX package.

Both packages draw the same parameters from the same ``seed`` (host numpy
only: neither transform draws on the device) and run them on the same
numpy volumes in [0, 1):

- the recorded history params are EQUAL, key for key;
- the outputs agree within 1e-5 (the FFTs are ``torch.fft`` against
  XLA's; the dense resample of Motion is the plain version of the port's
  kernel against the XLA gather);
- BASELINE.json config 5's ``Compose([Motion(degrees=5, translation=3,
  num_transforms=1, p=0.5), Ghosting(intensity=(0.3, 0.7), p=0.5)])`` end
  to end, with gated-out elements bit-exact and label maps untouched;
- the JAX package's recorded params replay through the port.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu.config as jax_config
import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_intensity import make_batches
from torchio_tpu_torch.transforms.transform import get_transform_class


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather: its
    opt-in float16 gather (left on for the rest of a process by importing
    ``bench.py``, as ``tests/test_parallel.py`` does) rounds the corner
    values by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


KSPACE_ATOL = 1e-5
SHAPE = (1, 12, 14, 20)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build images from numpy and compare on the CPU: ask the
    port to put host data there (its default is the card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def config5(pkg, p=0.5):
    """BASELINE.json config 5's artifact pair (benchmarks/patches_bench.py)."""
    return pkg.Compose(
        [
            pkg.Motion(degrees=5, translation=3, num_transforms=1, p=p),
            pkg.Ghosting(intensity=(0.3, 0.7), p=p),
        ]
    )


def run_both(make, b=2, shape=SHAPE, seed=7, labels=()):
    jax_batch, port_batch = make_batches(b=b, shape=shape, seed=3, labels=labels)
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(seed)
        outs.append(make(pkg)(batch))
    return port_batch, outs[0], outs[1]


def assert_same(jax_out, port_out, names=("t1",)):
    assert [(h.name, h.params) for h in jax_out.applied_transforms] == [
        (h.name, h.params) for h in port_out.applied_transforms
    ]
    for n in names:
        got = port_out.images[n].data
        assert got.dtype == torch.float32 and got.shape == tuple(jax_out.images[n].data.shape)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_out.images[n].data), rtol=0, atol=KSPACE_ATOL
        )


TRANSFORMS = {
    "motion": lambda pkg: pkg.Motion(degrees=(-8, 8), translation=(-3, 3)),
    "motion-one-move": lambda pkg: pkg.Motion(degrees=5, translation=3, num_transforms=1),
    "motion-three-moves": lambda pkg: pkg.Motion(num_transforms=3),
    "motion-shared": lambda pkg: pkg.Motion(degrees=(-8, 8), per_instance=False),
    "motion-gated": lambda pkg: pkg.Motion(degrees=5, translation=3, p=0.5),
    "ghosting": lambda pkg: pkg.Ghosting(intensity=(0.3, 0.7)),
    "ghosting-range-axes": lambda pkg: pkg.Ghosting(
        num_ghosts=(2, 6), axes=(0, 2), intensity=(0.5, 1.0)
    ),
    "ghosting-restore": lambda pkg: pkg.Ghosting(intensity=0.8, restore=0.3),
    "ghosting-shared": lambda pkg: pkg.Ghosting(intensity=(0.3, 0.7), per_instance=False),
    "ghosting-gated": lambda pkg: pkg.Ghosting(intensity=(0.3, 0.7), p=0.5),
    "spike": lambda pkg: pkg.Spike(intensity=(1, 3)),
    "spike-many": lambda pkg: pkg.Spike(num_spikes=(1, 5), intensity=(-2, 2)),
    "spike-shared": lambda pkg: pkg.Spike(num_spikes=3, intensity=1.5, per_instance=False),
    "spike-gated": lambda pkg: pkg.Spike(num_spikes=2, intensity=(1, 3), p=0.5),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_matches_jax(name):
    b = 4 if "gated" in name else 2
    _, jax_out, port_out = run_both(TRANSFORMS[name], b=b)
    if "gated" in name:
        keep = port_out.applied_transforms[0].params["_keep"]
        assert any(keep) and not all(keep)
    assert_same(jax_out, port_out)


@pytest.mark.parametrize("seed", [7, 10])
def test_config5_matches_jax_with_gated_elements_bit_exact(seed):
    port_in, jax_out, port_out = run_both(config5, b=4, seed=seed, labels=("seg",))
    assert_same(jax_out, port_out)
    assert torch.equal(port_out.seg.data, port_in.seg.data)
    assert port_out.seg.data.dtype == torch.int32
    kept = {h.name: h.params["_keep"] for h in port_out.applied_transforms}
    assert set(kept) == {"Motion", "Ghosting"}
    untouched = [not (kept["Motion"][i] or kept["Ghosting"][i]) for i in range(4)]
    touched = [kept["Motion"][i] or kept["Ghosting"][i] for i in range(4)]
    assert any(touched) and any(untouched)
    for i in range(4):
        same = torch.equal(port_out.t1.data[i], port_in.t1.data[i])
        assert same == untouched[i]


@pytest.mark.parametrize("name", ["Motion", "Ghosting"])
def test_gated_out_elements_are_bit_exact(name):
    _, batch = make_batches(b=4, shape=SHAPE, seed=6)
    transform = config5(tt).transforms[["Motion", "Ghosting"].index(name)]
    tt.seed(12)
    out = transform(batch)
    keep = out.applied_transforms[0].params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        assert torch.equal(out.t1.data[i], batch.t1.data[i]) != kept


def test_label_maps_are_untouched():
    _, batch = make_batches(b=2, shape=SHAPE, seed=8, labels=("seg",))
    tt.seed(1)
    out = config5(tt, p=1.0)(batch)
    assert [h.name for h in out.applied_transforms] == ["Motion", "Ghosting"]
    assert torch.equal(out.seg.data, batch.seg.data)
    assert not torch.equal(out.t1.data, batch.t1.data)


@pytest.mark.filterwarnings("ignore:Ghosting with default arguments")
def test_jax_params_replay_through_the_port():
    """Plain JSON params recorded by the JAX package drive the port's
    ``apply_transform`` to the same result, with the classes looked up
    by their recorded names."""
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, seed=5)
    tj.seed(77)
    records = []
    for transform in config5(tj, p=1.0).transforms:
        params = transform.make_params(jax_batch)
        jax_batch = transform.apply_transform(jax_batch, params)
        records.append((type(transform).__name__, json.loads(json.dumps(params))))
    for name, params in records:
        port_batch = get_transform_class(name)().apply_transform(port_batch, params)
    np.testing.assert_allclose(
        port_batch.t1.data.numpy(), np.asarray(jax_batch.t1.data), rtol=0, atol=KSPACE_ATOL
    )


def test_motion_keeps_the_input_dtype():
    data = np.random.default_rng(2).integers(0, 1000, (1, 12, 14, 20)).astype(np.int16)
    outs = []
    for pkg in (tj, tt):
        pkg.seed(4)
        outs.append(pkg.Motion(degrees=5, translation=3)(pkg.ScalarImage(data)))
    jax_out, port_out = outs
    assert port_out.data.dtype == torch.int16
    # integer truncation of values within 1e-5 agrees except exactly at
    # an integer boundary
    diff = np.abs(port_out.data.numpy().astype(np.int32) - np.asarray(jax_out.data, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: tt.Motion(num_transforms=0), "num_transforms must be a positive int"),
        (lambda: tt.Motion(num_transforms=1.5), "num_transforms must be a positive int"),
        (lambda: tt.Ghosting(intensity=-0.5), "non-negative"),
        (lambda: tt.Ghosting(num_ghosts=(-2, 3), intensity=0.5), "non-negative"),
    ],
)
def test_bad_arguments_raise(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_motion_raises_when_a_segment_would_be_empty():
    image = tt.ScalarImage(np.zeros((1, 2, 8, 8), np.float32))
    for pkg, img in ((tj, tj.ScalarImage(np.zeros((1, 2, 8, 8), np.float32))), (tt, image)):
        with pytest.raises(ValueError, match="Cannot split 2 k-space slices into 3"):
            pkg.Motion(num_transforms=2)(img)


def test_ghosting_warns_when_it_is_a_noop():
    with pytest.warns(RuntimeWarning, match="Ghosting with default arguments is a no-op"):
        tt.Ghosting()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.Ghosting(intensity=0.5)


def test_zero_intensity_ghosting_is_the_identity():
    _, batch = make_batches(b=2, shape=SHAPE, seed=9)
    tt.seed(2)
    with pytest.warns(RuntimeWarning):
        out = tt.Ghosting(intensity=0.0)(batch)
    assert torch.equal(out.t1.data, batch.t1.data)


def test_names_register_as_in_the_jax_package():
    for name in ("Motion", "Ghosting"):
        assert get_transform_class(name) is getattr(tt, name)
        assert name in tt.__all__ and name in tj.__all__


def test_spike_on_two_channels_matches_jax():
    _, jax_out, port_out = run_both(
        lambda pkg: pkg.Spike(num_spikes=(2, 4), intensity=(0.5, 2)), b=3, shape=(2, 10, 12, 9)
    )
    assert_same(jax_out, port_out)


def test_spike_gated_out_elements_are_bit_exact():
    _, batch = make_batches(b=4, shape=SHAPE, seed=6)
    tt.seed(12)
    out = tt.Spike(intensity=(1, 3), p=0.5)(batch)
    params = out.applied_transforms[0].params
    keep = params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        assert torch.equal(out.t1.data[i], batch.t1.data[i]) != kept
        assert (params["positions"][i] == []) != kept


def test_spike_warns_as_the_jax_package_when_it_is_a_noop():
    messages = []
    for pkg in (tj, tt):
        with pytest.warns(RuntimeWarning, match="Spike with default arguments is a no-op") as got:
            pkg.Spike()
        messages.append([str(w.message) for w in got])
    assert messages[0] == messages[1]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tt.Spike(intensity=1.0)
    assert get_transform_class("Spike") is tt.Spike and "Spike" in tt.__all__
