"""Port parity: ``torchio_tpu_torch.warmup`` against ``torchio_tpu.warmup``.

On the CPU:

- the host RNG state is restored: the next host draws after ``warmup``
  equal the JAX package's after its ``warmup``, and equal the draws of a
  run with no warm-up;
- a seeded headline (``Compose([Spatial, BiasField, Noise], fuse=True)``,
  B=2 x 24^3) after ``warmup`` is within 1e-4 of the JAX package's after
  its own, and bit-equal to the port's own run without a warm-up;
- ``warmup`` with ``label_keys``, several channels and ``repeats=3``
  runs each repeat on a batch of the given shapes;
- the transform passed in keeps its ``p`` (a deep copy runs at p=1);
- the kernel libraries are built first where the default device is not
  the CPU, and a failed build raises; on the CPU nothing is built.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from torchio_tpu_torch.ops import kernel_lib
from torchio_tpu_torch.warmup import _force_apply

PIPELINE_ATOL = 1e-4
SHAPE = (24, 24, 24)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """The JAX package's exact corner gather (``bench.py``'s import turns
    the float16 one on for the rest of an xdist worker)."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def headline(pkg, p=1.0):
    return pkg.Compose(
        [
            pkg.Spatial(
                scales=(0.9, 1.1), degrees=(-10.0, 10.0), translation=(-5.0, 5.0),
                max_displacement=7.5, p=p,
            ),
            pkg.BiasField(std=0.5),
            pkg.Noise(std=0.1),
        ],
        fuse=True,
    )


def batch(pkg, b=2):
    data = np.random.default_rng(7).random((b, 1, *SHAPE)).astype(np.float32)
    return pkg.SubjectsBatch.from_subjects([pkg.Subject(t1=pkg.ScalarImage(d)) for d in data])


def test_host_draws_after_warmup_equal_jax():
    draws = []
    for pkg in (tj, tt):
        pkg.seed(0)
        pkg.warmup(headline(pkg), (12, 10, 8), batch_size=2)
        draws.append(pkg.random.get_rng().random(5))
    tt.seed(0)
    np.testing.assert_array_equal(draws[1], draws[0])
    np.testing.assert_array_equal(draws[1], tt.random.get_rng().random(5))


def test_seeded_headline_after_warmup_equal_jax():
    outs = []
    for pkg in (tj, tt):
        pkg.seed(0)
        pkg.warmup(headline(pkg), SHAPE, batch_size=2)
        outs.append(headline(pkg)(batch(pkg)).t1.data)
    want, got = np.asarray(outs[0]), outs[1].numpy()
    assert np.abs(got - want).max() <= PIPELINE_ATOL
    tt.seed(0)
    cold = headline(tt)(batch(tt)).t1.data
    assert torch.equal(outs[1], cold)


def test_labels_channels_and_repeats(monkeypatch):
    seen = []
    transform = tt.Compose(
        [tt.Flip(axes=(0,), p=0.5), tt.RescaleIntensity(out_min=0.0, out_max=1.0)]
    )
    original = tt.Compose.forward

    def spy(self, data):
        out = original(self, data)
        seen.append((dict(data.images), out))
        return out

    monkeypatch.setattr(tt.Compose, "forward", spy)
    tt.warmup(
        transform, (6, 7, 5), channels=2, batch_size=3, label_keys=["seg", "brain"],
        image_key="mri", repeats=3,
    )
    assert len(seen) == 3
    for images, out in seen:
        assert list(images) == ["mri", "seg", "brain"]
        assert tuple(images["mri"].data.shape) == (3, 2, 6, 7, 5)
        assert images["seg"].image_class is tt.LabelMap
        assert images["seg"].data.dtype == torch.uint8
        # every repeat at p=1; RescaleIntensity records itself as Normalize
        assert [h.name for h in out.applied_transforms] == ["Flip", "Normalize"]
    assert transform.transforms[0].p == 0.5


def test_transform_keeps_its_p():
    transform = headline(tt, p=0.25)
    noise = tt.Noise(std=0.1, p=0.0)
    tt.warmup(transform, (6, 6, 6))
    tt.warmup(noise, (6, 6, 6))
    assert transform.transforms[0].p == 0.25
    assert noise.p == 0.0


def test_force_apply_recurses():
    transform = tt.Compose(
        [tt.OneOf([tt.Flip(p=0.1), tt.Noise(p=0.2)], p=0.3), tt.Gamma(log_gamma=0.1, p=0.0)]
    )
    _force_apply(transform)
    one_of = transform.transforms[0]
    assert one_of.p == 1.0 and transform.transforms[1].p == 1.0
    assert all(t.p == 1.0 for t in one_of.transforms)


def test_kernels_build_first_on_the_card(monkeypatch):
    calls = []

    def build_all():
        calls.append(1)
        raise RuntimeError("nvcc failed on resample.cu (1)")

    monkeypatch.setattr(kernel_lib, "build_all", build_all)
    tt.warmup(tt.Flip(), (4, 4, 4))  # the CPU: nothing to build
    assert calls == []
    tt.set_default_device("cuda")
    state = tt.random.get_rng().bit_generator.state
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tt.warmup(tt.Flip(), (4, 4, 4))
    assert calls == [1]
    assert tt.random.get_rng().bit_generator.state == state
