"""Port parity: BiasField and Noise against the JAX package.

Both packages draw the same parameters from the same ``seed``. The device
normals differ by design (``torch.Generator`` against ``jax.random``), so
the port's one device draw, ``torchio_tpu_torch.random.device_normal``,
is replaced by :func:`jax_device_normal`, which derives the JAX package's
keys from the same arguments. Outputs then agree within rtol 1e-5,
atol 1e-6 (exp and the lerps round differently in XLA and torch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu.data.batch import SubjectsBatch as JaxBatch

RTOL, ATOL = 1e-5, 1e-6


def jax_device_normal(seed, shape, device, index):
    """The JAX package's draw ``index`` of ``seed``: index 0 is
    ``PRNGKey(seed)`` itself (BiasField); Noise image ``n`` splits the key
    ``n + 1`` times and takes ``k1`` (index ``2n + 1``) or ``k2``
    (index ``2n + 2``)."""
    key = jax.random.PRNGKey(seed)
    if index > 0:
        for _ in range((index - 1) // 2 + 1):
            key, k1, k2 = jax.random.split(key, 3)
        key = k1 if index % 2 == 1 else k2
    normal = np.array(jax.random.normal(key, tuple(shape), jnp.float32))
    return torch.as_tensor(normal, device=device)


@pytest.fixture
def jax_normals(monkeypatch):
    monkeypatch.setattr(tt.random, "device_normal", jax_device_normal)


def block_labels(rng, spatial, block=4):
    """(1, *spatial) int32 labels in {0, 1, 2, 4} (the BraTS label set),
    constant on blocks of ``block`` voxels: region boundaries, not a
    boundary at every voxel."""
    coarse = rng.integers(0, 4, [-(-s // block) for s in spatial])
    labels = coarse.repeat(block, 0).repeat(block, 1).repeat(block, 2)
    labels = labels[: spatial[0], : spatial[1], : spatial[2]].astype(np.int32)
    labels[labels == 3] = 4
    return labels[None]


def make_batches(b=2, shape=(1, 14, 16, 18), seed=0, names=("t1",), labels=()):
    """The same numpy volumes as a JAX batch and a port batch: ScalarImages
    ``names`` of ``shape``, then int32 LabelMaps ``labels`` (one channel,
    :func:`block_labels`), all drawn from one numpy seed."""
    rng = np.random.default_rng(seed)
    arrays = [
        {n: (rng.random(shape, np.float32) + 0.5) for n in names} for _ in range(b)
    ]
    segs = [{n: block_labels(rng, shape[1:]) for n in labels} for _ in range(b)]
    batches = []
    for pkg, batch_class in ((tj, JaxBatch), (tt, tt.SubjectsBatch)):
        subjects = [
            pkg.Subject(
                **{n: pkg.ScalarImage(a[n]) for n in names},
                **{n: pkg.LabelMap(s[n]) for n in labels},
            )
            for a, s in zip(arrays, segs)
        ]
        batches.append(batch_class.from_subjects(subjects))
    return tuple(batches)


def run_both(make, jax_batch, port_batch, seed=7, fuse=False):
    """One transform (or a fused one-transform Compose) in both packages
    from the same seed; returns both outputs."""
    pkg_out = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        transform = make(pkg)
        if fuse:
            transform = pkg.Compose([transform], fuse=True)
        pkg.seed(seed)
        pkg_out.append(transform(batch))
    return pkg_out


def assert_same(jax_out, port_out, names=("t1",)):
    assert [h.name for h in jax_out.applied_transforms] == [
        h.name for h in port_out.applied_transforms
    ]
    for hj, hp in zip(jax_out.applied_transforms, port_out.applied_transforms):
        assert hj.params == hp.params
    for n in names:
        np.testing.assert_allclose(
            port_out.images[n].data.numpy(),
            np.asarray(jax_out.images[n].data),
            rtol=RTOL,
            atol=ATOL,
        )


TRANSFORMS = {
    "bias-per-element": lambda pkg: pkg.BiasField(std=(0.2, 0.8)),
    "bias-shared": lambda pkg: pkg.BiasField(std=(0.2, 0.8), per_instance=False),
    "bias-gated": lambda pkg: pkg.BiasField(std=0.5, p=0.5),
    "noise-gaussian": lambda pkg: pkg.Noise(mean=(-0.1, 0.1), std=(0.05, 0.2)),
    "noise-shared": lambda pkg: pkg.Noise(std=0.1, per_instance=False),
    "noise-rician": lambda pkg: pkg.Noise(std=(0.05, 0.2), rician=True),
    "noise-rician-gated": lambda pkg: pkg.Noise(std=0.1, rician=True, p=0.5),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_matches_jax(name, fuse, jax_normals):
    jax_batch, port_batch = make_batches(b=4 if "gated" in name else 2)
    jax_out, port_out = run_both(TRANSFORMS[name], jax_batch, port_batch, fuse=fuse)
    if "gated" in name:
        keep = port_out.applied_transforms[0].params["_keep"]
        assert any(keep) and not all(keep)
    assert_same(jax_out, port_out)


def test_noise_draws_follow_image_order(jax_normals):
    """Two images: the second takes the key after the first's split."""
    jax_batch, port_batch = make_batches(names=("t1", "t2"))
    jax_out, port_out = run_both(
        lambda pkg: pkg.Noise(std=0.1, rician=True), jax_batch, port_batch
    )
    assert_same(jax_out, port_out, names=("t1", "t2"))


def test_replay_regenerates_the_same_field():
    """Within the port, a recorded seed regenerates the same field."""
    _, batch = make_batches()
    tt.seed(3)
    first = tt.Compose([tt.BiasField(), tt.Noise(rician=True)])(batch)
    again = batch
    for record in first.applied_transforms:
        transform = {"BiasField": tt.BiasField, "Noise": tt.Noise}[record.name]()
        again = transform.apply_transform(again, record.params)
    assert torch.equal(again.t1.data, first.t1.data)


def test_default_device_normal_is_seeded_per_draw():
    a = tt.random.device_normal(5, (3, 4), "cpu", 1)
    assert a.dtype == torch.float32 and a.shape == (3, 4)
    assert torch.equal(a, tt.random.device_normal(5, (3, 4), "cpu", 1))
    assert not torch.equal(a, tt.random.device_normal(5, (3, 4), "cpu", 2))
    assert not torch.equal(a, tt.random.device_normal(6, (3, 4), "cpu", 1))


def test_cpu_warmup_steadies_the_first_parallel_exp():
    """In fresh processes that import the warm-up helper, the next large
    multithreaded ``torch.exp`` agrees with float64 numpy to 1e-5 (without
    the warm-up, PyTorch 2.13.0+cpu has missed by up to 4.2e-4 in about a
    third of fresh processes)."""
    import pathlib
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np, torch\n"
        "import cpu_warmup\n"
        "x = np.random.default_rng(int(sys.argv[2])).uniform(-3, 3, 168960)\n"
        "x = x.astype(np.float32)\n"
        "got = torch.exp(torch.as_tensor(x)).numpy()\n"
        "print(float(np.abs(got - np.exp(x.astype(np.float64))).max()))\n"
    )
    tests = str(pathlib.Path(__file__).parent)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, tests, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(4)
    ]
    errors = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        errors.append(float(out.strip().splitlines()[-1]))
    assert max(errors) <= 1e-5, errors
