"""Port parity: the headline Compose, end to end, against the JAX package.

``Compose([Spatial(scales, degrees, translation, max_displacement=7.5),
BiasField(std=0.5), Noise(std=0.1)], fuse=...)`` runs in both packages
from the same ``seed`` on the same numpy volumes, at a small size:

- the recorded history params are EQUAL, key for key;
- the outputs agree within atol 1e-4, with the port's device normals
  replaced by the JAX package's (``jax_device_normal``); once with the
  JAX package on its XLA gather, once with its Pallas shear kernels in
  interpret mode;
- the JAX package's recorded params replay through the port's
  ``apply_transform`` to the same result;
- elements gated out by per-instance ``p`` stay bit-exact.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_intensity import jax_device_normal, make_batches

SLICE_ATOL = 1e-4
SHAPE = (1, 24, 26, 28)
#: K > 128: the JAX package takes its shear kernels (as the headline does
#: at 256^3) instead of the windowed kernel, which small volumes qualify for
SHEAR_SHAPE = (1, 20, 22, 136)

pytestmark = pytest.mark.filterwarnings("ignore:The maximum displacement")


@pytest.fixture
def jax_normals(monkeypatch):
    monkeypatch.setattr(tt.random, "device_normal", jax_device_normal)


def headline(pkg, fuse=True, p=1.0):
    return pkg.Compose(
        [
            pkg.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
                p=p,
            ),
            pkg.BiasField(std=0.5, p=p),
            pkg.Noise(std=0.1, p=p),
        ],
        fuse=fuse,
    )


def assert_same_history(jax_out, port_out):
    jax_h = [(h.name, h.params) for h in jax_out.applied_transforms]
    port_h = [(h.name, h.params) for h in port_out.applied_transforms]
    assert [n for n, _ in port_h] == ["Spatial", "BiasField", "Noise"]
    assert jax_h == port_h


@pytest.mark.parametrize(
    "fuse,jax_path",
    [(True, "gather"), (False, "gather"), (True, "interpret")],
    ids=["fused-gather", "unfused-gather", "fused-interpret"],
)
def test_headline_matches_jax(fuse, jax_path, jax_normals, monkeypatch):
    shear_calls = []
    if jax_path == "interpret":
        import torchio_tpu.ops.shear_resample as sr

        monkeypatch.setenv("TORCHIO_TPU_WINDOW_INTERPRET", "1")
        monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
        real = sr.shear_resample_fused
        monkeypatch.setattr(
            sr, "shear_resample_fused",
            lambda *a, **k: shear_calls.append(1) or real(*a, **k),
        )
    shape = SHEAR_SHAPE if jax_path == "interpret" else SHAPE
    jax_batch, port_batch = make_batches(b=2, shape=shape, seed=1)
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(2024)
        outs.append(headline(pkg, fuse=fuse)(batch))
    jax_out, port_out = outs
    assert shear_calls == ([1] if jax_path == "interpret" else [])
    assert_same_history(jax_out, port_out)
    got = port_out.t1.data.numpy()
    assert got.shape == (2, *shape) and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jax_out.t1.data), rtol=0, atol=SLICE_ATOL
    )


def test_fused_and_unfused_port_agree():
    _, batch = make_batches(b=2, shape=SHAPE, seed=4)
    outs = []
    for fuse in (False, True):
        tt.seed(9)
        outs.append(headline(tt, fuse=fuse)(batch))
    assert [h.params for h in outs[0].applied_transforms] == [
        h.params for h in outs[1].applied_transforms
    ]
    assert torch.equal(outs[0].t1.data, outs[1].t1.data)


def test_jax_params_replay_through_the_port(jax_normals):
    """Plain JSON params recorded by the JAX package drive the port's
    ``apply_transform`` to the same result."""
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, seed=5)
    tj.seed(77)
    records = []
    for transform in headline(tj, fuse=False).transforms:
        params = transform.make_params(jax_batch)
        jax_batch = transform.apply_transform(jax_batch, params)
        records.append((type(transform).__name__, json.loads(json.dumps(params))))
    port_classes = {"Spatial": tt.Spatial, "BiasField": tt.BiasField, "Noise": tt.Noise}
    for name, params in records:
        port_batch = port_classes[name]().apply_transform(port_batch, params)
    np.testing.assert_allclose(
        port_batch.t1.data.numpy(), np.asarray(jax_batch.t1.data),
        rtol=0, atol=SLICE_ATOL,
    )


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", ["Spatial", "BiasField", "Noise"])
def test_gated_out_elements_are_bit_exact(name, fuse):
    _, batch = make_batches(b=4, shape=SHAPE, seed=6)
    transform = headline(tt, p=0.5).transforms[
        ["Spatial", "BiasField", "Noise"].index(name)
    ]
    if fuse:
        transform = tt.Compose([transform], fuse=True)
    tt.seed(12)
    out = transform(batch)
    params = out.applied_transforms[0].params
    keep = params["_keep"]
    assert any(keep) and not all(keep)
    for i, kept in enumerate(keep):
        same = torch.equal(out.t1.data[i], batch.t1.data[i])
        assert same != kept


@pytest.mark.parametrize("kind", ["subject", "image", "ndarray", "tensor", "dict"])
def test_entry_points_round_trip(kind):
    rng = np.random.default_rng(8)
    arr = rng.random((1, 12, 13, 14), np.float32)
    data = {
        "subject": lambda: tt.Subject(t1=tt.ScalarImage(arr)),
        "image": lambda: tt.ScalarImage(arr),
        "ndarray": lambda: arr,
        "tensor": lambda: torch.as_tensor(arr),
        "dict": lambda: {"t1": arr, "age": 40},
    }[kind]()
    tt.seed(1)
    out = tt.Affine(degrees=(-10, 10), default_pad_value=0.0)(data)
    assert type(out) is type(data)
    if kind == "dict":
        assert out["age"] == 40 and out["t1"].shape == arr.shape
    elif kind in ("subject", "image"):
        assert [h.name for h in out.history] == ["Affine"]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['torchio_tpu'] = None\n"
        "before = set(sys.modules)\n"
        "import torchio_tpu_torch as tio\n"
        "import torchio_tpu_torch.ops.resample_kernel\n"
        "new = set(sys.modules) - before\n"
        "assert not [m for m in new if m.split('.')[0] in ('jax', 'torchio_tpu')], new\n"
        "print(tio.Compose.__name__)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "Compose"
