"""Port parity: the headline Compose, end to end, against the JAX package.

``Compose([Spatial(scales, degrees, translation, max_displacement=7.5),
BiasField(std=0.5), Noise(std=0.1)], fuse=...)`` runs in both packages
from the same ``seed`` on the same numpy volumes, at a small size:

- the recorded history params are EQUAL, key for key;
- the outputs agree within atol 1e-4, each package with its own device
  normals (the port derives the JAX package's threefry keys); once with
  the JAX package on its XLA gather, once with its Pallas shear kernels
  in interpret mode;
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
import torchio_tpu.config as jax_config
import torchio_tpu_torch as tt
from test_torch_intensity import make_batches
from torchio_tpu_torch.ops.resample import upsample_volume

SLICE_ATOL = 1e-4
SHAPE = (1, 24, 26, 28)
#: K > 128: the JAX package takes its shear kernels (as the headline does
#: at 256^3) instead of the windowed kernel, which small volumes qualify for
SHEAR_SHAPE = (1, 20, 22, 136)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build images from numpy and compare on the CPU: ask the
    port to put host data there (its default is the card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture
def gather16_leak(request, monkeypatch):
    """What an earlier test of the same process may leave behind:
    importing ``bench.py`` (``tests/test_parallel.py`` runs it) sets
    ``TORCHIO_TPU_GATHER16=1`` for the rest of the process. A test asks for
    that leak with an indirect parameter; by default nothing is set."""
    leak = getattr(request, "param", None)
    if leak is not None:
        monkeypatch.setenv("TORCHIO_TPU_GATHER16", leak)
        monkeypatch.setattr(jax_config, "use_gather16", True)


@pytest.fixture(autouse=True)
def exact_jax_gather(gather16_leak, monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather: its
    opt-in float16 gather rounds the corner values by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


pytestmark = pytest.mark.filterwarnings("ignore:The maximum displacement")


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
def test_headline_matches_jax(fuse, jax_path, monkeypatch):
    shear_calls = []
    if jax_path == "interpret":
        import torchio_tpu.ops.shear_resample as sr

        monkeypatch.setenv("TORCHIO_TPU_WINDOW_INTERPRET", "1")
        real = sr.shear_resample_fused
        monkeypatch.setattr(
            sr, "shear_resample_fused",
            lambda *a, **k: shear_calls.append(1) or real(*a, **k),
        )
    shape = SHEAR_SHAPE if jax_path == "interpret" else SHAPE
    assert_headline_matches_jax(fuse, shape)
    assert shear_calls == ([1] if jax_path == "interpret" else [])


def assert_headline_matches_jax(fuse, shape):
    """The headline from one seed in both packages: equal histories, and
    outputs within SLICE_ATOL."""
    jax_batch, port_batch = make_batches(b=2, shape=shape, seed=1)
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(2024)
        outs.append(headline(pkg, fuse=fuse)(batch))
    jax_out, port_out = outs
    assert_same_history(jax_out, port_out)
    got = port_out.t1.data.numpy()
    assert got.shape == (2, *shape) and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jax_out.t1.data), rtol=0, atol=SLICE_ATOL
    )


@pytest.mark.parametrize("gather16_leak", ["1"], indirect=True)
def test_jax_reference_ignores_a_leaked_gather16(gather16_leak):
    """A float16 gather switched on earlier in the process (as importing
    ``bench.py`` does) does not reach the reference the port is held to."""
    assert not jax_config.gather16()
    assert_headline_matches_jax(True, SHAPE)


class StagelessNoise(tt.Noise):
    """Fusable, but declines to build a stage (as a transform may once it
    has looked at the batch)."""

    def fused_stage(self, batch):
        return None


@pytest.mark.parametrize(
    "p,per_instance", [(1.0, True), (0.5, False), (0.5, True)],
    ids=["always", "coin", "per-instance"],
)
def test_fusable_transform_without_a_stage_runs_unfused(p, per_instance):
    """A fusable transform whose ``fused_stage`` returns None runs eagerly
    on the coin the fused Compose drew: output, the RNG stream after the
    call and the history equal the unfused Compose's."""
    _, batch = make_batches(b=2, shape=SHAPE, seed=3)
    results = []
    for fuse in (False, True):
        compose = tt.Compose(
            [
                tt.BiasField(std=0.5),
                StagelessNoise(std=0.1, p=p, per_instance=per_instance),
                tt.Noise(std=0.2),
            ],
            fuse=fuse,
        )
        for seed in range(4):  # both sides of the coin
            tt.seed(seed)
            out = compose(batch)
            results.append(
                (fuse, seed, out.t1.data, float(tt.random.random()),
                 [(h.name, h.params) for h in out.applied_transforms])
            )
    unfused, fused = results[:4], results[4:]
    for (_, _, want, want_next, want_h), (_, _, got, got_next, got_h) in zip(unfused, fused):
        assert torch.equal(got, want)
        assert got_next == want_next
        assert got_h == want_h
    coin = p < 1 and not per_instance
    assert {len(h) for *_, h in fused} == ({2, 3} if coin else {3})


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


def test_jax_params_replay_through_the_port():
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


HOST_ENTRIES = {
    "image": lambda arr: tt.ScalarImage(arr).data,
    "label": lambda arr: tt.LabelMap(arr.astype(np.int32)).data,
    "subject": lambda arr: tt.Subject(t1=tt.ScalarImage(arr)).t1.data,
    "ndarray": lambda arr: tt.Affine._wrap(arr)[0].tio_default_image.data,
    "dict": lambda arr: tt.Affine._wrap({"t1": arr, "age": 40})[0].t1.data,
    "list": lambda arr: tt.ScalarImage(arr.tolist()).data,
    "build_coords": lambda arr: tt.ops.build_coords(arr.shape[1:], np.eye(4)),
    "upsample_field": lambda arr: tt.ops.upsample_field(arr.reshape(4, 5, 2, 3), (8, 10, 4)),
    "upsample_volume": lambda arr: upsample_volume(arr, (8, 10, 12)),
}
#: the shapes of the entries that do not return their input's shape
HOST_SHAPES = {
    "build_coords": (4, 5, 6, 3),
    "upsample_field": (8, 10, 4, 3),
    "upsample_volume": (1, 8, 10, 12),
}


@pytest.mark.parametrize("kind", sorted(HOST_ENTRIES))
def test_host_data_goes_to_the_default_device(kind):
    """numpy and lists given to an image, a subject, a transform or an op
    land on the default device ("meta" stands in for a card here: it is
    neither the CPU nor the tensor's own device)."""
    arr = np.random.default_rng(9).random((1, 4, 5, 6), np.float32)
    previous = tt.set_default_device("meta")
    try:
        data = HOST_ENTRIES[kind](arr)
        tensor_image = tt.ScalarImage(torch.as_tensor(arr))
    finally:
        tt.set_default_device(previous)
    shape = HOST_SHAPES.get(kind, arr.shape)
    assert data.device.type == "meta" and tuple(data.shape[-len(shape):]) == shape
    # a tensor keeps the device its caller chose
    assert tensor_image.device.type == "cpu"


@pytest.mark.parametrize("kind", ["image", "subject", "ndarray", "dict"])
def test_host_data_needs_the_card_unless_the_cpu_is_asked_for(kind):
    """By default host data goes to the card: without one it raises
    PyTorch's error instead of running on the CPU."""
    arr = np.zeros((1, 4, 5, 6), np.float32)
    previous = tt.set_default_device("cuda")
    try:
        assert tt.default_device() == torch.device("cuda")
        if torch.cuda.is_available():
            assert HOST_ENTRIES[kind](arr).device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                HOST_ENTRIES[kind](arr)
    finally:
        tt.set_default_device(previous)
    assert tt.default_device() == torch.device("cpu")


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
