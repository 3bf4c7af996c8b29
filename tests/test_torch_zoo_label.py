"""Port parity: RemapLabels, RemoveLabels, SequentialLabels, OneHot, Contour
and KeepLargestComponent against the JAX package.

The same numpy label maps (B=3 x 12x14x10 blocks, or islands for
KeepLargestComponent) go through ``torchio_tpu`` and
``torchio_tpu_torch`` on the CPU from one seed: data and dtype equal,
affines, history and the next host draw equal; the inverses of
RemapLabels, SequentialLabels and OneHot replayed from the history
(``apply_inverse_transform``) equal; the batch-wide p gate from seeds
that apply and skip; the JAX package's error messages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_zoo_spatial import (
    assert_images,
    batches,
    block_labels,
    both,
    inverses,
    volumes,
)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def label_images(dtype=np.int32, labels=(0, 1, 2, 4)):
    return {
        "t1": ("scalar", volumes()),
        "seg": ("label", block_labels(labels=labels).astype(dtype)),
    }


# --- RemapLabels and RemoveLabels -------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_remap_labels_and_its_inverse(dtype, seed):
    images = label_images(dtype)
    jax_out, port_out = both(
        lambda pkg: pkg.RemapLabels({1: 3, 2: 5, 4: 1}, p=0.6), images, seed=seed
    )
    assert_images(jax_out, port_out)
    applied = bool(port_out.applied_transforms)
    assert applied == (seed == 1)  # these seeds gate in and out
    if applied:
        assert set(np.unique(port_out.seg.data.numpy())) == {0, 1, 3, 5}
        jax_back, port_back = inverses(jax_out, port_out)
        assert_images(jax_back, port_back)
        np.testing.assert_array_equal(port_back.seg.data.numpy(), images["seg"][1])


def test_remove_labels():
    images = label_images()
    jax_out, port_out = both(
        lambda pkg: pkg.RemoveLabels([2, 4], background_label=7), images
    )
    assert_images(jax_out, port_out)
    assert set(np.unique(port_out.seg.data.numpy())) == {0, 1, 7}


# --- SequentialLabels -------------------------------------------------------------


def test_sequential_labels_and_its_inverse():
    seg = block_labels(labels=(0, 3, 8, 20))
    seg[1, 0, :2] = 40  # a label the first element lacks collapses to 0
    images = {"t1": ("scalar", volumes()), "seg": ("label", seg)}
    jax_out, port_out = both(lambda pkg: pkg.SequentialLabels(), images)
    assert_images(jax_out, port_out)
    assert port_out.applied_transforms[0].params == {
        "remappings": {"seg": {0: 0, 3: 1, 8: 2, 20: 3}}
    }
    assert set(np.unique(port_out.seg.data.numpy())) == {0, 1, 2, 3}
    jax_back, port_back = inverses(jax_out, port_out)
    assert_images(jax_back, port_back)


# --- OneHot -----------------------------------------------------------------------


@pytest.mark.parametrize(
    "num_classes, labels",
    [
        (-1, (0, 1, 2, 4)),
        (3, (0, 1, 2, 4)),  # label 4 >= num_classes: a row of zeros
        (5, (-1, 0, 2, 4)),  # a negative label: a row of zeros
    ],
)
def test_one_hot_and_its_inverse(num_classes, labels):
    images = label_images(labels=labels)
    jax_out, port_out = both(lambda pkg: pkg.OneHot(num_classes=num_classes), images)
    assert_images(jax_out, port_out)
    data = port_out.seg.data
    n = 5 if num_classes == -1 else num_classes
    assert data.dtype == torch.float32 and data.shape[1] == n
    outside = torch.as_tensor((images["seg"][1] < 0) | (images["seg"][1] >= n))
    assert bool(outside.any()) == (num_classes != -1)
    assert torch.equal(data.sum(dim=1, keepdim=True), (~outside).to(torch.float32))
    jax_back, port_back = inverses(jax_out, port_out)
    assert_images(jax_back, port_back)
    assert port_back.seg.data.dtype == torch.float32


# --- Contour ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_contour(dtype):
    seg = np.concatenate([block_labels(labels=(0, 1, 2, 4), block=4)] * 2, axis=1)
    images = {"t1": ("scalar", volumes()), "seg": ("label", seg.astype(dtype))}
    jax_out, port_out = both(lambda pkg: pkg.Contour(), images)
    assert_images(jax_out, port_out)  # the scalar image is left as it is
    assert 0 < float(port_out.seg.data.mean()) < 1


# --- KeepLargestComponent ---------------------------------------------------------


def islands(b=3, shape=(16, 14, 12)):
    """(B, 1, *shape) int32 blocks of labels 1-3 on 0, each label with a
    stray island elsewhere, one that touches its block only by a corner
    (joined under 26-connectivity, apart under 6)."""
    seg = np.zeros((b, 1, *shape), np.int32)
    for e in range(b):
        seg[e, 0, 1:6, 1:6, 1:5] = 1
        seg[e, 0, 8:14, 2:7, 1:6] = 2
        seg[e, 0, 2:7, 8:13, 6:11] = 3
        seg[e, 0, 14 - e, 12, 10] = 1  # a single-voxel island
        seg[e, 0, 6, 6, 5] = 2 if e != 1 else 0  # corner contact with label 1's block
        seg[e, 0, 10:12, 10:12, 9:11] = 2  # label 2's island
    return seg


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        dict(fully_connected=False),
        dict(labels=[2]),
        dict(background_label=9),
    ],
)
def test_keep_largest_component(kwargs):
    images = {"t1": ("scalar", volumes(shape=(16, 14, 12))), "seg": ("label", islands())}
    jax_out, port_out = both(lambda pkg: pkg.KeepLargestComponent(**kwargs), images)
    got = port_out.seg.data
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert_images(jax_out, port_out)
    assert not np.array_equal(got.numpy(), images["seg"][1])


def test_keep_largest_component_error():
    seg = np.concatenate([islands()] * 2, axis=1)
    messages = []
    for pkg, batch in zip((tj, tt), batches({"seg": ("label", seg)})):
        with pytest.raises(RuntimeError) as err:
            pkg.KeepLargestComponent()(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[1] == "KeepLargestComponent requires single-channel label maps, got 2 channels"
