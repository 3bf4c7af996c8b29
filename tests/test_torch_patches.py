"""Port parity: the patch layer's pieces against the JAX package.

The same numpy-seeded volumes go through ``torchio_tpu`` (its device
branch: every image a ``jnp`` array) and ``torchio_tpu_torch`` on the CPU:

- ``PatchLocation``, ``normalize_index`` and the Image region read (data
  and affine equal);
- GridSampler's locations (patch larger than the volume, overlap at least
  the patch, the end snap, every padding mode) and ``get_batch``, bit for
  bit with affines and metadata;
- the Uniform, Weighted and Label samplers' corners for one seed: equal on
  0/1 maps, dyadic and other label weights and a float probability map
  (the CDF is summed in XLA:CPU's order, bit for bit with
  ``jnp.cumsum`` at every length up to 256^3);
- ``extract_patches(_multi)``, ``RingPatchBuffer`` (push, wrap-around,
  over-capacity truncation, ``gather``, ``sample`` against
  ``_ring_sample_kernel``) and ``random.key_randint`` against
  ``jax.random.randint``, all equal.
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
from torchio_tpu.io.backends import normalize_index as jax_normalize_index
from torchio_tpu.ops import patches as jax_patches
from torchio_tpu_torch import random as tr
from torchio_tpu_torch.data.image import normalize_index
from torchio_tpu_torch.ops import patches as port_patches

SHAPE = (20, 18, 22)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build images from numpy and compare on the CPU: ask the
    port to put host data there (its default is the card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def volumes(seed=0, shape=SHAPE, channels=1):
    """A float32 volume in [0, 1) and an int32 block label map (labels 0,
    1 and 2) of ``shape``."""
    rng = np.random.default_rng(seed)
    t1 = rng.random((channels, *shape), np.float32)
    seg = np.zeros((1, *shape), np.int32)
    i, j, k = (s // 4 for s in shape)
    seg[0, i:-i, j:-j, k:-k] = 1
    seg[0, i : 2 * i, j : 2 * j, k : 2 * k] = 2
    return t1, seg


def subject_pair(seed=0, shape=SHAPE, affine=None, **metadata):
    """The same subject in both packages: the JAX one on ``jnp`` arrays
    (its device branch), the port's on CPU tensors."""
    t1, seg = volumes(seed, shape)
    if affine is None:
        affine = np.diag([1.5, 0.8, 2.0, 1.0])
        affine[:3, 3] = (-10.25, 3.5, 7.0)
    pair = []
    for pkg, conv in ((tj, jnp.asarray), (tt, torch.as_tensor)):
        pair.append(
            pkg.Subject(
                t1=pkg.ScalarImage(conv(t1), affine=affine),
                seg=pkg.LabelMap(conv(seg), affine=affine),
                **metadata,
            )
        )
    return pair


def assert_batches_equal(jax_batch, port_batch, names=("t1", "seg")):
    """Data equal bit for bit, affines equal, metadata equal (locations
    by their JSON)."""
    for name in names:
        got = port_batch.images[name]
        want = jax_batch.images[name]
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert got.data.numpy().dtype == np.asarray(want.data).dtype
        assert got.image_class.__name__ == want.image_class.__name__
        for a, b in zip(got.affines, want.affines, strict=True):
            np.testing.assert_array_equal(a.data, np.asarray(b.data))
    assert set(port_batch.metadata) == set(jax_batch.metadata)
    for key, values in jax_batch.metadata.items():
        if key == "patch_location":
            values = [loc.to_json() for loc in values]
            got = [loc.to_json() for loc in port_batch.metadata[key]]
        else:
            got = port_batch.metadata[key]
        assert got == values


# --- PatchLocation, normalize_index, region reads ---------------------------


@pytest.mark.parametrize("subject_index", [None, 3])
def test_patch_location_round_trips(subject_index):
    loc = tt.PatchLocation((2, 5, 7), (4, 6, 8), subject_index)
    ref = tj.PatchLocation((2, 5, 7), (4, 6, 8), subject_index)
    assert tt.PatchLocation.from_json(loc.to_json()) == loc
    assert loc.to_json() == ref.to_json()
    assert loc.to_slices() == ref.to_slices()
    assert (loc.index_ini, loc.index_fin) == (ref.index_ini, ref.index_fin)
    assert loc.scaled((0.5, 2.0, 1.25)).to_json() == ref.scaled((0.5, 2.0, 1.25)).to_json()


INDICES = [
    0,
    -1,
    (0, slice(2, 9)),
    (Ellipsis, 3),
    (slice(None), Ellipsis, slice(-5, None)),
    (0, -2, slice(1, 8, 2), np.int64(4)),
    (slice(None), slice(None, None, -1)),
    (),
]


@pytest.mark.parametrize("index", INDICES, ids=[str(i) for i in range(len(INDICES))])
def test_normalize_index_matches_jax(index):
    shape = (2, *SHAPE)
    assert normalize_index(index, shape) == jax_normalize_index(index, shape)


@pytest.mark.parametrize(
    "index, message",
    [
        ((0, 0, 0, 0, 0), "Too many indices"),
        ((Ellipsis, 0, Ellipsis), "single ellipsis"),
        ((0, 30), "out of range"),
        ((0, -21), "out of range"),
        ((0, [1, 2]), "Unsupported index type"),
    ],
)
def test_normalize_index_raises_as_jax(index, message):
    shape = (2, *SHAPE)
    with pytest.raises(IndexError, match=message) as port_error:
        normalize_index(index, shape)
    with pytest.raises(IndexError) as jax_error:
        jax_normalize_index(index, shape)
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize(
    "index",
    [
        (slice(None), slice(3, 11), slice(0, 6), slice(9, 22)),
        (0, 4, Ellipsis),
        (Ellipsis, slice(-7, -2)),
    ],
    ids=["box", "ints", "negative"],
)
def test_image_region_read_matches_jax(index):
    jax_subject, port_subject = subject_pair(seed=1)
    for name in ("t1", "seg"):
        got = port_subject[name][index]
        want = jax_subject[name][index]
        assert type(got).__name__ == type(want).__name__
        assert got.data.ndim == 4
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.affine.data, np.asarray(want.affine.data))
        assert got.affine.data.dtype == np.float64


def test_image_region_read_is_a_view_on_the_data_device():
    _, port_subject = subject_pair()
    region = port_subject.t1[:, 2:6, 1:4, 0:5]
    assert region.data.device == port_subject.t1.data.device
    assert region.data.untyped_storage().data_ptr() == (
        port_subject.t1.data.untyped_storage().data_ptr()
    )
    port_subject.t1["tag"] = "meta"
    assert port_subject.t1["tag"] == "meta"
    assert port_subject.t1[:, 0:1]["tag"] == "meta"


def test_load_and_unload_keep_in_memory_data():
    _, subject = subject_pair()
    before = subject.t1.data
    subject.load()
    subject.unload()
    subject.t1.load()
    assert subject.t1.data is before


def test_new_like_keeps_class_metadata_and_takes_new_data():
    image = tt.LabelMap(torch.zeros(1, 4, 4, 4, dtype=torch.int32), label="x")
    new = image.new_like(data=torch.ones(1, 2, 2, 2, dtype=torch.int32), extra=5)
    assert isinstance(new, tt.LabelMap)
    assert (new["label"], new["extra"]) == ("x", 5)
    assert new.spatial_shape == (2, 2, 2)
    np.testing.assert_array_equal(new.affine.data, image.affine.data)
    assert image.new_like().data is image.data


# --- GridSampler -------------------------------------------------------------

GRIDS = {
    "plain": dict(patch_size=8),
    "overlap": dict(patch_size=(8, 6, 10), patch_overlap=(4, 2, 3)),
    "end-snap": dict(patch_size=7, patch_overlap=1),
    "patch-larger-than-volume": dict(patch_size=(24, 8, 30)),
    "overlap-at-least-patch": dict(patch_size=6, patch_overlap=(6, 9, 5)),
    "pad-constant": dict(patch_size=8, patch_overlap=4, padding_mode="constant", fill=0.5),
    "pad-reflect": dict(patch_size=8, patch_overlap=(4, 2, 6), padding_mode="reflect"),
    "pad-replicate": dict(patch_size=8, patch_overlap=4, padding_mode="replicate"),
    "pad-circular": dict(patch_size=8, patch_overlap=4, padding_mode="circular"),
    "pad-minimum": dict(patch_size=8, patch_overlap=4, padding_mode="minimum"),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_sampler_matches_jax(name):
    jax_subject, port_subject = subject_pair(seed=2, sid=7)
    kwargs = GRIDS[name]
    port = tt.GridSampler(port_subject, **kwargs)
    ref = tj.GridSampler(jax_subject, **kwargs)
    assert [loc.to_json() for loc in port.locations] == [
        loc.to_json() for loc in ref.locations
    ]
    assert port.subject.spatial_shape == ref.subject.spatial_shape
    if "larger" not in name:  # a patch past the volume cannot be sliced
        indices = [0, len(ref) // 2, len(ref) - 1]
        assert_batches_equal(ref.get_batch(indices), port.get_batch(indices))
        single = port[len(port) - 1]
        want = ref[len(ref) - 1]
        np.testing.assert_array_equal(single.t1.data.numpy(), np.asarray(want.t1.data))
        np.testing.assert_array_equal(single.t1.affine.data, np.asarray(want.t1.affine.data))
        assert single.patch_location.to_json() == want.patch_location.to_json()
        assert single.metadata["sid"] == 7


# --- random samplers ---------------------------------------------------------


def corners_of(pkg, sampler_factory, subject, n, seed):
    pkg.seed(seed)
    return [loc.index for loc in sampler_factory(pkg).sample_locations(subject, n)]


SAMPLERS = {
    "uniform": lambda pkg: pkg.UniformSampler(patch_size=(6, 8, 5)),
    "label": lambda pkg: pkg.LabelSampler(patch_size=6, label_name="seg"),
    "label-odd-patch": lambda pkg: pkg.LabelSampler(patch_size=(5, 7, 9), label_name="seg"),
    "label-dyadic": lambda pkg: pkg.LabelSampler(
        patch_size=6, label_name="seg", label_probabilities={0: 0.25, 1: 0.5, 2: 1.0}
    ),
    "weighted-01": lambda pkg: pkg.WeightedSampler(patch_size=4, probability_map="seg"),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
@pytest.mark.parametrize("seed", [0, 5])
def test_random_sampler_corners_match_jax(name, seed):
    jax_subject, port_subject = subject_pair(seed=3)
    want = corners_of(tj, SAMPLERS[name], jax_subject, 40, seed)
    got = corners_of(tt, SAMPLERS[name], port_subject, 40, seed)
    assert got == want
    if name.startswith("label") and "dyadic" not in name:
        for corner in got:  # LabelSampler's contract: labelled centres
            centre = [c + p // 2 for c, p in zip(corner, SAMPLERS[name](tt).patch_size)]
            assert port_subject.seg.data[0][tuple(centre)] > 0


NON_DYADIC = {
    "label": lambda pkg: pkg.LabelSampler(
        patch_size=6, label_name="seg", label_probabilities={0: 0.1, 1: 0.3, 2: 0.7}
    ),
    "weighted-t1": lambda pkg: pkg.WeightedSampler(patch_size=(5, 6, 7), probability_map="t1"),
}


@pytest.mark.parametrize("name", list(NON_DYADIC))
def test_samplers_non_dyadic_weights_equal_jax(name):
    """Every corner equal: the port sums its CDF in XLA:CPU's order (with
    ``torch.cumsum`` instead, 9-12 of these 2,000 corners differ)."""
    jax_subject, port_subject = subject_pair(seed=4, shape=(64, 64, 64))
    want = corners_of(tj, NON_DYADIC[name], jax_subject, 2000, 9)
    got = corners_of(tt, NON_DYADIC[name], port_subject, 2000, 9)
    assert got == want


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 13824, 100000, 256**3])
def test_cdf_equals_jnp_cumsum_bit_for_bit(n):
    """``xla_cumsum`` against ``jnp.cumsum`` on non-dyadic float32 weights,
    every length, the zero padding of a partial block and 16^6 included."""
    from torchio_tpu_torch.data.sampler import xla_cumsum

    rng = np.random.default_rng(n)
    weights = rng.choice(np.array([0.1, 0.3, 0.7], np.float32), n)
    weights[rng.random(n) < 0.25] = rng.random(1, np.float32)[0]
    want = np.asarray(jnp.cumsum(jnp.asarray(weights)))
    got = xla_cumsum(torch.from_numpy(weights)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("iterate", [False, True])
def test_weighted_sampler_all_zero_map_raises(iterate):
    for pkg, conv in ((tj, jnp.asarray), (tt, torch.as_tensor)):
        subject = pkg.Subject(t1=pkg.ScalarImage(conv(np.zeros((1, 8, 8, 8), np.float32))))
        sampler = pkg.WeightedSampler(subject, patch_size=4, probability_map="t1", num_patches=2)
        with pytest.raises(RuntimeError, match="'t1' is all zeros"):
            if iterate:
                list(sampler)
            else:
                sampler.sample_locations(subject, 2)


@pytest.mark.parametrize("name", ["uniform", "label", "weighted-01"])
def test_iterating_a_sampler_matches_jax(name):
    jax_subject, port_subject = subject_pair(seed=6, tag="a")
    out = {}
    for pkg, subject in ((tj, jax_subject), (tt, port_subject)):
        pkg.seed(11)
        sampler = SAMPLERS[name](pkg)
        sampler.subject, sampler.num_patches = subject, 5
        out[pkg] = list(sampler)
    assert len(out[tt]) == 5
    for want, got in zip(out[tj], out[tt], strict=True):
        assert got.patch_location.to_json() == want.patch_location.to_json()
        np.testing.assert_array_equal(got.t1.data.numpy(), np.asarray(want.t1.data))
        np.testing.assert_array_equal(got.seg.affine.data, np.asarray(want.seg.affine.data))
        assert got.metadata["tag"] == "a"
    assert isinstance(SAMPLERS[name](tt), torch.utils.data.IterableDataset)
    assert not isinstance(tt.GridSampler(port_subject, 8), torch.utils.data.IterableDataset)


def test_sampler_argument_errors_match_jax():
    for pkg in (tj, tt):
        with pytest.raises(TypeError, match="patch_size is required"):
            pkg.UniformSampler()
        with pytest.raises(TypeError, match="probability_map is required"):
            pkg.WeightedSampler(patch_size=4)
        with pytest.raises(TypeError, match="label_name is required"):
            pkg.LabelSampler(patch_size=4)
        with pytest.raises(RuntimeError, match="needs a subject"):
            iter(pkg.UniformSampler(patch_size=4))
        with pytest.raises(NotImplementedError):
            pkg.PatchSampler(4).sample_locations(None, 1)


# --- ops.patches -------------------------------------------------------------

CORNERS = np.array([[0, 0, 0], [3, 7, 2], [12, 10, 14], [0, 10, 0]], np.int32)


def test_extract_patches_matches_jax():
    t1, seg = volumes(seed=7, channels=2)
    got = port_patches.extract_patches(torch.as_tensor(t1), CORNERS, (8, 8, 8))
    want = jax_patches.extract_patches(jnp.asarray(t1), CORNERS, (8, 8, 8))
    assert got.shape == (4, 2, 8, 8, 8) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    multi = port_patches.extract_patches_multi(
        [torch.as_tensor(t1), torch.as_tensor(seg)], CORNERS[1:3], (4, 5, 6)
    )
    ref = jax_patches.extract_patches_multi([jnp.asarray(t1), jnp.asarray(seg)], CORNERS[1:3], (4, 5, 6))
    for a, b in zip(multi, ref, strict=True):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def ring_pair(capacity, patch_shape=(1, 3, 3, 3), dtype=np.float32):
    return (
        jax_patches.RingPatchBuffer(capacity, patch_shape, dtype),
        port_patches.RingPatchBuffer(capacity, patch_shape, torch.from_numpy(np.zeros(0, dtype)).dtype),
    )


@pytest.mark.parametrize(
    "pushes", [(3,), (3, 4), (5, 5, 2), (9,), (2, 11)], ids=lambda p: "-".join(map(str, p))
)
def test_ring_buffer_push_gather_sample_match_jax(pushes):
    rng = np.random.default_rng(sum(pushes))
    ref, port = ring_pair(6)
    for n in pushes:
        block = rng.random((n, 1, 3, 3, 3), np.float32)
        ref.push(jnp.asarray(block))
        port.push(torch.as_tensor(block))
        assert port.filled == ref.filled
    np.testing.assert_array_equal(port._buffer.numpy(), np.asarray(ref._buffer))
    rows = [0, 5, 2, 2]
    np.testing.assert_array_equal(port.gather(rows).numpy(), np.asarray(ref.gather(rows)))
    for seed in (0, 17, 2**31 - 2):
        np.testing.assert_array_equal(
            port.sample(7, seed=seed).numpy(), np.asarray(ref.sample(7, seed=seed))
        )


def test_ring_buffer_over_capacity_keeps_the_latest_rows_in_order():
    _, port = ring_pair(4, (1,))
    port.push(torch.arange(3, dtype=torch.float32)[:, None])
    port.push(torch.arange(10, 16, dtype=torch.float32)[:, None])
    # the push of 6 rows keeps its last 4 (12-15), written from the
    # cursor (row 3) on, wrapping to rows 0-2
    assert port._buffer[:, 0].tolist() == [13.0, 14.0, 15.0, 12.0]
    assert port.filled == 4


def test_ring_buffer_errors_match_jax():
    ref, port = ring_pair(4)
    for ring in (ref, port):
        with pytest.raises(RuntimeError, match="empty"):
            ring.sample(2, seed=0)
        with pytest.raises(RuntimeError, match="empty"):
            ring.gather([0])
    with pytest.raises(ValueError, match="does not match buffer"):
        port.push(torch.zeros(2, 1, 3, 3, 4))
    tt.seed(3)
    port.push(torch.ones(2, 1, 3, 3, 3))
    assert port.sample(5).shape == (5, 1, 3, 3, 3)


SPANS = [
    (0, 1),
    (0, 2),
    (0, 64),
    (0, 2**20),
    (0, 2**30),
    (0, 3),
    (0, 1000),
    (0, 65537),
    (-7, 12),
    (0, 2**31 - 1),
    (-(2**31), 2**31 - 1),
    (5, 5),
    (9, 2),
]


@pytest.mark.parametrize("minval, maxval", SPANS, ids=[f"{a}..{b}" for a, b in SPANS])
def test_key_randint_matches_jax(minval, maxval):
    for seed in (0, 42, 2**31 - 1):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (131,), minval, maxval))
        got = tr.key_randint(tr.prng_key(seed), (131,), minval, maxval, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (131,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_key_randint_shapes_and_errors():
    key = tr.prng_key(1)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (3, 5), 0, 9))
    np.testing.assert_array_equal(tr.key_randint(key, (3, 5), 0, 9, device="cpu").numpy(), want)
    assert tr.key_randint(key, (0,), 0, 9, device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="int32"):
        tr.key_randint(key, (2,), 0, 2**31, device="cpu")
