"""Port parity: Swap, PCA, HistogramStandardization, LabelsToImage, Lambda
and To against the JAX package, and the two paths of this part of the
zoo at a small size.

The same numpy volumes go through ``torchio_tpu`` and
``torchio_tpu_torch`` on the CPU from one seed:

- Swap equal (a pair that overlaps, chains of swaps, per-instance,
  batch-wide and gated elements), its locations, history and the next
  host draw equal;
- PCA within 1e-5, with the JAX package's eigenvector signs: the
  port's eigendecomposition equals ``jnp.linalg.eigh`` bit for bit on
  200 random float32 grams, and the projections of 50 random images
  agree;
- HistogramStandardization: landmarks equal (``np.percentile`` on the
  host), the output within 1e-6;
- LabelsToImage within 1e-6 (the threefry normals, as in
  ``tests/test_torch_random.py``), one draw a label that is not skipped;
- Lambda and To equal; ``To`` with a ``torch.dtype``, a numpy dtype and
  a dtype name;
- synthseg-labels-to-image within 1e-5, and ixi-preprocess-histstd
  within 1e-4 (its linear Resample of intensities in the hundreds, see
  IXI_ATOL); BASELINE.json's 1e-3 is the paths' outer bound.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
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
    oblique,
    volumes,
)
from torchio_tpu import config as jax_config
from torchio_tpu_torch.transforms.intensity import pca as port_pca

PCA_ATOL = 1e-5
HISTOGRAM_ATOL = 1e-6
NORMAL_ATOL = 1e-6
PATH_ATOL = 1e-5
#: ixi-preprocess-histstd's bound: Resample's linear values at MR
#: intensities (hundreds; a float32 ulp of 3e-5 at 256) agree with the
#: JAX package's to about 1e-6 relative, and the histogram mapping and
#: the z-normalisation carry that to about 2e-5 (2.1e-5 measured); the
#: pipeline bound of ``tests/test_torch_config3.py``
IXI_ATOL = 1e-4


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather (see
    ``tests/test_torch_config3.py``)."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def count_normals(monkeypatch):
    """Count the port's threefry normal draws (one launch each on a card)."""
    calls = []
    original = tt.random.normal

    def counting(key, shape, device=None):
        calls.append(tuple(shape))
        return original(key, shape, device)

    monkeypatch.setattr(tt.random, "normal", counting)
    return calls


# --- Swap -------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs, shape",
    [
        (dict(patch_size=4, num_iterations=6), (12, 14, 10)),
        (dict(patch_size=(5, 3, 4), num_iterations=(2, 9), p=0.5), (12, 14, 10)),
        (dict(patch_size=3, num_iterations=5, per_instance=False), (12, 14, 10)),
        # patches as large as half the volume: pairs overlap after 100 tries
        (dict(patch_size=(5, 5, 5), num_iterations=4), (8, 8, 8)),
    ],
)
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_swap(kwargs, shape, dtype):
    images = {
        "t1": ("scalar", volumes(shape=shape, dtype=dtype, channels=2)),
        "seg": ("label", block_labels(shape=shape)),
    }
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        # seed 0 gates the middle and last elements in and the first out
        jax_out, port_out = both(lambda pkg: pkg.Swap(**kwargs), images, seed=0)
    assert any("LabelMap" in str(w.message) for w in caught)
    assert_images(jax_out, port_out)
    params = port_out.applied_transforms[0].params
    assert params["patch_size"] == list(tt.Swap(**kwargs).patch_size)
    per_element = params["locations"]
    if "_batched_keys" not in params:
        per_element = [per_element] * 3
    size = params["patch_size"]
    for e, locations in enumerate(per_element):
        if not locations:  # a gated element is left as it is
            assert not params["_keep"][e]
            np.testing.assert_array_equal(port_out.t1.data[e].numpy(), images["t1"][1][e])
    if shape == (8, 8, 8):
        assert any(tj.transforms.intensity.swap._overlap(a, b, size)
                   for locations in per_element for a, b in locations)


def test_swap_chain_order():
    """Swaps run in sequence and chain; where a pair overlaps, the
    overlap ends up holding the first patch (the JAX package's order)."""
    from torchio_tpu.transforms.intensity.swap import _swap_kernel
    from torchio_tpu_torch.transforms.intensity.swap import swap_patches

    data = np.arange(2 * 1 * 6 * 6 * 6, dtype=np.float32).reshape(2, 1, 6, 6, 6)
    a = np.array([[[0, 0, 0], [2, 2, 2], [1, 1, 1]], [[0, 0, 0], [3, 3, 3], [0, 0, 0]]])
    b = np.array([[[1, 1, 1], [0, 0, 0], [3, 3, 3]], [[3, 3, 3], [1, 1, 1], [0, 0, 0]]])
    want = np.asarray(_swap_kernel(jnp.asarray(data), jnp.asarray(a, jnp.int32),
                                   jnp.asarray(b, jnp.int32), (3, 3, 3)))
    got = swap_patches(torch.as_tensor(data), a, b, (3, 3, 3)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, data)


def test_swap_errors():
    images = {"t1": ("scalar", volumes(shape=(6, 6, 6)))}
    messages = []
    for pkg, batch in zip((tj, tt), batches(images)):
        pkg.seed(0)
        with pytest.raises(ValueError) as err:
            pkg.Swap(patch_size=7)(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[1].startswith("Patch size (7, 7, 7) cannot be larger than spatial shape")


# --- PCA --------------------------------------------------------------------------


def random_grams(count, channels, seed):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        x = rng.standard_normal((64, channels)).astype(np.float32)
        x = x * rng.random(channels).astype(np.float32) * 4
        yield (x.T @ x).astype(np.float32)


def test_pca_eigh_matches_jax():
    for gram in random_grams(200, 4, seed=0):
        values, vectors = port_pca.gram_eigh(gram)
        want_values, want_vectors = jnp.linalg.eigh(jnp.asarray(gram))
        np.testing.assert_array_equal(values, np.asarray(want_values))
        np.testing.assert_array_equal(vectors, np.asarray(want_vectors))


@pytest.mark.parametrize("seed", range(50))
def test_pca_signs(seed):
    """50 random 4-channel images: the port's projection agrees with
    JAX's (a flipped eigenvector would flip a component)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((1, 4, 5, 6, 4)).astype(np.float32)
    data[:, 1] += 0.5 * data[:, 0]
    jax_out, port_out = both(
        lambda pkg: pkg.PCA(num_components=3, clip=False), {"t1": ("scalar", data)}
    )
    assert_images(jax_out, port_out, atol=PCA_ATOL)


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(num_components=2, whiten=False), dict(normalize=False, values_range=(-1, 1))],
)
def test_pca(kwargs):
    images = {"feat": ("scalar", volumes(channels=5)), "seg": ("label", block_labels())}
    jax_out, port_out = both(lambda pkg: pkg.PCA(**kwargs), images)
    assert_images(jax_out, port_out, atol=PCA_ATOL)


def test_pca_errors():
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match="num_components must be >= 1, got 0"):
            pkg.PCA(num_components=0)
    messages = []
    for pkg, batch in zip((tj, tt), batches({"t1": ("scalar", volumes(channels=2))})):
        with pytest.raises(ValueError) as err:
            pkg.PCA()(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[1].startswith("Image has 2 channels but num_components=3")


# --- HistogramStandardization -----------------------------------------------------


def corpus(count=4, shape=(10, 12, 8), seed=9):
    """Volumes of skewed intensities (a gamma law), as MR histograms are."""
    rng = np.random.default_rng(seed)
    return [(rng.gamma(2.0, 30.0, (1, *shape))).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("cutoff", [(0.01, 0.99), (0.05, 0.95)])
def test_histogram_landmarks(cutoff, tmp_path):
    volumes_ = corpus()
    mask = lambda x: x > 20  # noqa: E731  (host arrays in both packages)
    want = tj.compute_histogram_landmarks(volumes_, cutoff=cutoff, masking_method=mask)
    sources = [tt.ScalarImage(volumes_[0]), torch.as_tensor(volumes_[1]), *volumes_[2:]]
    got = tt.compute_histogram_landmarks(sources, cutoff=cutoff, masking_method=mask)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    custom = [0.0, 0.5, 1.0, 0.5]
    np.testing.assert_array_equal(
        tt.compute_histogram_landmarks(volumes_, quantiles=custom),
        tj.compute_histogram_landmarks(volumes_, quantiles=custom),
    )
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match="Need at least 2 quantiles, got 1"):
            pkg.compute_histogram_landmarks(volumes_, quantiles=[0.5])
        with pytest.raises(ValueError, match=r"Quantiles must be in \[0, 1\]"):
            pkg.compute_histogram_landmarks(volumes_, quantiles=[0.5, 1.5])
    # the landmark sources: array, list, tensor, .npy, .pt
    np.save(tmp_path / "lm.npy", want)
    torch.save(torch.as_tensor(want), tmp_path / "lm.pt")
    torch.save({"lm": torch.as_tensor(want)}, tmp_path / "bad.pth")
    for source in (want, list(want), torch.as_tensor(want), tmp_path / "lm.npy",
                   str(tmp_path / "lm.pt")):
        np.testing.assert_array_equal(tt.HistogramStandardization(source).landmarks, want)
    for pkg in (tj, tt):
        with pytest.raises(TypeError, match="Expected a tensor in"):
            pkg.HistogramStandardization(tmp_path / "bad.pth")
        with pytest.raises(ValueError, match="Unsupported landmarks source"):
            pkg.HistogramStandardization(tmp_path / "lm.txt")


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_histogram_standardization(dtype):
    landmarks = tj.compute_histogram_landmarks(corpus())
    data = np.stack(corpus(3, seed=2)).astype(dtype)
    data[2] = data[2].max()  # a constant element: every segment is flat
    images = {"t1": ("scalar", data), "t2": ("scalar", data[::-1].copy()),
              "seg": ("label", block_labels(shape=(10, 12, 8)))}
    jax_out, port_out = both(
        lambda pkg: pkg.HistogramStandardization(landmarks, include=["t1"]), images
    )
    assert port_out.t1.data.dtype == torch.float32
    assert_images(jax_out, port_out, atol=HISTOGRAM_ATOL)
    messages = []
    for pkg, batch in zip((tj, tt), batches(images)):
        with pytest.raises(ValueError) as err:
            pkg.HistogramStandardization(landmarks[:-1])(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[1].startswith("Number of landmarks (12) does not match")


# --- LabelsToImage ----------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs, labels",
    [
        (dict(label_key="seg"), (0, 1, 2, 4)),
        # the background's all-zero means and stds skip its draw and split
        (dict(ignore_background=True, per_instance=False), (0, 1, 2, 4)),
        (dict(mean=[(0.2, 0.3), 0.5], std=[0.0, (0.1, 0.2)], image_key="synth"), (0, 3, 7)),
        (dict(ignore_background=True, mean=[0.0, 0.0], std=[0.0, 0.0]), (0, 1, 2)),
    ],
)
def test_labels_to_image(kwargs, labels, monkeypatch):
    images = {"t1": ("scalar", volumes()), "seg": ("label", block_labels(labels=labels))}
    draws = count_normals(monkeypatch)
    jax_out, port_out = both(lambda pkg: pkg.LabelsToImage(**kwargs), images)
    assert_images(jax_out, port_out, atol=NORMAL_ATOL)
    params = port_out.applied_transforms[0].params
    means = params["means"] if "_batched_keys" in params else [params["means"]]
    stds = params["stds"] if "_batched_keys" in params else [params["stds"]]
    drawn = [
        label for label in sorted(means[0])
        if any(m[label] for m in means) or any(s[label] for s in stds)
    ]
    assert len(draws) == len(drawn) and all(d == (3, 1, *volumes().shape[2:]) for d in draws)
    if kwargs.get("ignore_background"):
        assert 0 not in drawn
        seg = torch.as_tensor(images["seg"][1])
        assert bool((port_out.images[kwargs.get("image_key", "image_from_labels")]
                     .data[seg == 0] == 0).all())


def test_labels_to_image_replayed_history():
    """The means and stds read back from a JSON history (string keys)."""
    import json

    images = {"seg": ("label", block_labels())}
    jax_out, port_out = both(lambda pkg: pkg.LabelsToImage(), images)
    params = json.loads(json.dumps(port_out.applied_transforms[0].params))
    _, batch = batches(images)
    replayed = tt.LabelsToImage().apply_transform(batch, params)
    assert torch.equal(replayed.image_from_labels.data, port_out.image_from_labels.data)


def test_labels_to_image_errors():
    images = {"t1": ("scalar", volumes())}
    for key, message in ((None, "No LabelMap found in the subject"),
                         ("seg", "Label key 'seg' not found")):
        for pkg, batch in zip((tj, tt), batches(images)):
            with pytest.raises(KeyError, match=message):
                pkg.LabelsToImage(label_key=key)(batch)


# --- Lambda and To ----------------------------------------------------------------


def test_lambda():
    images = {"t1": ("scalar", volumes()), "seg": ("label", block_labels())}

    def double(x):
        return x * 2

    jax_out, port_out = both(
        lambda pkg: pkg.Lambda(double, types_to_apply=[pkg.LabelMap]), images
    )
    assert_images(jax_out, port_out)
    np.testing.assert_array_equal(port_out.seg.data.numpy(), 2 * images["seg"][1])
    np.testing.assert_array_equal(port_out.t1.data.numpy(), images["t1"][1])
    for pkg, batch in zip((tj, tt), batches(images)):
        with pytest.raises(ValueError, match="Lambda function must return a 4D"):
            pkg.Lambda(lambda x: x[0])(batch)


@pytest.mark.parametrize(
    "args, want",
    [
        ((torch.float16,), torch.float16),
        ((np.float16,), torch.float16),
        (("float64",), torch.float64),
        (("cpu",), torch.float32),
        (("cpu", torch.float16), torch.float16),
        ((None, "int32"), torch.int32),
    ],
)
def test_to(args, want):
    transform = tt.To(*args)
    assert transform.copy is False
    _, batch = batches({"t1": ("scalar", volumes())})
    out = transform(batch)
    assert out is batch
    assert out.t1.data.dtype == want and out.t1.data.device.type == "cpu"
    np.testing.assert_array_equal(
        out.t1.data.to(torch.float64).numpy(),
        volumes().astype(want_numpy(want)).astype(np.float64),
    )


def want_numpy(dtype):
    return {torch.float16: np.float16, torch.float64: np.float64,
            torch.float32: np.float32, torch.int32: np.int32}[dtype]


# --- the two paths at a small size ------------------------------------------------


def synthseg(pkg):
    """synthseg-labels-to-image."""
    return pkg.Compose([
        pkg.Spatial(scales=(0.9, 1.1), degrees=10, max_displacement=7.5),
        pkg.LabelsToImage(label_key="seg"),
        pkg.BiasField(std=0.5),
        pkg.Gamma(log_gamma=(-0.3, 0.3)),
        pkg.Anisotropy(downsampling=(1.5, 5)),
        pkg.Noise(std=0.05),
        pkg.RescaleIntensity(out_min=0.0, out_max=1.0),
    ])


def ixi_preprocess(pkg, landmarks):
    """ixi-preprocess-histstd."""
    return pkg.Compose([
        pkg.Reorient("RAS"),
        pkg.Resample(target=1.0),
        pkg.CropOrPad((16, 16, 12)),
        pkg.HistogramStandardization(landmarks, include=["t1"]),
        pkg.ZNormalization(include=["t1"]),
        pkg.OneHot(),
    ])


def test_synthseg_path(monkeypatch):
    """Label maps that Spatial moves only by whole voxels (no rotation,
    scale 1, no displacement) so that the nearest resample has no ties."""
    shape = (16, 18, 14)
    idx = np.indices(shape)
    seg = ((idx[0] // 4) * 4 + (idx[1] // 6) * 2 + idx[2] // 7).astype(np.int32)
    images = {"seg": ("label", np.stack([seg[None]] * 2))}

    def make(pkg):
        pipeline = synthseg(pkg)
        pipeline.transforms[0] = pkg.Spatial(translation=(1, -2, 1))
        return pipeline

    draws = count_normals(monkeypatch)
    jax_out, port_out = both(make, images, seed=5)
    assert [h.name for h in port_out.applied_transforms] == [
        "Spatial", "LabelsToImage", "BiasField", "Gamma", "Anisotropy", "Noise", "Normalize"
    ]
    assert_images(jax_out, port_out, atol=PATH_ATOL)
    # one draw a label, then Noise's (BiasField draws through ``normals``)
    assert len(draws) == len(np.unique(seg)) + 1


def test_ixi_preprocess_path():
    shape = (18, 20, 10)
    rng = np.random.default_rng(3)
    t1 = rng.gamma(2.0, 30.0, (2, 1, *shape)).astype(np.float32)
    seg = block_labels(b=2, shape=shape, labels=(0, 1, 2, 4), block=4)
    landmarks = tj.compute_histogram_landmarks(corpus(4, shape))
    affine = oblique(spacing=(0.9375, 0.9375, 1.2), codes="LPS", perm=(1, 2, 0))
    images = {"t1": ("scalar", t1), "seg": ("label", seg)}
    jax_out, port_out = both(lambda pkg: ixi_preprocess(pkg, landmarks), images, affine=affine)
    names = [h.name for h in port_out.applied_transforms]
    assert names[:2] == ["Reorient", "Resample"] and names[-3:] == [
        "HistogramStandardization", "Standardize", "OneHot"
    ]
    assert_images(jax_out, port_out, atol=IXI_ATOL)
    assert "".join(port_out.t1.affines[0].orientation) == "RAS"
    assert port_out.seg.data.shape[1] == 5


# --- exports ----------------------------------------------------------------------


def test_exports():
    """Every public transform of the JAX package has its port, but the
    adapters to other libraries (MONAI, Cornucopia), which are not ported;
    the package exports the transforms' names too."""
    import torchio_tpu.transforms as jax_transforms
    import torchio_tpu_torch.transforms as port_transforms

    missing = set(jax_transforms.__all__) - set(port_transforms.__all__)
    assert missing == {"MonaiAdapter", "CornucopiaAdapter"}
    for name in port_transforms.__all__:
        assert getattr(port_transforms, name) is getattr(tt, name, None) or name in (
            "IntensityTransform", "SpatialTransform", "Transform",
        ), name
    assert {"RescaleIntensity", "ZNormalization", "AppliedTransform"} <= set(tt.__all__)
