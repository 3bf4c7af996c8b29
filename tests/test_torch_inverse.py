"""Port parity: the inverse machinery and config 4 (ElasticDeformation
forward and inverse) against the JAX package.

BASELINE.json config 4 (``benchmarks/suite.py:197-229``) deforms a
subject with ``ElasticDeformation(max_displacement=7.5)`` and undoes it
with ``apply_inverse_transform()``. Each part runs in both packages from
the same seed on the same numpy volumes (B=4 x 24^3 at 1 mm, or
smaller):

- the registry replay (``get_inverse_transform``): the same inverse
  steps, the same warnings for unknown and non-invertible records,
  ``ignore_intensity`` and each record's include/exclude kept;
- Spatial's inverse (shared and per-element, affine and elastic, both
  orderings): the inverted matrices, negated control points, flipped
  ``affine_first`` and original target; forward images within 1e-5, the
  round trip within 1e-4 (two resamples: the pipeline bound), labels
  equal off near ties of either step;
- BiasField's inverse: within BiasField's rtol 1e-5, atol 1e-6;
- config 4, and the inverses of configs 1 and 2 (fused and unfused):
  within 1e-4, with the JAX package's warnings.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_config3 import (
    assert_images_close,
    assert_labels_equal_off_ties,
    make_batches,
    nearest_ties,
    port_rs,
    spatial_grids,
)
from torchio_tpu import config as jax_config
from torchio_tpu_torch.transforms.spatial import spatial as port_spatial

PIPELINE_ATOL = 1e-4
BIAS_RTOL, BIAS_ATOL = 1e-5, 1e-6
SHAPE = (24, 24, 24)
ISO = (1.0, 1.0, 1.0)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather: its
    opt-in float16 gather (left on for the rest of a process by importing
    ``bench.py``, as ``tests/test_parallel.py`` does) rounds the corner
    values by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


pytestmark = pytest.mark.filterwarnings("ignore:The maximum displacement")


def round_trip(make, seed=7, **batch_kwargs):
    """``make(pkg)`` forward, then ``apply_inverse_transform()``, in both
    packages from one seed: ((jax forward, jax back), (port forward,
    port back), the warnings of each inverse)."""
    batch_kwargs.setdefault("shape", SHAPE)
    batch_kwargs.setdefault("spacing", ISO)
    batch_kwargs.setdefault("channels", 1)
    batches = make_batches(**batch_kwargs)
    outs, caught, draws = [], [], []
    for pkg, batch in zip((tj, tt), batches):
        pkg.seed(seed)
        forward = make(pkg)(batch)
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            back = forward.apply_inverse_transform()
        outs.append((forward, back))
        caught.append([
            (w.category, str(w.message))
            for w in record
            if "maximum displacement" not in str(w.message)
        ])
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1] and caught[0] == caught[1]
    (jax_fwd, _), (port_fwd, port_back) = outs
    assert [(h.name, h.params) for h in jax_fwd.applied_transforms] == [
        (h.name, h.params) for h in port_fwd.applied_transforms
    ]
    assert port_back.applied_transforms == []
    return outs[0], outs[1], caught[1]


def inverse_grids(params, affine, shape):
    """(maps, fields) of the inverse of a recorded Spatial draw, as the
    port's inverse builds them."""
    inverse = tt.Spatial().inverse(params)
    geometry = inverse.per_sample
    n = 1 if geometry is None else len(geometry)
    grids = [
        port_spatial._build_grid(
            input_affine=affine, output_shape=shape, output_affine=affine,
            affine_matrix=inverse.affine_matrix if geometry is None else geometry.affines[i],
            control_points=(
                inverse.control_points if geometry is None else geometry.control_points[i]
            ),
            max_displacement=None, affine_first=inverse.affine_first,
        )
        for i in range(n)
    ]
    return port_rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], "cpu")


def history_of(pkg):
    """A recorded history with an invertible spatial transform, a
    non-invertible one and two intensity transforms, scoped."""
    batch = make_batches(b=2, shape=(10, 11, 12), channels=1)[0 if pkg is tj else 1]
    pkg.seed(0)
    out = pkg.Compose(
        [
            pkg.Flip(axes=(0, 1), flip_probability=1.0, include=["ch"]),
            pkg.Noise(std=0.1),
            pkg.Gamma(log_gamma=(-0.3, 0.3), exclude=["seg"]),
            pkg.Affine(degrees=(5, 10)),
        ]
    )(batch)
    return out.applied_transforms


# --- the base and the mixin ----------------------------------------------------


def test_transform_base_is_not_invertible():
    for pkg in (tj, tt):
        noise = pkg.Noise(std=0.1)
        assert not noise.invertible
        with pytest.raises(NotImplementedError, match="Noise is not invertible"):
            noise.inverse({})
    for name in ("Flip", "Normalize", "Gamma", "BiasField", "Spatial", "Pad", "Crop"):
        assert getattr(tt.transforms.transform._TRANSFORM_REGISTRY[name], "invertible").fget(None)


def test_every_history_carrier_has_the_inverse_entry_points():
    port_batch = make_batches(b=2, shape=(6, 7, 8), channels=1)[1]
    subject = port_batch.unbatch()[0]
    for carrier in (port_batch, port_batch.ch, subject, subject.ch):
        carrier.applied_transforms = ["record"]
        assert carrier.history == ["record"]
        carrier.clear_history()
        assert carrier.history == [] and carrier.applied_transforms == []
        assert len(carrier.get_inverse_transform()) == 0
        assert callable(carrier.apply_inverse_transform)
    assert tt.apply_inverse_transform(object()) is not None


# --- the registry replay ----------------------------------------------------------


@pytest.mark.parametrize("ignore_intensity", [False, True])
def test_get_inverse_transform_matches_jax(ignore_intensity):
    steps, caught = [], []
    for pkg in (tj, tt):
        history = history_of(pkg)
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            inverse = pkg.get_inverse_transform(history, ignore_intensity=ignore_intensity)
        caught.append([(w.category, str(w.message)) for w in record])
        steps.append([(type(t).__name__, t.include, t.exclude, t.copy) for t in inverse])
        assert inverse.copy
    assert steps[0] == steps[1]
    assert caught[0] == caught[1]
    assert [s[0] for s in steps[1]] == (
        ["_SpatialInverse", "_FlipInverse"] if ignore_intensity
        else ["_SpatialInverse", "_GammaInverse", "_FlipInverse"]
    )
    assert ("Noise is not invertible, skipping" in [m for _, m in caught[1]]) != ignore_intensity


def test_unknown_records_warn_as_in_the_jax_package():
    caught = []
    for pkg, module in ((tj, "torchio_tpu"), (tt, "torchio_tpu_torch")):
        record_class = __import__(
            f"{module}.transforms.transform", fromlist=["AppliedTransform"]
        ).AppliedTransform
        history = [record_class("NotATransform", {"x": 1}), record_class("Noise", {})]
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            assert len(pkg.get_inverse_transform(history)) == 0
            assert len(pkg.get_inverse_transform(history, warn=False)) == 0
        caught.append([(w.category, str(w.message)) for w in record])
    # the history is walked from its last record
    assert caught[0] == caught[1] == [
        (UserWarning, "Noise is not invertible, skipping"),
        (UserWarning, "Unknown transform 'NotATransform' in history, skipping"),
    ]


def test_replayed_history_undoes_a_scoped_pipeline():
    (jax_fwd, jax_back), (port_fwd, port_back), caught = round_trip(
        lambda pkg: pkg.Compose(
            [pkg.Flip(axes=(0,), flip_probability=1.0, include=["ch"]),
             pkg.Affine(degrees=(5, 10), exclude=["seg"])]
        ),
        shape=(10, 11, 12),
    )
    assert caught == []
    assert_images_close(jax_back, port_back, atol=PIPELINE_ATOL)
    np.testing.assert_array_equal(port_back.seg.data.numpy(), np.asarray(jax_back.seg.data))


# --- Spatial's inverse -----------------------------------------------------------


SPATIALS = {
    "affine-shared": dict(degrees=(5, 10), scales=(0.9, 1.1), per_instance=False),
    "affine-per-element": dict(degrees=(-10, 10), translation=(-2, 2)),
    "elastic-per-element": dict(max_displacement=(2, 4), num_control_points=6),
    "both-affine-last": dict(
        degrees=(-8, 8), max_displacement=3, affine_first=False, per_instance=False
    ),
    "gated": dict(degrees=(-10, 10), max_displacement=3, p=0.5),
}


def test_spatial_inverse_is_built_from_the_params():
    batch = make_batches(b=3, shape=SHAPE, spacing=ISO, channels=1)[1]
    tt.seed(3)
    transform = tt.Spatial(degrees=(-10, 10), max_displacement=3, affine_first=False)
    params = transform.make_params(batch)
    inverse = transform.inverse(params)
    assert isinstance(inverse, port_spatial._SpatialInverse)
    assert inverse.copy is False and inverse.include == ["ch", "seg"]
    assert inverse.affine_first is True
    assert inverse.target[0] == SHAPE
    np.testing.assert_array_equal(inverse.target[1].data, batch.ch.affines[0].data)
    for i in range(3):
        np.testing.assert_array_equal(
            inverse.per_sample.affines[i], np.linalg.inv(np.asarray(params["affine_matrix"][i]))
        )
        np.testing.assert_array_equal(
            inverse.per_sample.control_points[i],
            -np.asarray(params["control_points"][i], np.float32),
        )
    with pytest.raises(RuntimeError, match="original output space"):
        transform.inverse({**params, "original": None})


@pytest.mark.parametrize("name", list(SPATIALS))
def test_spatial_inverse_matches_jax(name):
    kwargs = SPATIALS[name]
    # seed 0 gates out the first element only
    (jax_fwd, jax_back), (port_fwd, port_back), _ = round_trip(
        lambda pkg: pkg.Spatial(**kwargs), seed=0, b=3
    )
    assert_images_close(jax_fwd, port_fwd)
    assert_images_close(jax_back, port_back, atol=PIPELINE_ATOL)
    params = port_fwd.applied_transforms[0].params
    assert params.get("_keep", [False, True, True]) == [False, True, True]
    affine = tt.AffineMatrix(np.eye(4))
    maps, fields, _ = spatial_grids(params, affine, SHAPE)
    ties = nearest_ties(maps, fields, SHAPE)
    assert_labels_equal_off_ties(jax_fwd, port_fwd, ties)
    maps, fields = inverse_grids(params, affine, SHAPE)
    assert_labels_equal_off_ties(jax_back, port_back, nearest_ties(maps, fields, SHAPE, ties))


def test_inverse_of_a_resample_returns_to_the_original_space():
    (jax_fwd, jax_back), (port_fwd, port_back), _ = round_trip(
        lambda pkg: pkg.Resample(target=(1.5, 0.8, 2.0), image_interpolation="cubic"),
        shape=(12, 14, 10), spacing=(1.0, 1.0, 2.0), b=2,
    )
    assert tuple(port_back.ch.data.shape) == (2, 1, 12, 14, 10)
    assert_images_close(jax_fwd, port_fwd)
    assert_images_close(jax_back, port_back, atol=PIPELINE_ATOL)
    np.testing.assert_array_equal(
        port_back.ch.affines[0].data, np.diag([1.0, 1.0, 2.0, 1.0])
    )


# --- BiasField's inverse ----------------------------------------------------------


@pytest.mark.parametrize("per_instance", [True, False], ids=["per-element", "shared"])
def test_bias_field_inverse_matches_jax(per_instance):
    (jax_fwd, jax_back), (port_fwd, port_back), _ = round_trip(
        lambda pkg: pkg.BiasField(std=0.5, per_instance=per_instance, p=0.7),
        shape=(10, 11, 12), b=3,
    )
    for jax_out, port_out in ((jax_fwd, port_fwd), (jax_back, port_back)):
        np.testing.assert_allclose(
            port_out.ch.data.numpy(), np.asarray(jax_out.ch.data), rtol=BIAS_RTOL, atol=BIAS_ATOL
        )
    original = make_batches(b=3, shape=(10, 11, 12), channels=1)[1].ch.data
    np.testing.assert_allclose(port_back.ch.data.numpy(), original.numpy(), rtol=1e-5, atol=1e-6)


# --- config 4 -----------------------------------------------------------------------


def config4(pkg):
    return pkg.ElasticDeformation(max_displacement=7.5)


@pytest.mark.parametrize("seed", [0, 1])
def test_config4_matches_jax(seed):
    (jax_fwd, jax_back), (port_fwd, port_back), caught = round_trip(config4, seed=seed)
    assert caught == []
    assert_images_close(jax_fwd, port_fwd, atol=PIPELINE_ATOL)
    assert_images_close(jax_back, port_back, atol=PIPELINE_ATOL)
    params = port_fwd.applied_transforms[0].params
    affine = tt.AffineMatrix(np.eye(4))
    maps, fields, _ = spatial_grids(params, affine, SHAPE)
    ties = nearest_ties(maps, fields, SHAPE)
    maps, fields = inverse_grids(params, affine, SHAPE)
    assert_labels_equal_off_ties(jax_back, port_back, nearest_ties(maps, fields, SHAPE, ties))
    # the suite's interior label consistency, here with a 4-voxel margin
    seg = make_batches(shape=SHAPE, spacing=ISO, channels=1)[1].seg.data.numpy()
    interior = (slice(None), slice(None), *(slice(4, -4),) * 3)
    consistency = (port_back.seg.data.numpy()[interior] == seg[interior]).mean()
    forward = (port_fwd.seg.data.numpy()[interior] == seg[interior]).mean()
    assert consistency > forward


def test_config4_inverse_on_subjects_and_image_batches():
    """The inverse of one subject (sliced per-element history) and of an
    ImagesBatch follows the batch's."""
    _, port_batch = make_batches(b=2, shape=SHAPE, spacing=ISO, channels=1)
    tt.seed(2)
    forward = config4(tt)(port_batch)
    back = forward.apply_inverse_transform()
    subject = forward.unbatch()[1]
    assert subject.history[0].name == "ElasticDeformation"
    subject_back = subject.apply_inverse_transform()
    np.testing.assert_array_equal(subject_back.ch.data.numpy(), back.ch.data[1].numpy())
    np.testing.assert_array_equal(subject_back.seg.data.numpy(), back.seg.data[1].numpy())
    images = port_batch.ch
    tt.seed(2)
    warped = tt.ElasticDeformation(max_displacement=7.5, per_instance=False)(images)
    restored = warped.apply_inverse_transform()
    assert isinstance(restored, tt.ImagesBatch) and restored.applied_transforms == []
    assert restored.data.shape == images.data.shape


# --- the inverses of configs 1 and 2 --------------------------------------------


def config1(pkg, fuse):
    return pkg.Compose(
        [
            pkg.Flip(axes=(0,), flip_probability=0.5),
            pkg.Noise(std=0.1),
            pkg.RescaleIntensity(out_min=0.0, out_max=1.0),
        ],
        fuse=fuse,
    )


def config2(pkg, fuse):
    return pkg.Compose(
        [
            pkg.Blur(std=(0.5, 1.5)),
            pkg.BiasField(std=0.5),
            pkg.Gamma(log_gamma=(-0.3, 0.3)),
        ],
        fuse=fuse,
    )


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("config", [config1, config2], ids=["config1", "config2"])
def test_inverse_of_configs_1_and_2_matches_jax(config, fuse):
    (jax_fwd, jax_back), (port_fwd, port_back), caught = round_trip(
        lambda pkg: config(pkg, fuse), shape=(10, 11, 12), b=3, seed=4, labels=False,
    )
    skipped = "Noise" if config is config1 else "Blur"
    assert caught == [(UserWarning, f"{skipped} is not invertible, skipping")]
    for jax_out, port_out in ((jax_fwd, port_fwd), (jax_back, port_back)):
        np.testing.assert_allclose(
            port_out.ch.data.numpy(), np.asarray(jax_out.ch.data), rtol=BIAS_RTOL,
            atol=PIPELINE_ATOL,
        )


def test_inverse_of_config1_undoes_the_flip_per_element():
    """Without the noise, config 1's inverse gives the input back where
    the rescale did not clip it (the input range is the first
    element's): each element is flipped back along its own axes."""
    _, batch = make_batches(b=4, shape=(10, 11, 12), channels=1, labels=False)
    tt.seed(6)
    pipeline = tt.Compose(
        [tt.Flip(axes=(0, 1), flip_probability=0.5), tt.RescaleIntensity(out_min=0.0, out_max=1.0)],
        fuse=True,
    )
    forward = pipeline(batch)
    flips = forward.applied_transforms[0].params["axes"]
    assert len({tuple(a) for a in flips}) > 1
    back = forward.apply_inverse_transform()
    low, high = forward.applied_transforms[1].params["in_ranges"]["ch"]
    original = batch.ch.data.numpy()
    kept = (original >= low) & (original <= high)
    assert kept.mean() > 0.99
    np.testing.assert_allclose(back.ch.data.numpy()[kept], original[kept], rtol=1e-6, atol=1e-6)


@pytest.mark.filterwarnings("ignore:Padding statistic")  # seg is int32
def test_inverse_of_crop_or_pad_on_a_batch_matches_jax():
    (jax_fwd, jax_back), (port_fwd, port_back), caught = round_trip(
        lambda pkg: pkg.CropOrPad((18, 30, 20), padding_mode="median"),
        shape=(10, 11, 24), b=2,
    )
    assert caught == []
    for image in ("ch", "seg"):
        np.testing.assert_array_equal(
            port_back.images[image].data.numpy(), np.asarray(jax_back.images[image].data)
        )
    assert tuple(port_back.ch.data.shape) == (2, 1, 10, 11, 24)
    assert [h.name for h in port_fwd.applied_transforms] == ["Pad", "Crop"]
