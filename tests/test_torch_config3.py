"""Port parity: config 3 (Affine + Resample to 1 mm) and its modules
against the JAX package.

BASELINE.json config 3 (``benchmarks/suite.py:169-194``) is
``Compose([Affine(scales=(0.9, 1.1), degrees=(-10, 10)),
Resample(target=1.0)], copy=False)`` on 4-channel images with a label
map at 1x1x2 mm. Each new module runs in both packages from the same
seed on the same numpy volumes (B=4 x 20x22x12 at 1x1x2 mm, or smaller):

- target spaces (``_compute_new_shape_affine``, ``_parse_spacing``,
  ``_resolve_target_space`` for every kind of target): shapes and
  affines equal; a file path raises ``NotImplementedError``;
- Resample and Spatial(target=...): images within 1e-5
  (``tests/test_ops_resample.py:330-356`` holds the JAX package's
  separable path against its gather at 1e-5, and the port gathers),
  labels equal off near ties (a coordinate within 1e-4 of .5), params
  and the next host draw equal;
- the "mean" and "otsu" fills equal bit for bit (float64 on the host);
- antialias: the sigmas equal, images within 1e-5;
- Pad, Crop, CropOrPad, EnsureShapeMultiple: outputs, affines, history
  and warnings equal; Pad's "mean" within rtol 1e-6 (a float32 mean
  whose sum order differs), its median equal;
- config 3 within 1e-4 (the pipeline bound), labels equal off near ties.
"""

from __future__ import annotations

import copy
import importlib
import warnings

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from torchio_tpu.data.batch import SubjectsBatch as JaxBatch
from torchio_tpu.transforms.spatial import _padding as jax_padding
from torchio_tpu.transforms.spatial import spatial as jax_spatial
from torchio_tpu_torch.transforms.spatial import _padding as port_padding
from torchio_tpu_torch.transforms.spatial import spatial as port_spatial

port_rs = importlib.import_module("torchio_tpu_torch.ops.resample")

RESAMPLE_ATOL = 1e-5
PIPELINE_ATOL = 1e-4
TIE_BAND = 1e-4
SPACING = (1.0, 1.0, 2.0)
SHAPE = (20, 22, 12)
CHANNELS = 4


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


def suite_labels(shape, block=4):
    """(1, *shape) int32 labels (i // block + j // block + k // block) % 4,
    the block-structured maps of ``benchmarks/suite.py:61-68`` at a small
    block."""
    idx = np.indices(shape)
    return ((idx // block).sum(axis=0) % 4).astype(np.int32)[None]


def make_batches(b=4, shape=SHAPE, spacing=SPACING, channels=CHANNELS, seed=0,
                 name="ch", labels=True, dtype=np.float32):
    """The same numpy volumes as a JAX batch and a port batch: a ScalarImage
    ``name`` of ``channels`` channels (floats in [0, 1), integers in [0,
    100)) and an int32 LabelMap ``seg``, at ``spacing`` mm."""
    rng = np.random.default_rng(seed)
    affine = np.diag([*spacing, 1.0])
    scale = 1.0 if np.issubdtype(dtype, np.floating) else 100.0  # floats in [0, 1)
    arrays = [(rng.random((channels, *shape)) * scale).astype(dtype) for _ in range(b)]
    seg = suite_labels(shape)
    out = []
    for pkg, batch_class in ((tj, JaxBatch), (tt, tt.SubjectsBatch)):
        subjects = []
        for a in arrays:
            images = {name: pkg.ScalarImage(a.copy(), affine=affine)}
            if labels:
                images["seg"] = pkg.LabelMap(seg.copy(), affine=affine)
            subjects.append(pkg.Subject(**images))
        out.append(batch_class.from_subjects(subjects))
    return tuple(out)


def run_both(make, seed=7, fuse=False, copy_batch=False, **batch_kwargs):
    """``make(pkg)`` in both packages from one seed: outputs with equal
    history params and the same next host draw."""
    batches = make_batches(**batch_kwargs)
    outs, draws = [], []
    for pkg, batch in zip((tj, tt), batches):
        transform = make(pkg)
        if fuse:
            transform = pkg.Compose([transform], fuse=True)
        pkg.seed(seed)
        outs.append(transform(copy.deepcopy(batch) if copy_batch else batch))
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1]
    jax_out, port_out = outs
    assert [(h.name, h.params) for h in jax_out.applied_transforms] == [
        (h.name, h.params) for h in port_out.applied_transforms
    ]
    return jax_out, port_out


def nearest_ties(maps, fields, out_shape, earlier=None):
    """(B, 1, *out) True where a nearest label may differ from the JAX
    package's: a port coordinate within TIE_BAND of .5 (XLA contracts the
    coordinate sums into FMAs), or a read of a voxel that was a tie of
    the step before (``earlier``)."""
    ties = []
    for b in range(maps.shape[0]):
        near = torch.zeros(out_shape, dtype=torch.bool)
        for c in port_rs._element_coords(maps, fields, b, out_shape):
            near |= torch.abs(c - torch.floor(c) - 0.5) <= TIE_BAND
        ties.append(near)
    ties = torch.stack(ties)[:, None]
    if earlier is not None:
        fill, _ = port_rs._fill_bc(0.0, maps.shape[0], 1, "cpu")
        read = port_rs.resample_plain(
            earlier.float(), maps, fields, fill, out_shape, "nearest", False
        )
        ties |= read > 0
    return ties


def spatial_grids(params, affine, in_shape):
    """(maps, fields, out_shape) of a recorded Spatial draw, per element
    or shared, with or without a target."""
    space = port_spatial._deserialize_space(params["target"])
    out_shape, out_affine = space if space is not None else (in_shape, affine)
    per_element = "_batched_keys" in params
    n = len(params["affine_matrix"]) if per_element else 1
    grids = [
        port_spatial._build_grid(
            input_affine=affine, output_shape=out_shape, output_affine=out_affine,
            affine_matrix=params["affine_matrix"][i] if per_element else params["affine_matrix"],
            control_points=(
                params["control_points"][i] if per_element else params["control_points"]
            ),
            max_displacement=None, affine_first=params["affine_first"],
        )
        for i in range(n)
    ]
    maps, fields = port_rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], "cpu")
    return maps, fields, tuple(out_shape)


def assert_images_close(jax_out, port_out, name="ch", atol=RESAMPLE_ATOL):
    want = np.asarray(jax_out.images[name].data)
    got = port_out.images[name].data.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for a, b in zip(jax_out.images[name].affines, port_out.images[name].affines):
        np.testing.assert_array_equal(a.data, b.data)


def assert_labels_equal_off_ties(jax_out, port_out, ties):
    want = np.asarray(jax_out.seg.data)
    got = port_out.seg.data.numpy()
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    assert not ((got != want) & ~ties.numpy()).any()


# --- host draws ------------------------------------------------------------------


def test_randint_and_choice_equal_the_jax_packages():
    for pkg in (tj, tt):
        pkg.seed(5)
    assert int(tt.random.randint(0, 17)) == int(tj.random.randint(0, 17))
    np.testing.assert_array_equal(tt.random.randint(3, 9, 6), tj.random.randint(3, 9, 6))
    np.testing.assert_array_equal(
        tt.random.choice([0.5, 1.0, 2.0], size=4, p=[0.2, 0.3, 0.5]),
        tj.random.choice([0.5, 1.0, 2.0], size=4, p=[0.2, 0.3, 0.5]),
    )
    assert float(tt.random.random()) == float(tj.random.random())


# --- target spaces ---------------------------------------------------------------


def _spaces(target, seed=3):
    """The resolved (shape, affine) of ``target`` in both packages."""
    jax_batch, port_batch = make_batches(b=1)
    first_shape = SHAPE
    out = []
    for pkg, module, batch in ((tj, jax_spatial, jax_batch), (tt, port_spatial, port_batch)):
        pkg.seed(seed)
        spec = target(pkg) if callable(target) else target
        affine = batch.ch.affines[0]
        out.append(module._resolve_target_space(spec, batch, first_shape, affine))
        out.append(float(pkg.random.random()))
    (jax_space, jax_draw, port_space, port_draw) = out
    assert jax_draw == port_draw
    return jax_space, port_space


TARGETS = {
    "number": 1.0,
    "int": 3,
    "triple": (0.7, 1.3, 1.9),
    "list": [1.5],
    "array": np.array([0.8, 1.0, 2.5]),
    "range": (0.8, 1.6),
    "choice": lambda pkg: pkg.Choice([0.75, 1.25, 2.0]),
    "name": "seg",
    "shape-affine": ((11, 9, 30), np.diag([1.5, 2.0, 0.75, 1.0])),
    "image": lambda pkg: pkg.ScalarImage(
        np.zeros((1, 9, 8, 7), np.float32), affine=np.diag([2.0, 2.5, 1.5, 1.0])
    ),
}


@pytest.mark.parametrize("name", list(TARGETS))
def test_target_spaces_equal_the_jax_packages(name):
    jax_space, port_space = _spaces(TARGETS[name])
    assert tuple(port_space[0]) == tuple(jax_space[0])
    assert all(isinstance(s, int) for s in port_space[0])
    np.testing.assert_array_equal(port_space[1].data, jax_space[1].data)


def test_target_distribution_draws_as_the_jax_package():
    """A distribution draws from its own generator in both packages."""
    import scipy.stats

    def distribution(pkg):
        dist = scipy.stats.uniform(0.6, 1.2)
        dist.random_state = np.random.default_rng(8)
        return dist

    jax_space, port_space = _spaces(distribution)
    assert tuple(port_space[0]) == tuple(jax_space[0])
    np.testing.assert_array_equal(port_space[1].data, jax_space[1].data)


@pytest.mark.parametrize(
    "spacing", [2.0, (1.0,), (0.5, 1.5, 3.0), np.array([1.25, 1.25, 1.25])]
)
def test_new_shape_affine_and_spacing_parse_equal_the_jax_packages(spacing):
    rotation = np.eye(4)
    rotation[:3, :3] = jax_spatial._euler_rotation([10.0, -5.0, 20.0]) * [1.0, 1.2, 2.0]
    rotation[:3, 3] = [-30.0, 12.0, 4.5]
    for shape in ((20, 22, 12), (20, 22, 1)):
        parsed = port_spatial._parse_spacing(
            spacing if not isinstance(spacing, np.ndarray) else tuple(spacing)
        )
        assert parsed == jax_spatial._parse_spacing(
            spacing if not isinstance(spacing, np.ndarray) else tuple(spacing)
        )
        got = port_spatial._compute_new_shape_affine(shape, tt.AffineMatrix(rotation), parsed)
        want = jax_spatial._compute_new_shape_affine(shape, tj.AffineMatrix(rotation), parsed)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1].data, want[1].data)


def test_bad_targets_raise_as_in_the_jax_package(tmp_path):
    path = tmp_path / "reference.nii.gz"
    path.write_bytes(b"not read")
    _, port_batch = make_batches(b=1)
    affine = port_batch.ch.affines[0]
    for target in (str(path), path):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_spatial._resolve_target_space(target, port_batch, SHAPE, affine)
    with pytest.raises(ValueError, match="Unknown target"):
        port_spatial._resolve_target_space("t2", port_batch, SHAPE, affine)
    with pytest.raises(ValueError, match="positive"):
        port_spatial._parse_spacing((1.0, 0.0, 1.0))
    with pytest.raises(ValueError, match="1 or 3 values"):
        port_spatial._parse_spacing((1.0, 2.0))
    assert not port_spatial._is_target_space_tuple(((1, 2, 3), np.eye(3)))


# --- Resample and Spatial(target=...) --------------------------------------------


RESAMPLES = {
    "1mm": dict(target=1.0),
    "coarser": dict(target=(2.0, 1.5, 2.5)),
    "finer-cubic": dict(target=0.75, image_interpolation="bspline"),
    "linear-labels": dict(target=(0.8, 1.1, 1.7), label_interpolation="linear"),
    "label-mode": dict(target=1.3, label_interpolation="label"),
    "to-image-name": dict(target="seg"),
    "mean-fill": dict(target=1.0, default_pad_value="mean"),
}


@pytest.mark.parametrize("name", list(RESAMPLES))
def test_resample_matches_jax(name):
    kwargs = RESAMPLES[name]
    jax_out, port_out = run_both(lambda pkg: pkg.Resample(**kwargs))
    assert_images_close(jax_out, port_out)
    params = port_out.applied_transforms[0].params
    maps, fields, out_shape = spatial_grids(params, tt.AffineMatrix(np.diag([*SPACING, 1])), SHAPE)
    interpolation = kwargs.get("label_interpolation", "nearest")
    if interpolation == "nearest":
        ties = nearest_ties(maps, fields, out_shape)
    elif interpolation == "linear":
        # linear labels truncate to int32: a value within TIE_BAND of an
        # integer may land on either side
        seg = torch.as_tensor(suite_labels(SHAPE)).float().expand(4, 1, *SHAPE)
        fill, _ = port_rs._fill_bc(0.0, 4, 1, "cpu")
        values = port_rs.resample_plain(seg, maps, fields, fill, out_shape, "linear", False)
        ties = torch.abs(values - torch.round(values)) <= TIE_BAND
    else:
        ties = torch.zeros((4, 1, *out_shape), dtype=torch.bool)
    assert_labels_equal_off_ties(jax_out, port_out, ties)


@pytest.mark.parametrize("per_instance", [True, False], ids=["per-element", "shared"])
def test_spatial_with_a_target_and_geometry_matches_jax(per_instance):
    def make(pkg):
        return pkg.Spatial(
            target=(1.25, 0.9, 1.5), scales=(0.9, 1.1), degrees=(-10, 10),
            max_displacement=(0, 2), per_instance=per_instance, p=0.6,
        )

    transform = make(tt)
    assert not transform.supports_per_instance_p
    jax_out, port_out = run_both(make, seed=11)
    assert_images_close(jax_out, port_out)
    params = port_out.applied_transforms[0].params
    assert "_keep" not in params
    maps, fields, out_shape = spatial_grids(params, tt.AffineMatrix(np.diag([*SPACING, 1])), SHAPE)
    assert_labels_equal_off_ties(jax_out, port_out, nearest_ties(maps, fields, out_shape))


def test_a_target_resamples_every_element_and_records_the_target():
    """With a target there is no passthrough: an element without geometry
    is resampled into the target space too, and every output takes the
    target's affine."""
    jax_out, port_out = run_both(
        lambda pkg: pkg.Spatial(target=1.0, degrees=(0, 0), scales=(1, 1)), seed=2
    )
    assert_images_close(jax_out, port_out)
    target = port_out.applied_transforms[0].params["target"]
    assert target["shape"] == [20, 22, 24]
    for affine in port_out.ch.affines + port_out.seg.affines:
        np.testing.assert_array_equal(affine.data, np.asarray(target["affine"]))


@pytest.mark.parametrize("fill", ["mean", "otsu"])
def test_border_fills_equal_the_jax_packages(fill):
    jax_batch, port_batch = make_batches(b=3, channels=2, seed=4)
    want = jax_spatial._batch_fill_value(
        jax_batch.ch, default_pad_value=fill, default_pad_label=0
    )
    got = port_spatial._batch_fill_value(
        port_batch.ch, default_pad_value=fill, default_pad_label=0
    )
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert port_spatial._otsu_threshold(np.array([3.0])) == 3.0
    assert port_spatial._otsu_threshold(np.array([])) == 0.0


@pytest.mark.parametrize("fill", ["mean", "otsu", 7.5])
def test_affine_with_border_fills_matches_jax(fill):
    jax_out, port_out = run_both(
        lambda pkg: pkg.Affine(degrees=(20, 30), scales=(0.6, 0.7), default_pad_value=fill),
        seed=3, labels=False,
    )
    assert_images_close(jax_out, port_out)


def test_unknown_fills_raise():
    with pytest.raises(ValueError, match="Unknown default_pad_value"):
        tt.Spatial(default_pad_value="median")


# --- antialias --------------------------------------------------------------------


@pytest.mark.parametrize(
    "factors", [(1.0, 2.0, 0.5), (3.0, 3.0, 1.5), (0.9, 1.0, 1.0)]
)
def test_antialias_sigmas_equal_the_jax_packages(factors):
    np.testing.assert_array_equal(
        port_spatial._antialias_sigmas(factors, (1.0, 1.0, 2.0)),
        jax_spatial._antialias_sigmas(factors, (1.0, 1.0, 2.0)),
    )


@pytest.mark.parametrize("labels", ["nearest", "label"])
def test_antialiased_downsample_matches_jax(labels):
    jax_out, port_out = run_both(
        lambda pkg: pkg.Resample(
            target=(2.5, 3.0, 2.0), antialias=True, label_interpolation=labels
        ),
        seed=5,
    )
    assert_images_close(jax_out, port_out)
    got, want = port_out.seg.data.numpy(), np.asarray(jax_out.seg.data)
    assert got.dtype == want.dtype and got.shape == want.shape
    if labels == "nearest":
        params = port_out.applied_transforms[0].params
        maps, fields, out_shape = spatial_grids(
            params, tt.AffineMatrix(np.diag([*SPACING, 1])), SHAPE
        )
        assert_labels_equal_off_ties(jax_out, port_out, nearest_ties(maps, fields, out_shape))
    else:
        # the blurred one-hot vote: equal off near-equal top scores
        assert (got != want).mean() <= 0.01


def test_antialiased_labels_take_the_one_hot_path(monkeypatch):
    """A one-channel label map in "label" mode with non-zero antialias
    sigmas bypasses the corner vote; without smoothing it takes it."""
    calls = []
    original = port_spatial.resample_label_fused
    monkeypatch.setattr(
        port_spatial, "resample_label_fused",
        lambda *a, **k: calls.append(1) or original(*a, **k),
    )
    _, port_batch = make_batches(b=1, channels=1)
    tt.Resample(target=(2.5, 3.0, 2.0), antialias=True, label_interpolation="label")(port_batch)
    assert calls == []
    tt.Resample(target=(1.0, 1.0, 2.0), antialias=True, label_interpolation="label")(port_batch)
    assert calls == [1]


# --- Pad and Crop ----------------------------------------------------------------


PADS = {
    "constant": dict(padding=(1, 2, 0, 3, 2, 1), padding_mode="constant", fill=1.7),
    "reflect-wide": dict(padding=(23, 1, 0, 30, 2, 13), padding_mode="reflect"),
    "replicate": dict(padding=3, padding_mode="replicate"),
    "circular-wide": dict(padding=(25, 0, 1, 1, 13, 26), padding_mode="circular"),
    "mean": dict(padding=(2, 2, 1, 1, 0, 0), padding_mode="mean"),
    "median": dict(padding=(1, 0, 2), padding_mode="median"),
    "minimum": dict(padding=(0, 0, 0, 0, 4, 5), padding_mode="minimum"),
}


@pytest.mark.parametrize("dtype", [np.float32, np.int16], ids=["float32", "int16"])
@pytest.mark.parametrize("name", list(PADS))
def test_pad_matches_jax(name, dtype):
    kwargs = PADS[name]
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        jax_out, port_out = run_both(lambda pkg: pkg.Pad(**kwargs), dtype=dtype, b=2, channels=2)
    want = np.asarray(jax_out.ch.data)
    got = port_out.ch.data.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if name == "mean" and dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))
    for a, b in zip(jax_out.ch.affines, port_out.ch.affines):
        np.testing.assert_array_equal(a.data, b.data)
    # each package warns once for each integer image (seg is int32)
    # padded with a mean or a median
    messages = [str(w.message) for w in record if "Padding statistic" in str(w.message)]
    per_package = (name in ("mean", "median")) * (1 + (dtype == np.int16))
    assert len(messages) == 2 * per_package


@pytest.mark.parametrize("mode", ["mean", "median"])
def test_pad_statistic_warnings_equal_the_jax_packages(mode):
    data = (np.random.default_rng(1).random((2, 1, 5, 6, 7)) * 50).astype(np.int32)
    caught, outs = [], []
    cases = ((jax_padding.pad_tensor, data), (port_padding.pad_tensor, torch.as_tensor(data)))
    for pad, x in cases:
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            outs.append(np.asarray(pad(x, (1, 1, 1, 1, 1, 1), mode, 0)))
        caught.append([(w.category, str(w.message)) for w in record])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert caught[0] == caught[1] and caught[0][0][0] is RuntimeWarning


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_pad_keeps_wide_unsigned_types(dtype):
    """uint16 and uint32 keep their type through every mode; the float32
    mean of uint32 values past 2^24 is within one float32 ulp."""
    rng = np.random.default_rng(2)
    x = (rng.random((2, 1, 4, 5, 6)) * 60000).astype(dtype)
    if dtype == "uint32":
        x += np.uint32(3_000_000_000)
    wide = torch.from_numpy(x.astype(np.int64)).to(getattr(torch, dtype))
    for mode in port_padding.PADDING_MODES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = np.asarray(jax_padding.pad_tensor(x, (1, 1, 2, 2, 1, 0), mode, 3))
            got = port_padding.pad_tensor(wide, (1, 1, 2, 2, 1, 0), mode, 3)
        assert got.dtype == wide.dtype
        got = got.to(torch.int64).numpy()
        ulp = np.spacing(np.float32(want.max())) if mode == "mean" else 0
        np.testing.assert_allclose(got, want.astype(np.int64), rtol=0, atol=ulp)


@pytest.mark.parametrize("rows", [1, 2, 7, 64])
def test_median_rows_equal_jnp_quantile(rows):
    import jax.numpy as jnp
    from torchio_tpu_torch.transforms._statistics import median_rows

    rng = np.random.default_rng(rows)
    data = (rng.standard_normal((3, rows)) * 1e3).astype(np.float32)
    data[1] = np.round(data[1])  # ties
    want = np.asarray(jnp.quantile(data, 0.5, axis=1))
    np.testing.assert_array_equal(median_rows(torch.as_tensor(data)).numpy(), want)
    data[2, 0] = np.nan
    assert np.isnan(median_rows(torch.as_tensor(data)).numpy()[2])


def test_pad_tensor_refuses_what_jnp_pad_refuses():
    with pytest.raises(ValueError):
        port_padding.pad_tensor(torch.zeros(1, 2, 2, 2), (0, -1, 0, 0, 0, 0), "constant", 0)
    with pytest.raises(ValueError, match="4D or 5D"):
        port_padding.pad_tensor(torch.zeros(2, 2, 2), (1,) * 6, "constant", 0)
    with pytest.raises(ValueError, match="padding_mode"):
        tt.Pad(padding=1, padding_mode="wrap")


@pytest.mark.parametrize("cropping", [(1, 2, 0, 3, 2, 1), 2, (0, 5, 1)])
def test_crop_matches_jax_and_pad_undoes_it(cropping):
    jax_out, port_out = run_both(lambda pkg: pkg.Crop(cropping=cropping), b=2)
    np.testing.assert_array_equal(port_out.ch.data.numpy(), np.asarray(jax_out.ch.data))
    for a, b in zip(jax_out.seg.affines, port_out.seg.affines):
        np.testing.assert_array_equal(a.data, b.data)
    inverse = tt.Crop(cropping=cropping).inverse(port_out.applied_transforms[0].params)
    assert isinstance(inverse, tt.Pad) and inverse.copy is False
    restored = inverse(port_out)
    original = make_batches(b=2)[1]
    assert restored.ch.data.shape == original.ch.data.shape
    np.testing.assert_array_equal(restored.ch.affines[0].data, original.ch.affines[0].data)
    with pytest.raises(ValueError, match="removes all"):
        tt.Crop(cropping=(10, 10, 0, 0, 0, 0))(original)


# --- CropOrPad and EnsureShapeMultiple --------------------------------------------


CROP_OR_PADS = {
    "mixed": dict(target_shape=(16, 30, 12)),
    "none-axis": dict(target_shape=(25, None, 9)),
    "mm": dict(target_shape=(18.0, 20.0, 30.0), units="mm"),
    "cm": dict(target_shape=2.4, units="cm"),
    "only-crop": dict(target_shape=(16, 30, 15), only_crop=True),
    "only-pad": dict(target_shape=(16, 30, 15), only_pad=True),
    "random": dict(target_shape=(13, 15, 7), location="random"),
    "reflect": dict(target_shape=(31, 8, 40), padding_mode="reflect"),
    "minimum-include": dict(target_shape=(24, 24, 14), padding_mode="minimum",
                            include=["ch"]),
}


@pytest.mark.parametrize("name", list(CROP_OR_PADS))
def test_crop_or_pad_batch_path_matches_jax(name):
    kwargs = CROP_OR_PADS[name]
    jax_out, port_out = run_both(lambda pkg: pkg.CropOrPad(**kwargs), b=2)
    for image in ("ch", "seg"):
        np.testing.assert_array_equal(
            port_out.images[image].data.numpy(), np.asarray(jax_out.images[image].data)
        )
        for a, b in zip(jax_out.images[image].affines, port_out.images[image].affines):
            np.testing.assert_array_equal(a.data, b.data)
    names = [h.name for h in port_out.applied_transforms]
    assert "CropOrPad" not in names and set(names) <= {"Pad", "Crop"}


def _subjects(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    data = rng.random((2, *shape), np.float32)
    seg = suite_labels(shape)
    affine = np.diag([*SPACING, 1.0])
    affine[:3, 3] = [3.0, -2.0, 7.5]
    return [
        pkg.Subject(
            ch=pkg.ScalarImage(data.copy(), affine=affine, modality="T1"),
            seg=pkg.LabelMap(seg.copy(), affine=affine),
            age=40,
        )
        for pkg in (tj, tt)
    ]


@pytest.mark.parametrize("name", list(CROP_OR_PADS))
def test_crop_or_pad_subject_path_matches_the_jax_lazy_path(name):
    """The port's eager Subject path: the JAX package's lazy path's data,
    affines, metadata, history records and draws."""
    kwargs = CROP_OR_PADS[name]
    outs, draws = [], []
    for pkg, subject in zip((tj, tt), _subjects()):
        pkg.seed(9)
        outs.append(pkg.CropOrPad(**kwargs)(subject))
        draws.append(float(pkg.random.random()))
        assert subject.ch.spatial_shape == SHAPE  # copy=True left the input alone
    assert draws[0] == draws[1]
    jax_out, port_out = outs
    assert list(port_out.images) == list(jax_out.images)
    for image in ("ch", "seg"):
        got, want = port_out[image], jax_out[image]
        assert type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.affine.data, want.affine.data)
    assert port_out.ch["modality"] == "T1" and port_out.metadata == jax_out.metadata
    assert [(h.name, h.params, h.include, h.exclude) for h in jax_out.applied_transforms] == [
        (h.name, h.params, h.include, h.exclude) for h in port_out.applied_transforms
    ]


def test_crop_or_pad_image_input_and_gate_match_jax():
    outs = []
    for pkg, subject in zip((tj, tt), _subjects()):
        pkg.seed(4)
        outs.append(pkg.CropOrPad((16, 30, 12))(subject.ch))
        outs.append(pkg.CropOrPad((16, 30, 12), p=0.0)(subject.ch))
        outs.append(float(pkg.random.random()))
    jax_img, jax_gated, jax_draw, port_img, port_gated, port_draw = outs
    assert jax_draw == port_draw
    np.testing.assert_array_equal(port_img.data.numpy(), np.asarray(jax_img.data))
    np.testing.assert_array_equal(port_img.affine.data, jax_img.affine.data)
    assert port_img.applied_transforms == [] and jax_img.applied_transforms == []
    assert port_gated.spatial_shape == jax_gated.spatial_shape == SHAPE


def test_crop_or_pad_subject_inverse_restores_the_shape():
    _, subject = _subjects()
    out = tt.CropOrPad((16, 30, 15))(subject)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = out.apply_inverse_transform()
    assert restored.spatial_shape == SHAPE and restored.applied_transforms == []
    np.testing.assert_array_equal(restored.ch.affine.data, subject.ch.affine.data)
    # the voxels kept by the crop come back in place
    np.testing.assert_array_equal(
        restored.ch.data[:, 2:18, :, 1:13].numpy(), subject.ch.data[:, 2:18, :, 1:13].numpy()
    )


def test_crop_or_pad_refuses_bad_arguments():
    with pytest.raises(ValueError, match="only_crop and only_pad"):
        tt.CropOrPad(4, only_crop=True, only_pad=True)
    with pytest.raises(ValueError, match="units"):
        tt.CropOrPad(4, units="inch")
    with pytest.raises(ValueError, match="location"):
        tt.CropOrPad(4, location="corner")
    with pytest.raises(ValueError, match="1 or 3 values"):
        tt.CropOrPad((4, 5))


@pytest.mark.parametrize(
    "kwargs", [dict(target_multiple=8), dict(target_multiple=(3, 5, 7), method="crop")],
    ids=["pad", "crop"],
)
def test_ensure_shape_multiple_matches_jax(kwargs):
    jax_out, port_out = run_both(lambda pkg: pkg.EnsureShapeMultiple(**kwargs), b=2)
    np.testing.assert_array_equal(port_out.ch.data.numpy(), np.asarray(jax_out.ch.data))
    outs = []
    for pkg, subject in zip((tj, tt), _subjects()):
        pkg.seed(1)
        outs.append(pkg.EnsureShapeMultiple(**kwargs)(subject))
    np.testing.assert_array_equal(outs[1].ch.data.numpy(), np.asarray(outs[0].ch.data))
    assert [(h.name, h.params) for h in outs[0].applied_transforms] == [
        (h.name, h.params) for h in outs[1].applied_transforms
    ]
    with pytest.raises(ValueError, match="method"):
        tt.EnsureShapeMultiple(4, method="round")


# --- config 3 ----------------------------------------------------------------------


def config3(pkg):
    return pkg.Compose(
        [pkg.Affine(scales=(0.9, 1.1), degrees=(-10.0, 10.0)), pkg.Resample(target=1.0)],
        copy=False,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_config3_matches_jax(seed):
    jax_out, port_out = run_both(config3, seed=seed, copy_batch=True)
    assert tuple(port_out.ch.data.shape) == (4, CHANNELS, 20, 22, 24)
    assert_images_close(jax_out, port_out, atol=PIPELINE_ATOL)
    history = [h.params for h in port_out.applied_transforms]
    affine = tt.AffineMatrix(np.diag([*SPACING, 1]))
    maps, fields, _ = spatial_grids(history[0], affine, SHAPE)
    ties = nearest_ties(maps, fields, SHAPE)
    maps, fields, out_shape = spatial_grids(history[1], affine, SHAPE)
    assert_labels_equal_off_ties(jax_out, port_out, nearest_ties(maps, fields, out_shape, ties))


def test_config3_keeps_the_input_batch():
    """copy=False on a deep copy: the copy shares the tensors, and the
    input batch keeps its shape and affines."""
    _, batch = make_batches()
    before = batch.ch.data
    tt.seed(0)
    out = config3(tt)(copy.deepcopy(batch))
    assert batch.ch.data is before and tuple(batch.ch.data.shape) == (4, CHANNELS, *SHAPE)
    assert batch.ch.affines[0].spacing == SPACING
    assert out.ch.affines[0].spacing == (1.0, 1.0, 1.0)
