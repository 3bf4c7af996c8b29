"""Port parity: Transpose, CopyAffine, Reorient, ToReferenceSpace, Resize and
Anisotropy against the JAX package.

The same numpy volumes (B=3 x 12x14x10 unless stated) go through
``torchio_tpu`` and ``torchio_tpu_torch`` on the CPU from one seed:

- data and dtype equal for the index transforms (Transpose, Reorient,
  Resize and Anisotropy in nearest mode), within 1e-5 for the linear
  modes of Resize and Anisotropy; affines, params, history and the next
  host draw equal;
- per-instance and batch-wide params, gated-out elements bit-exact;
- the inverses of Transpose and Reorient replayed from the history
  (``apply_inverse_transform``) equal;
- every error the JAX package raises, with its message.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu.data.batch import SubjectsBatch as JaxBatch
from torchio_tpu.ops.resample import upsample_volume as jax_upsample_volume
from torchio_tpu.transforms.spatial import reorient as jax_reorient
from torchio_tpu_torch.transforms.spatial import reorient as port_reorient

LINEAR_ATOL = 1e-5
SHAPE = (12, 14, 10)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def volumes(b=3, shape=SHAPE, seed=0, dtype=np.float32, channels=1):
    """(B, C, *shape) values: floats in [0, 1) or integers in [0, 100)."""
    rng = np.random.default_rng(seed)
    data = rng.random((b, channels, *shape))
    if np.issubdtype(dtype, np.floating):
        return data.astype(dtype)
    return (data * 100).astype(dtype)


def block_labels(b=3, shape=SHAPE, labels=(0, 1, 2, 4), block=3):
    """(B, 1, *shape) int32 blocks of ``labels``, shifted per element."""
    idx = np.indices(shape) // block
    out = [np.asarray(labels)[(idx.sum(axis=0) + e) % len(labels)] for e in range(b)]
    return np.stack(out)[:, None].astype(np.int32)


def batches(images, affine=None):
    """The same subjects as a JAX batch and a port batch: ``images`` maps
    a name to (``"scalar"`` or ``"label"``, a (B, C, I, J, K) array); one
    affine (identity by default) or one per element."""
    b = len(next(iter(images.values()))[1])
    affines = affine if isinstance(affine, list) else [affine] * b
    out = []
    for pkg, batch_class in ((tj, JaxBatch), (tt, tt.SubjectsBatch)):
        subjects = []
        for i in range(b):
            kwargs = {}
            for name, (kind, data) in images.items():
                cls = pkg.LabelMap if kind == "label" else pkg.ScalarImage
                kwargs[name] = cls(data[i].copy(), affine=affines[i])
            subjects.append(pkg.Subject(**kwargs))
        out.append(batch_class.from_subjects(subjects))
    return tuple(out)


def both(make, images, seed=3, affine=None):
    """``make(pkg)`` on the same subjects in both packages from one seed:
    the outputs, after checking equal histories and the same next host
    draw."""
    outs, draws = [], []
    for pkg, batch in zip((tj, tt), batches(images, affine)):
        transform = make(pkg)
        pkg.seed(seed)
        outs.append(transform(batch))
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1]
    assert history_close(history(outs[1]), history(outs[0]))
    return tuple(outs)


def history(batch):
    return [(h.name, h.params, h.include, h.exclude) for h in batch.applied_transforms]


#: history keys that hold statistics of the data (float32 sums in
#: another order than XLA's): their floats agree within STATS_RTOL
DATA_STATS = ("in_ranges", "stats")
STATS_RTOL = 1e-5


def history_close(got, want, stats=False) -> bool:
    """Equal history trees, floats under DATA_STATS keys within STATS_RTOL
    (relative above 1)."""
    if isinstance(want, dict):
        return isinstance(got, dict) and sorted(got) == sorted(want) and all(
            history_close(got[k], want[k], stats or k in DATA_STATS) for k in want
        )
    if isinstance(want, (list, tuple)):
        return isinstance(got, (list, tuple)) and len(got) == len(want) and all(
            history_close(g, w, stats) for g, w in zip(got, want)
        )
    if stats and isinstance(want, float):
        return isinstance(got, float) and abs(got - want) <= STATS_RTOL * max(1.0, abs(want))
    return got == want


def assert_images(jax_out, port_out, atol=None):
    """Every image equal (or within ``atol``) with its dtype, and equal
    affines."""
    assert list(jax_out.images) == list(port_out.images)
    for name in jax_out.images:
        want = np.asarray(jax_out.images[name].data)
        got = port_out.images[name].data.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if atol is None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
        for a, b in zip(jax_out.images[name].affines, port_out.images[name].affines):
            np.testing.assert_array_equal(b.data, a.data)
        assert jax_out.images[name].image_class.__name__ == port_out.images[name].image_class.__name__


def inverses(jax_out, port_out):
    return jax_out.apply_inverse_transform(warn=False), port_out.apply_inverse_transform(warn=False)


def oblique(spacing=(1.0, 1.5, 2.0), codes="LPS", perm=(1, 2, 0)):
    """An affine whose voxel axes run ``codes`` in the order ``perm``."""
    signs = {"R": 1, "L": -1, "A": 1, "P": -1, "S": 1, "I": -1}
    axis = {"R": 0, "L": 0, "A": 1, "P": 1, "S": 2, "I": 2}
    m = np.zeros((4, 4))
    for voxel, world in enumerate(perm):
        code = codes[world]
        m[axis[code], voxel] = signs[code] * spacing[voxel]
    m[:3, 3] = (3.0, -7.0, 11.0)
    m[3, 3] = 1.0
    return m


SCALAR_AND_LABEL = {
    "t1": ("scalar", volumes()),
    "seg": ("label", block_labels()),
}


# --- Transpose and CopyAffine ----------------------------------------------------


def test_transpose_and_its_inverse():
    affine = oblique()
    jax_out, port_out = both(lambda pkg: pkg.Transpose(), SCALAR_AND_LABEL, affine=affine)
    assert_images(jax_out, port_out)
    assert port_out.t1.data.shape[2:] == SHAPE[::-1]
    jax_back, port_back = inverses(jax_out, port_out)
    assert_images(jax_back, port_back)
    np.testing.assert_array_equal(port_back.t1.data.numpy(), SCALAR_AND_LABEL["t1"][1])


def test_copy_affine():
    affines = [oblique(), oblique(codes="RAS", perm=(0, 1, 2)), oblique(spacing=(2, 2, 2))]
    jb, pb = batches(SCALAR_AND_LABEL, affine=affines)
    # give seg its own affines so that the copy shows
    for batch in (jb, pb):
        for a in batch.seg.affines:
            a._matrix = np.diag([3.0, 3.0, 3.0, 1.0])
    outs = []
    for pkg, batch in ((tj, jb), (tt, pb)):
        pkg.seed(0)
        outs.append(pkg.CopyAffine("t1")(batch))
    assert_images(*outs)
    for i, a in enumerate(outs[1].seg.affines):
        np.testing.assert_array_equal(a.data, affines[i])
    messages = []
    for pkg, batch in ((tj, jb), (tt, pb)):
        with pytest.raises(KeyError) as err:
            pkg.CopyAffine("t2")(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert "Reference image 't2' not found" in messages[1]


# --- Reorient ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "codes, perm, target",
    [
        ("LPS", (1, 2, 0), "RAS"),
        ("LPI", (0, 1, 2), "RAS"),
        ("RAS", (2, 0, 1), "LPS"),
        ("RAS", (0, 1, 2), "RAS"),  # the identity short-cut
    ],
)
def test_reorient_and_its_inverse(codes, perm, target):
    affine = oblique(codes=codes, perm=perm)
    images = {
        "t1": ("scalar", volumes(dtype=np.int16, channels=2)),
        "seg": ("label", block_labels()),
    }
    jax_out, port_out = both(lambda pkg: pkg.Reorient(target), images, affine=affine)
    assert_images(jax_out, port_out)
    assert "".join(port_out.t1.affines[0].orientation) == target
    jax_back, port_back = inverses(jax_out, port_out)
    assert_images(jax_back, port_back)
    np.testing.assert_array_equal(port_back.t1.data.numpy(), images["t1"][1])
    np.testing.assert_array_equal(port_back.t1.affines[0].data, affine)


@pytest.mark.parametrize("code", ["RA", 3, "RAX", "RRS", "ras"])
def test_reorient_validation(code):
    outcomes = []
    for module in (jax_reorient, port_reorient):
        try:
            outcomes.append(module._validate_orientation(code))
        except ValueError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]
    for pkg in (tj, tt):
        if outcomes[0] != "RAS":
            with pytest.raises(ValueError, match="Orientation"):
                pkg.Reorient(code)


# --- ToReferenceSpace -------------------------------------------------------------


def test_to_reference_space():
    reference_data = volumes(b=1, shape=(24, 20, 16))[0]
    reference_affine = oblique(spacing=(0.5, 0.75, 1.0))
    jax_ref = tj.ScalarImage(reference_data, affine=reference_affine)
    port_ref = tt.ScalarImage(reference_data, affine=reference_affine)
    jb, pb = batches(SCALAR_AND_LABEL)
    jax_out = tj.ToReferenceSpace(jax_ref)(jb)
    port_out = tt.ToReferenceSpace(port_ref)(pb)
    assert_images(jax_out, port_out)
    embedding = torch.rand(4, 6, 5, 4)
    jax_image = tj.ToReferenceSpace.from_tensor(embedding.numpy(), jax_ref)
    port_image = tt.ToReferenceSpace.from_tensor(embedding, port_ref)
    assert isinstance(port_image, tt.ScalarImage)
    assert port_image.data is embedding  # the tensor stays as it is
    np.testing.assert_array_equal(port_image.affine.data, jax_image.affine.data)
    label_ref = tt.LabelMap(block_labels(b=1)[0], affine=reference_affine)
    assert isinstance(tt.ToReferenceSpace.from_tensor(embedding, label_ref), tt.LabelMap)
    for pkg in (tj, tt):
        with pytest.raises(TypeError, match="reference must be an Image, got ndarray"):
            pkg.ToReferenceSpace(reference_data)


# --- Resize -----------------------------------------------------------------------


@pytest.mark.parametrize(
    "target, image_mode",
    [((8, 20, 10), "linear"), (9, "nearest"), ((24, 7, 13), "linear")],
)
def test_resize(target, image_mode):
    images = {
        "t1": ("scalar", volumes(channels=2)),
        "ct": ("scalar", volumes(dtype=np.int16)),
        "seg": ("label", block_labels()),
    }
    jax_out, port_out = both(
        lambda pkg: pkg.Resize(target, image_interpolation=image_mode), images,
        affine=oblique(),
    )
    atol = LINEAR_ATOL if image_mode == "linear" else None
    assert_images(
        jax_out.__class__({"t1": jax_out.t1}), port_out.__class__({"t1": port_out.t1}), atol
    )
    np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))
    expected = (target,) * 3 if isinstance(target, int) else target
    assert_integer_resize(
        port_out.ct.data, jax_out.ct.data, images["ct"][1], expected, image_mode
    )
    assert tuple(port_out.seg.data.shape[2:]) == expected


def assert_integer_resize(got, want, source, target, mode):
    """An integer image resized: equal where nearest; where linear, equal
    except that a voxel whose float32 value lies within LINEAR_ATOL of an
    integer, relative to its magnitude, may truncate to the next integer
    down or up (the float32 values of images in [0, 100) agree within
    that, not bit for bit)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
        return
    exact = np.asarray(jax_upsample_volume(source.astype(np.float32), target))
    near_integer = np.abs(exact - np.round(exact)) <= LINEAR_ATOL * np.maximum(1, exact)
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and not np.any((diff > 0) & ~near_integer)


# --- Anisotropy -------------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(downsampling=(1.5, 5)),  # per instance
        dict(downsampling=(2, 4), p=0.5),  # per instance, gated
        dict(downsampling=(2, 4), per_instance=False),  # batch-wide
        dict(downsampling=3.0, axes=(1,), image_interpolation="nearest"),
        dict(downsampling=(1.0, 1.0)),  # every factor 1: no change
    ],
)
@pytest.mark.parametrize("seed", [0, 5])
def test_anisotropy(kwargs, seed):
    images = {
        "t1": ("scalar", volumes(b=3, shape=(14, 16, 18), channels=2)),
        "seg": ("label", block_labels(b=3, shape=(14, 16, 18))),
    }
    if kwargs.get("downsampling") == (1.0, 1.0):
        with pytest.warns(RuntimeWarning, match="no-op"):
            tt.Anisotropy(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_out, port_out = both(lambda pkg: pkg.Anisotropy(**kwargs), images, seed=seed)
    linear = kwargs.get("image_interpolation", "linear") == "linear"
    atol = LINEAR_ATOL if linear else None
    assert_images(
        jax_out.__class__({"t1": jax_out.t1}), port_out.__class__({"t1": port_out.t1}), atol
    )
    np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))
    params = port_out.applied_transforms[0].params if port_out.applied_transforms else None
    if params and "_keep" in params:
        for i, kept in enumerate(params["_keep"]):
            if not kept:
                assert torch.equal(port_out.t1.data[i], torch.as_tensor(images["t1"][1][i]))


def test_anisotropy_errors():
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match="downsampling range upper bound must be >= 1"):
            pkg.Anisotropy(downsampling=(0.2, 0.5))
    messages = []
    for pkg, batch in zip((tj, tt), batches(SCALAR_AND_LABEL)):
        pkg.seed(0)
        with pytest.raises(ValueError) as err:
            pkg.Anisotropy(axes=(3,), downsampling=2.0)(batch)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "Anisotropy axis must be in {0, 1, 2}, got 3"
