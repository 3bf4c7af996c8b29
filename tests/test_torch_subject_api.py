"""Port parity: the public methods of Subject, Image and ImagesBatch.

The same numpy data goes into ``torchio_tpu`` and ``torchio_tpu_torch``
on the CPU:

- ``Subject.get_images`` and ``get_images_dict`` (also on ``Study``):
  the same names in the same order for every filter;
- ``check_consistent_spatial_shape`` and ``check_consistent_space``: the
  same ``RuntimeError`` messages (spacing compared at ``rel_tol=1e-6``);
- ``Image.memory``: equal for every dtype ``write_nifti`` writes, loaded
  and lazy (the lazy one from the header, without reading the voxels);
  ``Image.ImageInput`` is ``object``;
- ``ImagesBatch.unbatch`` (views of the batch's tensor, cloned affines)
  and ``affines_array`` in float32 and float64;
- Affine and ElasticDeformation name ``one_hot_label_interpolation`` in
  their signatures, as the JAX package's do.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt

WRITE_DTYPES = (
    np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
    np.uint64, np.float32, np.float64, np.bool_, np.float16,
)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def subjects(shapes=None, spacings=None, cls="Subject"):
    """The same subject in both packages: two scalar images, a label map,
    a point set and metadata, in this order."""
    shapes = shapes or {"t1": (8, 8, 8), "seg": (8, 8, 8), "t2": (8, 8, 8)}
    spacings = spacings or {}
    rng = np.random.default_rng(0)
    out = []
    for pkg in (tj, tt):
        rng = np.random.default_rng(0)
        kwargs = {}
        for name, shape in shapes.items():
            kind = pkg.LabelMap if name.startswith("seg") else pkg.ScalarImage
            data = rng.random((1, *shape)).astype(np.float32)
            affine = np.diag([*spacings.get(name, (1.0, 1.0, 1.0)), 1.0])
            kwargs[name] = kind(data, affine=affine)
        kwargs["landmarks"] = pkg.Points(np.zeros((2, 3), np.float32))
        kwargs["age"] = 40
        out.append(getattr(pkg, cls)(**kwargs))
    return out


FILTERS = [
    {},
    {"intensity_only": False},
    {"include": ["t2", "seg"]},
    {"include": ["seg"], "intensity_only": False},
    {"exclude": ["t1"]},
    {"exclude": ["t1"], "intensity_only": False},
    {"include": ["t1", "t2"], "exclude": ["t2"]},
    {"include": []},
]


@pytest.mark.parametrize("cls", ["Subject", "Study"])
@pytest.mark.parametrize("kwargs", FILTERS, ids=lambda k: str(k) or "default")
def test_get_images_equal_jax(cls, kwargs):
    jax_subject, port_subject = subjects(cls=cls)
    want = jax_subject.get_images_dict(**kwargs)
    got = port_subject.get_images_dict(**kwargs)
    assert list(got) == list(want)
    assert [type(i).__name__ for i in got.values()] == [type(i).__name__ for i in want.values()]
    images = port_subject.get_images(**kwargs)
    assert [id(i) for i in images] == [id(port_subject.images[n]) for n in want]
    assert len(jax_subject.get_images(**kwargs)) == len(images)


def test_get_images_positional_arguments():
    jax_subject, port_subject = subjects()
    assert list(port_subject.get_images_dict(False, None, ["t2"])) == list(
        jax_subject.get_images_dict(False, None, ["t2"])
    )


CONSISTENCY_CASES = {
    "consistent": ({}, {}),
    "shape": ({"t2": (8, 8, 6)}, {}),
    "spacing": ({}, {"t2": (1.0, 1.0, 1.5)}),
    "spacing-within-tolerance": ({}, {"t2": (1.0, 1.0, 1.0 + 1e-8)}),
    "spacing-past-tolerance": ({}, {"t2": (1.0, 1.0, 1.0 + 1e-5)}),
    "label-shape": ({"seg": (7, 8, 8)}, {}),
}


@pytest.mark.parametrize("check", ["check_consistent_spatial_shape", "check_consistent_space"])
@pytest.mark.parametrize("case", list(CONSISTENCY_CASES))
def test_consistency_checks_equal_jax(check, case):
    shape_changes, spacings = CONSISTENCY_CASES[case]
    shapes = {"t1": (8, 8, 8), "seg": (8, 8, 8), "t2": (8, 8, 8)} | shape_changes
    jax_subject, port_subject = subjects(shapes, spacings)
    try:
        getattr(jax_subject, check)()
        want = None
    except RuntimeError as error:
        want = str(error)
    if want is None:
        getattr(port_subject, check)()
    else:
        with pytest.raises(RuntimeError) as info:
            getattr(port_subject, check)()
        assert str(info.value) == want
    if case == "shape":
        assert want is not None and want.startswith("Inconsistent spatial_shape across images:")


def test_single_image_subject_is_consistent():
    _, port_subject = subjects({"t1": (8, 8, 6)})
    port_subject.check_consistent_space()


@pytest.mark.parametrize("dtype", WRITE_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("channels", [1, 3])
def test_memory_equal_jax(tmp_path, dtype, channels):
    data = (np.arange(channels * 5 * 6 * 7) % 3).reshape(channels, 5, 6, 7).astype(dtype)
    path = tmp_path / "image.nii.gz"
    tj.write_nifti(path, data, np.eye(4))
    jax_lazy, port_lazy = tj.ScalarImage(path), tt.ScalarImage(path)
    assert port_lazy.memory == jax_lazy.memory
    assert not port_lazy.is_loaded  # the header alone
    jax_lazy.load()
    port_lazy.load()
    assert port_lazy.memory == jax_lazy.memory
    assert port_lazy.memory == port_lazy.data.numel() * port_lazy.data.element_size()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64])
def test_memory_of_an_image_in_memory(dtype):
    data = np.zeros((2, 4, 5, 6), dtype)
    assert tt.ScalarImage(data).memory == tj.ScalarImage(data).memory == data.nbytes
    tensor = torch.zeros((2, 4, 5, 6), dtype=torch.float16)
    assert tt.ScalarImage(tensor).memory == tensor.numel() * 2


def test_image_input_alias():
    assert tt.Image.ImageInput is object is tj.Image.ImageInput
    assert tt.LabelMap.ImageInput is object


def batches(b=3):
    rng = np.random.default_rng(3)
    data = rng.random((b, 2, 5, 6, 7)).astype(np.float32)
    affines = []
    for i in range(b):
        affine = np.diag([1.0 + i, 0.5, 2.0, 1.0])
        affine[:3, 3] = rng.standard_normal(3)
        affines.append(affine)
    jax_batch = tj.ImagesBatch(data, [tj.AffineMatrix(a) for a in affines], image_class=tj.LabelMap)
    port_batch = tt.ImagesBatch(data, [tt.AffineMatrix(a) for a in affines], image_class=tt.LabelMap)
    return jax_batch, port_batch


def test_unbatch_equal_jax():
    jax_batch, port_batch = batches()
    want, got = jax_batch.unbatch(), port_batch.unbatch()
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert type(g).__name__ == type(w).__name__ == "LabelMap"
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.affine.data, w.affine.data)
        # a view of the batch's tensor, with an affine of its own
        assert g.data.data_ptr() == port_batch.data[i].data_ptr()
        assert g.affine is not port_batch.affines[i]
        g.affine.data[0, 3] += 1.0
        assert port_batch.affines[i].data[0, 3] != g.affine.data[0, 3]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_affines_array_equal_jax(dtype):
    jax_batch, port_batch = batches()
    want = jax_batch.affines_array(dtype)
    got = port_batch.affines_array(dtype)
    assert got.dtype == want.dtype == dtype and got.shape == (3, 4, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_batch.affines_array(), jax_batch.affines_array())


@pytest.mark.parametrize("name", ["Affine", "ElasticDeformation"])
def test_one_hot_label_interpolation_is_named(name):
    want = inspect.signature(getattr(tj, name)).parameters
    got = inspect.signature(getattr(tt, name)).parameters
    assert list(got) == list(want)
    assert got["one_hot_label_interpolation"].default == "linear"
    transform = getattr(tt, name)(one_hot_label_interpolation="nearest")
    assert transform.one_hot_label_interpolation == "nearest"
