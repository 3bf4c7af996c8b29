"""Port parity: point sets and bounding boxes against the JAX package.

``Points`` and ``BoundingBoxes`` are host metadata (float32 numpy
coordinates, a float64 affine) in both packages, so every array here is
held equal to the JAX package's, bit for bit:

- ``Points.to_axes`` between every pair of voxel and anatomical
  conventions, ``to_world``, ``new_like`` and deepcopy, under an oblique
  affine;
- ``BoundingBoxes.to_format`` between every (axes, representation) pair,
  labels, ``new_like`` and deepcopy;
- the constructors' errors, with the JAX package's messages;
- Image and Subject routing: keyword values go to the point and box
  stores, ``__setitem__``/``__delitem__``, iteration, ``len``,
  ``all_points``/``all_bounding_boxes``, copies and ``repr``;
- CropOrPad of a Subject or an Image carries each image's annotations
  (unmoved, as the JAX package's lazy views do) and the subject's.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def oblique_affine():
    """A rotated, anisotropic, shifted voxel-to-world map (orientation
    neither RAS nor a flip of it)."""
    angle = np.deg2rad(20.0)
    rot = np.array(
        [[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0], [0.0, 0.0, 1.0]]
    )
    affine = np.eye(4)
    affine[:3, :3] = rot @ np.diag([1.5, -0.8, 2.0])
    affine[:3, 3] = (-10.25, 3.5, 7.0)
    return affine


AFFINES = {"identity": None, "oblique": oblique_affine()}
AXES = ("IJK", "KJI", "JKI", "RAS", "LPS", "PIR", "SLA")


def point_data(seed=0, n=7):
    return np.random.default_rng(seed).uniform(-5.0, 30.0, (n, 3)).astype(np.float32)


def box_data(seed=0, n=5):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-5.0, 20.0, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(0.5, 10.0, (n, 3))], axis=1).astype(np.float32)


def assert_points_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "Points"
    assert got.axes == want.axes and got.data.dtype == want.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine.data, want.affine.data)
    assert got.metadata == want.metadata and len(got) == len(want)


@pytest.mark.parametrize("affine", list(AFFINES))
@pytest.mark.parametrize("source, target", list(itertools.product(AXES[:4], AXES)))
def test_points_to_axes_equal_jax(source, target, affine):
    data = point_data()
    pair = [
        pkg.Points(data, axes=source, affine=AFFINES[affine], metadata={"who": "ref"})
        for pkg in (tj, tt)
    ]
    assert_points_equal(pair[1].to_axes(target), pair[0].to_axes(target))
    np.testing.assert_array_equal(pair[1].to_world(), pair[0].to_world())


def test_points_new_like_deepcopy_and_repr_equal_jax():
    data, other = point_data(1), point_data(2, n=3)
    pair = [
        pkg.Points(data, axes="KJI", affine=oblique_affine(), metadata={"k": [1]})
        for pkg in (tj, tt)
    ]
    assert_points_equal(pair[1].new_like(data=other), pair[0].new_like(data=other))
    shifted = np.eye(4)
    shifted[:3, 3] = 2.0
    assert_points_equal(
        pair[1].new_like(data=other, affine=shifted), pair[0].new_like(data=other, affine=shifted)
    )
    copied = copy.deepcopy(pair[1])
    assert_points_equal(copied, pair[0])
    assert copied.data is not pair[1].data and copied.affine is not pair[1].affine
    assert repr(pair[1]) == repr(pair[0])
    assert pair[1].to("cuda") is pair[1] and pair[1].device == "cpu"


def test_points_take_a_tensor():
    data = point_data(3)
    port = tt.Points(torch.from_numpy(data.astype(np.float64)))
    np.testing.assert_array_equal(port.data, tj.Points(data.astype(np.float64)).data)


@pytest.mark.parametrize("data, axes", [(np.zeros((4, 2)), "IJK"), (np.zeros(3), "IJK"), (np.zeros((2, 3)), "IJX")])
def test_points_errors_equal_jax(data, axes):
    messages = []
    for pkg in (tj, tt):
        with pytest.raises(ValueError) as error:
            pkg.Points(data, axes=axes)
        messages.append(str(error.value))
    assert messages[0] == messages[1]


def formats(pkg):
    return [
        pkg.BoundingBoxFormat(axes, rep)
        for axes in AXES[:5]
        for rep in (pkg.Representation.CORNERS, "center_size")
    ]


def assert_boxes_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "BoundingBoxes"
    assert repr(got.format) == repr(want.format)
    assert got.data.dtype == want.data.dtype == np.float32
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine.data, want.affine.data)
    if want.labels is None:
        assert got.labels is None
    else:
        assert got.labels.dtype == want.labels.dtype == np.int64
        np.testing.assert_array_equal(got.labels, want.labels)
    assert got.metadata == want.metadata and len(got) == len(want)


@pytest.mark.parametrize("affine", list(AFFINES))
@pytest.mark.parametrize("source", range(10))
def test_boxes_to_format_equal_jax(source, affine):
    data = box_data()
    pair = []
    for pkg in (tj, tt):
        fmt = formats(pkg)[source]
        pair.append(
            pkg.BoundingBoxes(
                data, format=fmt, labels=[1, 2, 3, 4, 5], affine=AFFINES[affine],
                metadata={"src": source},
            )
        )
    for target_j, target_t in zip(formats(tj), formats(tt)):
        assert_boxes_equal(pair[1].to_format(target_t), pair[0].to_format(target_j))


def test_boxes_new_like_deepcopy_and_repr_equal_jax():
    data, other = box_data(1), box_data(2, n=2)
    pair = [
        pkg.BoundingBoxes(data, format=pkg.BoundingBoxFormat.IJKWHD, affine=oblique_affine())
        for pkg in (tj, tt)
    ]
    assert_boxes_equal(
        pair[1].new_like(data=other, labels=[7, 8]), pair[0].new_like(data=other, labels=[7, 8])
    )
    assert_boxes_equal(copy.deepcopy(pair[1]), pair[0])
    assert repr(pair[1]) == repr(pair[0]) and repr(pair[1].format) == repr(pair[0].format)
    assert tt.BoundingBoxFormat("RAS") == tt.BoundingBoxFormat("RAS", "corners")
    assert hash(tt.BoundingBoxFormat.IJKIJK) == hash(tt.BoundingBoxFormat("IJK"))
    assert tt.BoundingBoxFormat.IJKIJK != tt.BoundingBoxFormat.IJKWHD


@pytest.mark.parametrize(
    "data, labels",
    [(np.zeros((3, 4)), None), (np.zeros((3, 6)), [1, 2]), (np.zeros((3, 6)), [[1, 2, 3]])],
)
def test_boxes_errors_equal_jax(data, labels):
    messages = []
    for pkg in (tj, tt):
        with pytest.raises(ValueError) as error:
            pkg.BoundingBoxes(data, labels=labels)
        messages.append(str(error.value))
    assert messages[0] == messages[1]


# --- Image and Subject ---------------------------------------------------------


def annotated_subject(pkg, affine=None):
    volume = np.random.default_rng(5).random((1, 12, 10, 8), np.float32)
    seg = (volume > 0.5).astype(np.int32)
    image = pkg.ScalarImage(
        volume,
        affine=affine,
        points={"landmarks": pkg.Points(point_data(4, n=4), affine=affine)},
        bounding_boxes={"lesions": pkg.BoundingBoxes(box_data(5, n=2), labels=[1, 2], affine=affine)},
        scanner="3T",
    )
    return pkg.Subject(
        t1=image,
        seg=pkg.LabelMap(seg, affine=affine),
        fiducials=pkg.Points(point_data(6, n=3), axes="RAS", affine=affine),
        tumour=pkg.BoundingBoxes(box_data(7, n=1), affine=affine),
        age=45,
    )


def test_subject_routes_annotations_as_jax():
    ref, port = (annotated_subject(pkg, oblique_affine()) for pkg in (tj, tt))
    assert list(port) == list(ref) == ["t1", "seg", "fiducials", "tumour"]
    assert len(port) == len(ref) == 4 and port.keys() == ref.keys()
    assert repr(port) == repr(ref)
    assert "fiducials" in port and "age" not in port and port.age == 45
    assert_points_equal(port["fiducials"], ref["fiducials"])
    assert_points_equal(port.fiducials, ref.fiducials)
    assert_boxes_equal(port.tumour, ref.tumour)
    assert list(port.points) == ["fiducials"] and list(port.bounding_boxes) == ["tumour"]
    assert list(port.all_points()) == list(ref.all_points()) == ["fiducials", ("t1", "landmarks")]
    assert list(port.all_bounding_boxes()) == list(ref.all_bounding_boxes())
    for key in ref.all_points():
        assert_points_equal(port.all_points()[key], ref.all_points()[key])
    for key in ref.all_bounding_boxes():
        assert_boxes_equal(port.all_bounding_boxes()[key], ref.all_bounding_boxes()[key])
    assert port.get("tumour") is port.tumour and port.get("missing", 3) == 3
    assert [k for k, _ in port.items()] == [k for k, _ in ref.items()]


def test_subject_setitem_and_delitem_move_entries_between_stores():
    for pkg in (tj, tt):
        subject = annotated_subject(pkg)
        subject["fiducials"] = pkg.BoundingBoxes(box_data(8, n=2))  # points -> boxes
        assert "fiducials" in subject.bounding_boxes and "fiducials" not in subject.points
        subject["age"] = pkg.Points(point_data(9, n=2))  # metadata -> points
        assert "age" in subject.points and "age" not in subject.metadata
        del subject["tumour"]
        with pytest.raises(KeyError):
            del subject["tumour"]
        with pytest.raises(KeyError):
            subject["tumour"]
        assert list(subject) == ["t1", "seg", "age", "fiducials"]
    only = tt.Subject(fiducials=tt.Points(point_data()))
    assert len(only) == 1 and only.points["fiducials"].num_points == 7


def test_image_annotations_survive_copies_and_region_reads():
    ref, port = (annotated_subject(pkg, oblique_affine()).t1 for pkg in (tj, tt))
    for got, want in (
        (port, ref),
        (copy.deepcopy(port), copy.deepcopy(ref)),
        (port.new_like(data=port.data * 2), ref.new_like(data=ref.data * 2)),
        (port[:, 2:8, 1:5, 3:], ref[:, 2:8, 1:5, 3:]),
    ):
        assert list(got.points) == list(want.points) == ["landmarks"]
        assert_points_equal(got.points["landmarks"], want.points["landmarks"])
        assert_boxes_equal(got.bounding_boxes["lesions"], want.bounding_boxes["lesions"])
    copied = copy.deepcopy(port)
    assert copied.points["landmarks"] is not port.points["landmarks"]
    subject_copy = copy.deepcopy(annotated_subject(tt))
    assert_points_equal(subject_copy.fiducials, annotated_subject(tj).fiducials)


CROP_OR_PADS = {
    "crop": dict(target_shape=(8, 6, 8)),
    "pad": dict(target_shape=(16, 14, 12)),
    "pad-reflect": dict(target_shape=(14, 12, 10), padding_mode="reflect"),
    "both": dict(target_shape=(10, 14, 6)),
    "random-crop": dict(target_shape=(6, 6, 6), location="random"),
    "include": dict(target_shape=(8, 8, 8), include=["t1"]),
}


@pytest.mark.parametrize("entry", ["subject", "image"])
@pytest.mark.parametrize("name", list(CROP_OR_PADS))
def test_crop_or_pad_carries_annotations_as_jax(name, entry):
    outs = []
    for pkg in (tj, tt):
        subject = annotated_subject(pkg, oblique_affine())
        pkg.seed(11)
        data = subject if entry == "subject" else subject.t1
        outs.append(pkg.CropOrPad(**CROP_OR_PADS[name])(data))
    ref, port = outs
    images = [(ref, port)] if entry == "image" else [(ref[n], port[n]) for n in ("t1", "seg")]
    for want, got in images:
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.affine.data, want.affine.data)
        assert list(got.points) == list(want.points)
        for key in want.points:
            assert_points_equal(got.points[key], want.points[key])
        for key in want.bounding_boxes:
            assert_boxes_equal(got.bounding_boxes[key], want.bounding_boxes[key])
    if entry == "subject":
        assert_points_equal(port.fiducials, ref.fiducials)
        assert_boxes_equal(port.tumour, ref.tumour)
        assert [h.name for h in port.applied_transforms] == [h.name for h in ref.applied_transforms]
        assert port.age == 45
