"""The frozen work functions give the bounds of the port's kernel table
(PERF.md, section 6) at the shapes it timed them, count only the
elements whose p-gate drew the operation, and match each kernel's
profiler name."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import harness, inputs, registry
from port_bench.registry import work_module, work_modules
from port_bench.yardstick import THREEFRY_OPS, bound

T1 = {"images": {"t1": {"kind": "scalar", "channels": 1, "shape": [256] * 3, "dtype": "float32"}}}
BRATS = {"images": {
    "mri": {"kind": "scalar", "channels": 4, "shape": [240, 240, 155], "dtype": "float32"},
    "seg": {"kind": "label", "channels": 1, "shape": [240, 240, 155], "dtype": "int32"},
}}
#: an image LabelsToImage makes; a history without that step leaves it out
MADE = {"kind": "scalar", "channels": 1, "shape": [256] * 3, "dtype": "float32",
        "made_by": "LabelsToImage"}
T1_MADE = {"images": {**T1["images"], "image_from_labels": MADE}}
FIELD = np.zeros((7, 7, 7, 3)).tolist()
MAP = np.eye(4).tolist()


def spatial(batch, images, image="linear", label="nearest", drawn=None):
    drawn = [True] * batch if drawn is None else drawn
    return ("Spatial", {
        "selected_images": images, "image_interpolation": image,
        "label_interpolation": label, "target": None,
        "affine_matrix": [MAP if d else None for d in drawn],
        "control_points": [FIELD if d else None for d in drawn],
        "max_displacement": [[7.5] * 3 if d else None for d in drawn],
        "_batched_keys": ["affine_matrix", "control_points", "max_displacement"],
    })


def least_ms(kernel, history, config, batch):
    nbytes, flops = work_module(kernel).work(history, inputs.images(config), batch)
    return bound(nbytes, flops)


@pytest.mark.parametrize("kernel, history, config, want_ms, by", [
    ("resample", [spatial(4, ["t1"])], T1, 0.160, "bytes"),
    ("label_vote", [spatial(4, ["mri", "seg"], "cubic", "label")], BRATS, 0.085, "bytes"),
    ("spline", [spatial(4, ["mri", "seg"], "cubic", "label")], BRATS, 0.435, "operations"),
    ("prefilter", [spatial(4, ["mri", "seg"], "cubic", "label")], BRATS, 0.341, "bytes"),
    ("resample_coords", [("Motion", {
        "transforms": [[{"degrees": [5.0] * 3, "translation": [3.0] * 3}]] * 4,
        "_batched_keys": ["transforms"]})], T1, 0.401, "bytes"),
    ("threefry", [("Noise", {"mean": [0.0] * 4, "std": [0.1] * 4, "seed": 1})], T1, 0.116,
     "operations"),
    ("resample", [spatial(4, ["t1"])], T1_MADE, 0.160, "bytes"),
    ("threefry", [("Noise", {"mean": [0.0] * 4, "std": [0.1] * 4, "seed": 1})], T1_MADE, 0.116,
     "operations"),
])
def test_bounds_of_the_kernel_table(kernel, history, config, want_ms, by):
    got_ms, got_by = least_ms(kernel, history, config, 4)
    assert round(got_ms, 3) == want_ms
    assert got_by == by


def test_only_the_drawn_elements_count():
    motion = ("Motion", {"transforms": [[{"degrees": [5.0] * 3, "translation": [3.0] * 3}], [],
                                        [], []], "_batched_keys": ["transforms"], "_keep":
                         [True, False, False, False]})
    one, _ = least_ms("resample_coords", [motion], T1, 4)
    assert one == pytest.approx(0.401 / 4, rel=1e-3)
    half, _ = least_ms("resample", [spatial(4, ["t1"], drawn=[True, False, True, False])], T1, 4)
    assert half == pytest.approx(0.160 / 2, rel=1e-2)
    noise = ("Noise", {"mean": [0.0] * 4, "std": [0.1, 0, 0.1, 0], "seed": 1,
                       "_keep": [True, False, True, False]})
    assert least_ms("threefry", [noise], T1, 4)[0] == pytest.approx(0.116 / 2, rel=1e-2)
    bias = ("BiasField", {"std": [0.5, 0.0, 0.5, 0.5], "seed": [1, 2, 3, 4], "scale": 0.025,
                          "_batched_keys": ["std", "seed"]})
    small = 3 * 6**3
    nbytes, flops = work_module("threefry").work([bias], inputs.images(T1), 4)
    assert nbytes == 4 * small


def test_a_record_that_draws_nothing_gives_no_work():
    history = [spatial(4, ["mri", "seg"], "linear", "nearest")]
    images = inputs.images(BRATS)
    for kernel in ("spline", "prefilter", "label_vote", "resample_coords", "threefry"):
        assert work_module(kernel).work(history, images, 4) == (0, 0)


LABELS = {"images": {
    "seg": {"kind": "label", "channels": 1, "shape": [256] * 3, "dtype": "int32"},
    "image_from_labels": MADE,
}}
NOISE = ("Noise", {"mean": [0.0] * 4, "std": [0.1] * 4, "seed": 1})
BIAS = ("BiasField", {"std": [0.5] * 4, "seed": [1, 2, 3, 4], "scale": 0.025,
                      "_batched_keys": ["std", "seed"]})


def labels_to_image(means, stds, batch=4):
    """A per-element record: ``means`` and ``stds`` a list of label ->
    value, one an element, or one for all."""
    means, stds = ([dict(v)] * batch if isinstance(v, dict) else v for v in (means, stds))
    return ("LabelsToImage", {"means": means, "stds": stds, "seed": 7, "_batch_size": batch,
                              "_batched_keys": ["means", "stds"]})


def normals(history):
    from port_bench.work.threefry import normals as count

    return count(history, inputs.images(LABELS), 4)


DRAWN = {label: 0.5 if label < 8 else 0.0 for label in range(32)}
VOXELS = 256**3


@pytest.mark.parametrize("record, elements", [
    (labels_to_image({1: 0.5}, {1: 0.05}), 4),
    (labels_to_image(DRAWN, DRAWN), 4),
    # means alone, with zero stds, need no normal
    (labels_to_image(dict.fromkeys(range(32), 0.3), dict.fromkeys(range(32), 0.0)), 0),
    (labels_to_image(dict.fromkeys(range(32), 0.3), dict.fromkeys(range(32), 0.02)), 4),
    # a std in every element, a mean in one element only
    (labels_to_image([{0: 0.0, 1: 0.0}] * 3 + [{0: 0.3, 1: 0.0}], {0: 0.0, 1: 0.02}), 4),
    # ignore_background: label 0 at zero is counted with the rest (an upper bound)
    (labels_to_image({0: 0.0, 5: 0.4}, {0: 0.0, 5: 0.01}), 4),
    # a history replayed from JSON has string labels
    (labels_to_image({"3": 0.2}, {"3": 0.0}), 0),
    (labels_to_image({"3": 0.2}, {"3": 0.01}), 4),
    # an element whose stds are all zero is its means
    (labels_to_image({1: 0.5, 2: 0.6}, [{1: 0.05, 2: 0.0}] * 3 + [{1: 0.0, 2: 0.0}]), 3),
])
def test_labels_to_image_draws_a_normal_a_voxel_of_an_element_with_a_std(record, elements):
    assert normals([record]) == elements * VOXELS


def test_the_synthseg_record_counts_one_normal_a_voxel():
    """The SynthSeg cell's LabelsToImage, drawn by the port on the CPU at
    a small shape (32 labels an element, TorchIO's default ranges),
    counts at the cell's shape one normal a voxel of each element."""
    import torchio_tpu_torch as tio

    cell = registry.cell("synthseg-labels-b4")
    small = inputs.images(cell.config, (32, 30, 28))
    tensors = inputs.make(small, 4, 2**31 + 29, "cpu")
    args = dict(cell.traffic["transforms"])["LabelsToImage"]
    previous = tio.set_default_device("cpu")
    try:
        tio.seed(29)
        out = tio.LabelsToImage(**args)(harness.make_batch(tio, small, tensors))
    finally:
        tio.set_default_device(previous)
    history = [(record.name, record.raw_params()) for record in out.applied_transforms]
    (_, params), = history
    assert [len(stds) for stds in params["stds"]] == [32] * 4
    assert all(0.01 <= s <= 0.1 for stds in params["stds"] for s in stds.values())
    full = inputs.images(cell.config)
    assert work_module("threefry").work(history, full, 4) == (4 * 4 * VOXELS,
                                                              4 * VOXELS * THREEFRY_OPS)


def test_a_made_image_counts_only_after_its_maker():
    maker = labels_to_image({1: 0.5}, {1: 0.05})
    field = 4 * 256**3
    assert normals([NOISE, BIAS]) == 0
    assert normals([NOISE, maker]) == field
    assert normals([maker, NOISE]) == field + field
    assert normals([BIAS, maker, BIAS]) == field + 4 * 6**3
    # 4 bytes and THREEFRY_OPS operations a normal, as the table's row
    nbytes, flops = work_module("threefry").work([maker, NOISE], inputs.images(LABELS), 4)
    assert (nbytes, flops) == (4 * 2 * field, 2 * field * THREEFRY_OPS)


NAMES = {
    "void tio::row_kernel<(anonymous namespace)::Resample<false, int, (anonymous namespace)"
    "::Layout<false, 2> >, (tio::Source)1, true>(ResampleArgs, tio::Points, tio::Shape, int)":
        "resample",
    "void tio::row_kernel<(anonymous namespace)::Resample<false, int, (anonymous namespace)"
    "::Layout<true, 2> >, (tio::Source)2, false>(ResampleArgs, tio::Points, tio::Shape, int)":
        "resample_coords",
    "void tio::row_kernel<(anonymous namespace)::Vote<int, int, (anonymous namespace)"
    "::VoteLayout<false, 2> >, (tio::Source)1, true>(VoteArgs, tio::Points, tio::Shape, int)":
        "label_vote",
    "void (anonymous namespace)::spline_kernel<3, (tio::Source)1, 4>(float const*)": "spline",
    "void (anonymous namespace)::prefilter_lines_kernel(float const*, float*, long)": "prefilter",
    "void threefry::segments_kernel<true, false, unsigned int>(void*, threefry::Table)":
        "threefry",
    "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float>>": None,
}


@pytest.mark.parametrize("name, kernel", NAMES.items())
def test_each_kernel_name_matches_one_work_function(name, kernel):
    matched = [k for k, module in work_modules().items() if module.matches(name)]
    assert matched == ([kernel] if kernel else [])
