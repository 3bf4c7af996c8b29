"""The frozen work functions give the bounds of the port's kernel table
(PERF.md, section 6) at the shapes it timed them, count only the
elements whose p-gate drew the operation, and match each kernel's
profiler name."""

from __future__ import annotations

import numpy as np
import pytest

from port_bench import inputs
from port_bench.registry import work_module, work_modules
from port_bench.yardstick import bound

T1 = {"images": {"t1": {"kind": "scalar", "channels": 1, "shape": [256] * 3, "dtype": "float32"}}}
BRATS = {"images": {
    "mri": {"kind": "scalar", "channels": 4, "shape": [240, 240, 155], "dtype": "float32"},
    "seg": {"kind": "label", "channels": 1, "shape": [240, 240, 155], "dtype": "int32"},
}}
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
