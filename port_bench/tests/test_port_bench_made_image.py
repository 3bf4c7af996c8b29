"""An image that the pipeline makes: a label-only configuration whose
scalar image is written by LabelsToImage (SynthSeg's generator) comes
out correct against the reference on the port's CPU path; the control,
a broken timed path and a pipeline that never makes the image come out
not correct, without raising; a made image listed before an input is
refused."""

from __future__ import annotations

import copy
import time

import pytest

from port_bench import harness, inputs, registry
from port_bench.tests.test_port_bench_reference import altered, half_left_out, unchanged

SHAPE, BATCH, SECONDS, SEED = (32, 30, 28), 4, 1.5, 2**31 + 54321
MADE = "image_from_labels"
CONFIG = {
    "name": "labels-only",
    "images": {
        # every label of the blocks is present at SHAPE and survives the warp
        "seg": {"kind": "label", "channels": 1, "shape": list(SHAPE), "dtype": "int32",
                "labels": "blocks", "block": 4, "values": [0, 1, 2, 3, 4, 5, 6, 7]},
        MADE: {"kind": "scalar", "channels": 1, "shape": list(SHAPE), "dtype": "float32",
               "made_by": "LabelsToImage"},
    },
}
TRAFFIC = {
    "batch": BATCH,
    "transforms": [
        ["Spatial", {"scales": [0.9, 1.1], "degrees": 10, "max_displacement": 7.5}],
        ["LabelsToImage", {"label_key": "seg"}],
        ["BiasField", {"std": 0.5}],
        ["Noise", {"std": 0.1}],
    ],
    "warmup_calls": 3,
    "captures": 6,
}
LIMITS = {"limits": {f"{MADE}.max_abs": 1e-4, "seg.mismatch": 0.0}}


def cell(fuse=False) -> registry.Cell:
    return registry.Cell(name="labels-only-b4", chips=1, config=CONFIG,
                         traffic={**TRAFFIC, "fuse": fuse}, limits=LIMITS,
                         end_to_end=[], per_layer=[])


def run(target=None, **kwargs):
    return harness.run(target or cell(), SEED, SECONDS, False, "cpu",
                       started=time.perf_counter(), shape=SHAPE, batch=BATCH,
                       log=lambda *_: None, **kwargs)


def never_made(pipeline):
    """The pipeline without the step that makes the image."""
    import torchio_tpu_torch as tio

    kept = [t for t in pipeline.transforms if type(t).__name__ != "LabelsToImage"]
    return tio.Compose(kept, fuse=pipeline.fuse)


@pytest.mark.parametrize("fuse", [False, True])
def test_the_made_image_agrees_with_the_reference(fuse):
    result = run(cell(fuse))
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(LIMITS["limits"])
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_the_control_is_not_correct():
    result = run(control=True)
    assert not result["correct"]
    assert result["checks"][f"{MADE}.max_abs"]["value"] > 1e-4, result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, never_made])
def test_a_broken_timed_path_is_not_correct_and_does_not_raise(fault):
    result = run(wrap=fault, captures=16)
    assert not result["correct"], result["checks"]
    assert result["failed"] == 0
    if fault is never_made:  # the capture records the image as missing
        assert result["checks"][f"{MADE}.max_abs"]["value"] == harness.UNBOUNDED


def test_the_made_image_is_no_input():
    specs = inputs.images(CONFIG)
    assert specs[MADE].made_by == "LabelsToImage" and specs["seg"].made_by is None
    assert list(inputs.given(specs)) == ["seg"]
    assert list(inputs.make(specs, 2, SEED, "cpu")) == ["seg"]


def test_a_made_image_before_an_input_is_refused():
    config = copy.deepcopy(CONFIG)
    config["images"] = {MADE: config["images"][MADE], "seg": config["images"]["seg"]}
    with pytest.raises(ValueError, match="follows a made image"):
        inputs.images(config)
