"""The plain references against the port's CPU path at a small size:
every cell comes out correct; the control (the reference kept in
bfloat16 in the program's place) and a run with the timed path broken
underneath come out not correct. The look for a card is skipped: the
harness runs on the CPU."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from port_bench import harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SHAPE, BATCH, SECONDS, SEED = (32, 30, 28), 4, 1.5, 2**31 + 12345


def run(workload, **kwargs):
    cell = registry.cell(workload)
    return harness.run(cell, SEED, SECONDS, False, "cpu", started=time.perf_counter(),
                       shape=SHAPE, batch=BATCH, log=lambda *_: None, **kwargs)


def unchanged(pipeline):
    """A step that returns its state unchanged."""
    return lambda batch: copy.deepcopy(batch)


def half_left_out(pipeline):
    """Half of the batch left out: its elements come back as they went in,
    and with no image made for them (zeros) where the pipeline makes one."""
    def call(batch):
        out = pipeline(batch)
        half = len(next(iter(batch.images.values())).data) // 2
        for name, images in out.images.items():
            data = images.data.clone()
            data[half:] = batch.images[name].data[half:] if name in batch.images else 0
            images.data = data
        return out
    return call


def altered(pipeline):
    """An answer altered where it is produced: one voxel of every image."""
    def call(batch):
        out = pipeline(batch)
        for images in out.images.values():
            data = images.data.clone()
            data[:, :, 3, 4, 5] += 1
            images.data = data
        return out
    return call


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_agrees_with_the_reference(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    result = run(workload, control=True)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    # enough captures that an element left out also drew the p=0.5 gates
    result = run(workload, wrap=fault, captures=16)
    assert not result["correct"], result["checks"]
    assert result["failed"] == 0, "the fault is to be read in the answers, not raised"


def test_a_failing_call_ends_the_window_and_is_not_correct():
    def failing(pipeline):
        calls = []

        def call(batch):
            calls.append(1)
            if len(calls) > 5:  # after the warm-up and a few calls of the window
                raise RuntimeError("device lost")
            return pipeline(batch)
        return call

    result = run("brats-preprocess-b4", wrap=failing)
    assert not result["correct"] and result["failed"] == 1 and result["attempted"] == 3


def test_the_reference_changes_with_the_seed():
    cell = registry.cell("t1-kspace-b4")
    from port_bench import inputs
    from port_bench.reference.context import Context
    from port_bench.reference.pipeline import Reference

    specs = inputs.images(cell.config, SHAPE)
    reference = Reference(cell.traffic, Context(specs, BATCH, torch.device("cpu")))
    one = reference.replay(1, 8)
    assert one == reference.replay(1, 8) and one != reference.replay(2, 8)


def test_a_missing_or_broken_answer_reads_unbounded_and_stays_json():
    import json

    from port_bench import inputs

    specs = inputs.images(registry.cell("t1-headline-b8").config, (4, 4, 4))
    want = {"t1": torch.zeros(1, 4, 4, 4), "seg": torch.zeros(1, 4, 4, 4, dtype=torch.int32)}
    broken = {"t1": torch.full((1, 4, 4, 4), float("nan"))}
    gaps = harness.compare(specs, broken, want)
    assert gaps == {"t1.max_abs": harness.UNBOUNDED, "seg.mismatch": harness.UNBOUNDED}
    assert json.loads(json.dumps(gaps)) == gaps
