"""On the card only: every cell, run briefly at its own size, is correct,
and its control is not. Run from the root of a checkout on a machine
with a CUDA device: ``python -m pytest port_bench/tests -m card``."""

from __future__ import annotations

import time

import pytest

from port_bench import harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_its_control_is_not(card, workload):
    cell = registry.cell(workload)
    result = harness.run(cell, 2**31 + 7, 3.0, False, card, started=time.perf_counter(),
                         log=lambda *_: None)
    assert result["correct"], result["checks"]
    control = harness.run(cell, 2**31 + 8, 3.0, False, card, started=time.perf_counter(),
                          control=True, log=lambda *_: None)
    assert not control["correct"], control["checks"]
