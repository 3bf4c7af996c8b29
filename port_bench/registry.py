"""Finds every part of the benchmark by its name: a cell in
``BENCHMARK.json``, its configuration ``configs/<config>.json``, its
traffic mix ``traffic/<traffic>.json``, its limits
``limits/<workload>.json``, a per-layer metric's reader
``metrics/<metric>.py``, a kernel's work function ``work/<kernel>.py``
and a transform's plain reference ``reference/transforms/<Transform>.py``.
A new cell, configuration, mix, metric, kernel or transform is a new file
and an entry; no file that is there needs an edit."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metrics: list[dict], workload: str) -> list[dict]:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s BENCHMARK.json."""
    spec = benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[workload]
    here = root / HERE.name
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((here / "configs" / f"{entry['config']}.json").read_text()),
        traffic=json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{workload}.json").read_text()),
        end_to_end=_for_cell(spec["end_to_end"], workload),
        per_layer=_for_cell(spec["per_layer"], workload),
    )


def _load(kind: str, name: str, root: Path):
    """The module of ``port_bench/<kind>/<name>.py`` under ``root``."""
    path = root / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    qualified = f"{HERE.name}.{kind.replace('/', '.')}.{name}"
    module = sys.modules.get(qualified)
    if module is not None and Path(module.__file__).resolve() == path.resolve():
        return module
    spec = importlib.util.spec_from_file_location(qualified, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(timeline)`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def work_module(kernel: str, root: Path = ROOT):
    return _load("work", kernel, root)


def work_modules(root: Path = ROOT) -> dict:
    """Every kernel's work function in ``work/`` by kernel name."""
    return {
        path.stem: work_module(path.stem, root)
        for path in sorted((root / HERE.name / "work").glob("*.py"))
        if not path.stem.startswith("_")
    }


def reference_transform(name: str, root: Path = ROOT):
    """The plain reference of transform ``name``."""
    return _load("reference/transforms", name, root)
