"""Every cell resolves to its files by name, and a new cell needs only
new files and one entry."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from port_bench import registry

ROOT = registry.ROOT
SPEC = registry.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_by_name(workload):
    cell = registry.cell(workload)
    assert cell.config["images"] and cell.traffic["transforms"] and "limits" in cell.limits
    for name, _ in cell.traffic["transforms"]:
        module = registry.reference_transform(name)
        assert callable(module.draw) and callable(module.apply)
    for entry in cell.per_layer:
        assert callable(registry.metric_reader(entry["name"]))
    assert {m["name"] for m in cell.end_to_end} == {
        "subjects_per_s", "call_ms_p95", "peak_gib", "setup_s"}
    assert set(cell.limits["limits"]) == {
        f"{name}.{'max_abs' if image['kind'] == 'scalar' else 'mismatch'}"
        for name, image in cell.config["images"].items()
    }


def test_every_roofline_metric_has_its_work_function():
    for entry in SPEC["per_layer"]:
        if entry["name"].endswith("_roofline"):
            assert entry["name"][: -len("_roofline")] in registry.work_modules()


def test_configs_files_are_the_cells_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for config in SPEC["configs"]:
        assert json.loads((ROOT / config["file"]).read_text())["name"] == config["name"]


def digest(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts
    }


def test_a_new_cell_takes_only_new_files_and_an_entry(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "port_bench")
    here = tmp_path / "port_bench"
    config = json.loads((here / "configs" / "t1-1mm-256.json").read_text())
    config["name"] = "t1-1mm-192"
    for image in config["images"].values():
        image["shape"] = [192, 192, 192]
    (here / "configs" / "t1-1mm-192.json").write_text(json.dumps(config))
    traffic = json.loads((here / "traffic" / "headline.json").read_text())
    traffic["batch"] = 4
    (here / "traffic" / "headline-b4.json").write_text(json.dumps(traffic))
    (here / "limits" / "t1-192-headline-b4.json").write_text(
        json.dumps({"limits": {"t1.max_abs": 1e-4, "seg.mismatch": 1e-5}}))
    (here / "metrics" / "calls_per_s.py").write_text(
        "def read(timeline):\n    return len(timeline.calls)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "t1-1mm-192", "source": "x",
                            "file": "port_bench/configs/t1-1mm-192.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "t1-192-headline-b4", "config": "t1-1mm-192",
                              "traffic": "headline-b4", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "subjects_per_s", "workloads": ["t1-192-headline-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = registry.cell("t1-192-headline-b4", tmp_path)
    assert cell.config["images"]["t1"]["shape"] == [192, 192, 192]
    assert cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "calls_per_s"
    assert registry.metric_reader("calls_per_s", tmp_path)(type("T", (), {"calls": [1, 2]})) == 2
    after = digest(here)
    assert {k: v for k, v in after.items() if k in before} == before
