"""Nothing of the benchmark imports JAX or the JAX package, judged by the
whole top-level name of each module; the reference imports nothing of
the program; a run without a card prints no result and fails."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import registry

HERE = registry.HERE
ROOT = registry.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "torchio_tpu"}
PROGRAM = "torchio_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_program_prefix_is_not_the_jax_package():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert PROGRAM.startswith("torchio_tpu")


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported(path)


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench import harness, registry\n"
        "cell = registry.cell('brats-preprocess-b4')\n"
        "harness.run(cell, 3, 0.3, True, 'cpu', started=time.perf_counter(), shape=(32, 30, 28),"
        " batch=2, log=lambda *_: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1].replace("'", '"')))
    assert PROGRAM in loaded
    assert not loaded & FORBIDDEN


def test_the_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    from port_bench import harness

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib.xla_client"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "torchio_tpu_torchvision", object())
    assert harness.forbidden_modules() == []


def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: a run would measure")


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    no_card()
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "t1-headline-b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_checkout_of_only_the_benchmark_exits_non_zero(tmp_path):
    no_card()
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, f"{HERE.name}/run.py", "--workload", "t1-headline-b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
