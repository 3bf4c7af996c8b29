"""Repo-wide test isolation for the JAX package's float16 corner gather.

Importing ``bench.py`` runs ``os.environ.setdefault("TORCHIO_TPU_GATHER16",
"1")``, and ``torchio_tpu.config.gather16()`` reads that variable (and
``torchio_tpu.config.use_gather16``) on every resample call. A test that
imports ``bench.py`` (``tests/test_parallel.py::test_bench_mesh_smoke``)
would otherwise turn the opt-in gather on for every later test of its
process, and a later test that holds the exact float32 gather to 1e-4
would fail depending on which test ran before it on that worker.

This fixture saves both settings before each test and restores them
after it: the variable is deleted again when it was absent. The JAX
package is not imported here: when ``torchio_tpu.config`` is not loaded
yet, its ``use_gather16`` still has the module's default, None.
"""

from __future__ import annotations

import os
import sys

import pytest

_GATHER16_ENV = "TORCHIO_TPU_GATHER16"
_CONFIG_MODULE = "torchio_tpu.config"


@pytest.fixture(autouse=True)
def _restore_gather16():
    env = os.environ.get(_GATHER16_ENV)
    module = sys.modules.get(_CONFIG_MODULE)
    flag = None if module is None else module.use_gather16
    yield
    if env is None:
        os.environ.pop(_GATHER16_ENV, None)
    else:
        os.environ[_GATHER16_ENV] = env
    module = sys.modules.get(_CONFIG_MODULE)
    if module is not None:
        module.use_gather16 = flag
