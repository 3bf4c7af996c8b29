"""Port parity: ``torchio_tpu_torch.profiling`` against ``torchio_tpu.profiling``.

On the CPU, with the same data and seed in both packages:

- the report's names and call counts equal the JAX package's for the
  headline Compose fused (the fused BiasField + Noise stage runs inside
  Compose, so only Spatial is timed) and unfused, for single transforms
  on an Image and on a Subject, and its header line is equal;
- ``Transform.forward`` is restored, also after an exception;
- ``trace`` writes a ``torch.profiler`` trace under its directory, and a
  second trace cannot start while one is active;
- the one deliberate divergence from ``tests/test_profiling.py:79``
  (``test_sync_failure_is_swallowed``): the port synchronises the card
  with ``torch.cuda.synchronize`` for each CUDA device among a result's
  tensors, and a failure there propagates, because a failed kernel must
  not be timed as a success. The synchronisation is simulated with a
  result that reports a CUDA device.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import profiling as jax_profiling
from torchio_tpu_torch import profiling as port_profiling

PACKAGES = ((tj, jax_profiling), (tt, port_profiling))


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def headline(pkg, fuse):
    return pkg.Compose(
        [
            pkg.Spatial(scales=(0.9, 1.1), degrees=10.0, translation=1.0, max_displacement=1.0),
            pkg.BiasField(std=0.5),
            pkg.Noise(std=0.1),
        ],
        fuse=fuse,
    )


def batch(pkg, b=2, shape=(10, 12, 8)):
    data = np.random.default_rng(0).random((b, 1, *shape)).astype(np.float32)
    return pkg.SubjectsBatch.from_subjects([pkg.Subject(t1=pkg.ScalarImage(d)) for d in data])


def records(pkg, profiling, run):
    with profiling.profile() as prof:
        run(pkg)
    return prof


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_headline_report_equal_jax(fuse):
    counts = []
    for pkg, profiling in PACKAGES:
        pipeline, data = headline(pkg, fuse), batch(pkg)
        pkg.seed(0)
        with profiling.profile() as prof:
            for _ in range(3):
                pipeline(data)
        counts.append({name: len(times) for name, times in prof.records.items()})
        assert all(prof.total(name) > 0 for name in prof.records)
        assert prof.report().splitlines()[0] == "transform            calls   total(s)   mean(ms)"
        assert len(prof.report().splitlines()) == 1 + len(prof.records)
    assert counts[1] == counts[0]
    want = {"Spatial": 3} if fuse else {"Spatial": 3, "BiasField": 3, "Noise": 3}
    assert counts[1] == want


RUNS = {
    "image": lambda pkg: pkg.Flip(axes=0, p=1.0)(
        pkg.ScalarImage(np.ones((1, 4, 4, 4), np.float32))
    ),
    "subject-twice": lambda pkg: [
        pkg.Gamma(log_gamma=0.1)(
            pkg.Subject(t1=pkg.ScalarImage(np.full((1, 6, 6, 6), 0.5, np.float32)))
        )
        for _ in range(2)
    ],
    "tensor": lambda pkg: pkg.Flip(axes=1)(np.ones((1, 4, 5, 6), np.float32)),
    "gated-out": lambda pkg: pkg.Noise(std=0.1, p=0.0)(
        pkg.ScalarImage(np.ones((1, 4, 4, 4), np.float32))
    ),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_report_names_equal_jax(run):
    reports = [records(pkg, profiling, RUNS[run]) for pkg, profiling in PACKAGES]
    want, got = ({n: len(t) for n, t in r.records.items()} for r in reports)
    assert got == want
    assert reports[1].total("NeverRan") == 0.0


def test_report_format():
    prof = port_profiling._Profile()
    prof.add("Flip", 0.25)
    prof.add("Flip", 0.75)
    prof.add("Gamma", 2.0)
    jax_prof = jax_profiling._Profile()
    jax_prof.records = prof.records
    assert prof.report() == jax_prof.report()
    assert prof.report().splitlines()[1].startswith("Gamma")
    assert prof.total("Flip") == 1.0


def test_forward_restored():
    original = tt.Transform.forward
    with port_profiling.profile():
        assert tt.Transform.forward is not original
    assert tt.Transform.forward is original
    with pytest.raises(ValueError, match="boom"), port_profiling.profile():
        raise ValueError("boom")
    assert tt.Transform.forward is original
    assert not port_profiling._active


def test_trace_writes_a_trace(tmp_path):
    subject = tt.Subject(t1=tt.ScalarImage(np.ones((1, 4, 4, 4), np.float32)))
    with port_profiling.trace(str(tmp_path / "trace")):
        tt.Flip(axes=(0,))(subject)
        with pytest.raises(RuntimeError, match="already active"):
            port_profiling.start_trace(str(tmp_path / "other"))
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("flip" in str(event.get("name", "")).lower() for event in events)
    with pytest.raises(RuntimeError, match="No trace"):
        port_profiling.stop_trace()


def test_sync_failure_propagates(monkeypatch):
    """The deliberate divergence from the JAX package, which swallows a
    failed ``block_until_ready``: here the error of the synchronisation
    reaches the caller and the transform is not recorded."""
    synchronized = []

    def failing_synchronize(device=None):
        synchronized.append(device)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", failing_synchronize)
    image = tt.ScalarImage(np.ones((1, 4, 4, 4), np.float32))
    flipped = tt.Flip(axes=0, p=1.0)(image)  # no profile: nothing synchronises
    # the result of the next call reports the card (its data stays on the CPU)
    monkeypatch.setattr(tt.ScalarImage, "device", property(lambda self: torch.device("cuda", 0)))
    with port_profiling.profile() as prof:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            tt.Flip(axes=0, p=1.0)(flipped)
    assert synchronized == [torch.device("cuda", 0)]
    assert "Flip" not in prof.records  # not timed as a success


def test_synchronize_waits_for_each_cuda_device(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.append(device))
    held = [torch.device("cuda", 0), torch.device("cuda", 1), torch.device("cuda", 0), None]
    result = types.SimpleNamespace(
        images={name: types.SimpleNamespace(device=d) for name, d in zip("abcd", held)}
    )
    port_profiling.synchronize(result)
    assert sorted(str(d) for d in seen) == ["cuda:0", "cuda:1"]
    port_profiling.synchronize(np.zeros(3))
    port_profiling.synchronize(tt.ScalarImage(np.zeros((1, 2, 2, 2), np.float32)))
    port_profiling.synchronize({"t1": torch.zeros(2)})
    assert len(seen) == 2
