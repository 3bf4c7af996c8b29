"""The transform engine's spans (``torchio_tpu_torch.profiling.span``).

On the CPU, at B=2 x 10x12x8:

- under ``torch.profiler`` the headline Compose (fused and unfused) and
  the k-space Compose record exactly the expected ``tio.*`` spans, each
  phase span inside its transform's span (or the composer's), all on
  the calling thread and all plain ``cpu_op`` events (a
  ``user_annotation`` would get a device-side twin on a card);
- with no profiler running no span object is built;
- a profiler changes no output and no history;
- ``profiling.profile()``, which patches ``Transform.forward``, keeps
  the span of ``Transform.__call__``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu_torch as tt
from torchio_tpu_torch import profiling


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def headline(fuse):
    return tt.Compose(
        [
            tt.Spatial(scales=(0.9, 1.1), degrees=10.0, translation=1.0, max_displacement=1.0),
            tt.BiasField(std=0.5),
            tt.Noise(std=0.1),
        ],
        fuse=fuse,
    )


def kspace():
    return tt.Compose([
        tt.Motion(degrees=5, translation=3, num_transforms=1, p=0.5),
        tt.Ghosting(intensity=(0.3, 0.7), p=0.5),
    ])


def batch():
    data = np.random.default_rng(0).random((2, 1, 10, 12, 8)).astype(np.float32)
    return tt.SubjectsBatch.from_subjects([tt.Subject(t1=tt.ScalarImage(d)) for d in data])


def phases(name):
    return [f"tio.{name}", *(f"tio.{name}.{p}" for p in ("draw", "apply", "record"))]


PIPELINES = {
    "headline-fused": (
        lambda: headline(True),
        ["tio.Compose", "tio.Compose.copy", *phases("Spatial"), "tio.BiasField.draw",
         "tio.Noise.draw", "tio.fused.apply", "tio.BiasField.record", "tio.Noise.record"],
    ),
    "headline-unfused": (
        lambda: headline(False),
        ["tio.Compose", "tio.Compose.copy", *phases("Spatial"), *phases("BiasField"),
         *phases("Noise")],
    ),
    "kspace": (kspace, ["tio.Compose", "tio.Compose.copy", *phases("Motion"),
                        *phases("Ghosting")]),
}


def traced(run):
    """The kineto events of ``run()`` under a CPU profiler, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1).add(1)  # an op of the calling thread
        out = run()
    events = sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: (e.start_ns(), -e.duration_ns()))
    return out, events


def enclosing(span, spans):
    """The innermost other span that holds ``span``."""
    holders = [
        s for s in spans if s is not span and s.start_ns() <= span.start_ns()
        and s.start_ns() + s.duration_ns() >= span.start_ns() + span.duration_ns()
    ]
    return max(holders, key=lambda s: s.start_ns()).name() if holders else None


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_the_engine_records_its_spans(pipeline):
    make, want = PIPELINES[pipeline]
    run, data = make(), batch()
    tt.seed(0)
    _, events = traced(lambda: run(data))
    spans = [e for e in events if e.name().startswith("tio.")]
    assert [s.name() for s in spans] == want
    caller = next(e for e in events if e.name() == "aten::add").start_thread_id()
    assert {s.start_thread_id() for s in spans} == {caller}
    assert {s.activity_type() for s in spans} == {"cpu_op"}
    names = {s.name() for s in spans}
    for s in spans[1:]:
        owner = s.name().rsplit(".", 1)[0]
        assert enclosing(s, spans) == (owner if owner in names else "tio.Compose")


def test_no_span_is_built_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} built with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert profiling.span(tt.Noise(), "draw") is profiling.span("fused") is profiling._OFF
    for make, _ in PIPELINES.values():
        make()(batch())
    with pytest.raises(AssertionError, match="span tio.Compose built"):
        traced(lambda: headline(True)(batch()))


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_a_profiler_changes_no_output(pipeline):
    make, _ = PIPELINES[pipeline]
    run, data = make(), batch()
    tt.seed(3)
    plain = run(data)
    tt.seed(3)
    seen, _ = traced(lambda: run(data))
    assert torch.equal(seen.images["t1"].data, plain.images["t1"].data)
    assert seen.applied_transforms == plain.applied_transforms


def test_profile_keeps_the_call_span():
    subject = tt.Subject(t1=tt.ScalarImage(np.full((1, 6, 6, 6), 0.5, np.float32)))
    with profiling.profile() as prof:
        _, events = traced(lambda: tt.Gamma(log_gamma=0.1)(subject))
    assert prof.records.keys() == {"Gamma"}
    spans = [e for e in events if e.name().startswith("tio.")]
    assert [s.name() for s in spans] == ["tio.Gamma", "tio.Gamma.copy", *phases("Gamma")[1:],
                                         "tio.Gamma.record"]
    assert all(enclosing(s, spans) == "tio.Gamma" for s in spans[1:])
