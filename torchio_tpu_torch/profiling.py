"""Profiling hooks: per-transform wall timing, ``torch.profiler`` traces
and the transform engine's spans.

Counterpart of ``torchio_tpu/profiling.py``. Usage::

    with torchio_tpu_torch.profiling.profile() as prof:
        augmented = pipeline(subject)
    print(prof.report())

    with torchio_tpu_torch.profiling.trace("traces/run1"):
        pipeline(subject)          # a Chrome/TensorBoard trace under the directory

:func:`profile` times each transform's ``forward`` up to the end of the
card's work on its result: it synchronises every CUDA device that holds
one of the result's tensors. A failed synchronisation (a kernel fault
surfaces there) raises; it is never timed as a success.

The transform engine marks its host phases with :func:`span`, so that a
profiler shows where a call's host time goes:

- ``tio.<Transform>``: one transform's ``__call__`` (``tio.Compose`` for
  the composer, ``tio.OneOf`` and ``tio.SomeOf`` for theirs);
- ``tio.<Transform>.copy``: the deep copy of the input;
- ``tio.<Transform>.draw``: the host draws (``make_params``; in a fused
  ``Compose`` the p-gate coin and ``fused_stage``, which draws);
- ``tio.<Transform>.apply``: ``apply_transform``, the eager ops and
  kernel launches it enqueues; ``tio.fused.apply`` for a fused run's
  stages;
- ``tio.<Transform>.record``: the history (``record_history``, a fused
  stage's ``finish``, the result's copy of the history).
- ``tio.<Transform>.resolve``: a history record made JSON on the first
  read of its ``params`` (arrays to lists, deferred statistics to their
  values), where it holds something to convert.

They are plain host events of the calling thread (``cpu_op``), with no
device-side twin, so a trace's device timeline holds only the card's
own work. :func:`trace` writes them into the Perfetto/TensorBoard trace
beside every aten op, runtime call and kernel. With no profiler running
a span costs one flag check and builds nothing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Any

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_active: list["_Profile"] = []
_trace: list[Any] = []


class _Profile:
    def __init__(self) -> None:
        self.records: dict[str, list[float]] = defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self.records[name].append(seconds)

    def report(self) -> str:
        lines = ["transform            calls   total(s)   mean(ms)"]
        for name, times in sorted(self.records.items(), key=lambda kv: -sum(kv[1])):
            total = sum(times)
            lines.append(
                f"{name:<20} {len(times):>5}   {total:>8.3f}   "
                f"{1000 * total / len(times):>8.1f}"
            )
        return "\n".join(lines)

    def total(self, name: str) -> float:
        return sum(self.records.get(name, []))


#: the context every span site gets while no profiler runs
_OFF = contextlib.nullcontext()


def span(owner: Any, phase: str | None = None):
    """A profiler span named ``tio.<owner>`` or ``tio.<owner>.<phase>``:
    ``owner`` is a transform (its class name) or a name. While no
    profiler runs it returns one shared no-op context and builds no
    name."""
    if not _profiler_enabled():
        return _OFF
    name = owner if isinstance(owner, str) else type(owner).__name__
    return _RecordFunctionFast(f"tio.{name}" if phase is None else f"tio.{name}.{phase}")


def _devices(result: Any) -> set[torch.device]:
    """The devices of the tensors a transform returned (an unloaded image
    holds none and is not loaded)."""
    from .data.batch import ImagesBatch
    from .data.image import Image

    if hasattr(result, "images"):  # Subject (Images) or SubjectsBatch (ImagesBatches)
        found = {image.device for image in result.images.values()}
    elif isinstance(result, (torch.Tensor, Image, ImagesBatch)):
        found = {result.device}
    elif isinstance(result, dict):
        found = {v.device for v in result.values() if isinstance(v, torch.Tensor)}
    else:  # numpy: on the host already
        found = set()
    return {d for d in found if d is not None}


def synchronize(result: Any) -> None:
    """Wait for the card's work on ``result``: ``torch.cuda.synchronize``
    for each CUDA device among its tensors. Errors propagate."""
    for device in _devices(result):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile():
    """Record synchronised wall time of every transform application."""
    from .transforms.transform import Transform

    prof = _Profile()
    original = Transform.forward

    def timed_forward(self: Transform, data: Any) -> Any:
        t0 = time.perf_counter()
        result = original(self, data)
        synchronize(result)  # time the card's work, not its queueing
        prof.add(type(self).__name__, time.perf_counter() - t0)
        return result

    Transform.forward = timed_forward  # type: ignore[method-assign]
    _active.append(prof)
    try:
        yield prof
    finally:
        _active.remove(prof)
        Transform.forward = original  # type: ignore[method-assign]


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace of the host and, where a card is
    present, its kernels; :func:`stop_trace` writes it under ``log_dir``
    (a ``*.pt.trace.json`` file for TensorBoard or Perfetto). One trace
    at a time."""
    if _trace:
        raise RuntimeError("A trace is already active: stop it first")
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    tracer = torch.profiler.profile(
        activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))
    )
    tracer.start()
    _trace.append(tracer)


def stop_trace() -> None:
    if not _trace:
        raise RuntimeError("No trace is active")
    tracer = _trace.pop()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    tracer.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Context-managed ``torch.profiler`` trace written under ``log_dir``."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
