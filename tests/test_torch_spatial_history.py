"""Spatial's drawn geometry in the history: arrays as drawn, JSON on read.

On the CPU, at B=1, 3 and 8 x 12^3 (Spatial, Affine, ElasticDeformation;
per element and batch-shared; with and without p < 1 gates):

- the history records each element's affine (float64 4x4) and coarse
  field (float32) as the read-only arrays drawn, in a list an element
  (``None`` where an element drew nothing or was gated out);
- ``AppliedTransform.params`` gives the nested lists of Python floats
  that ``tolist()`` of the recorded arrays gives, equal to the JAX
  package's params from the same seed, and survives ``json.dumps``;
- ``unbatch()`` slices the history to the same per-subject records;
- the inverse and the forward built from the arrays equal those built
  from the JSON-loaded lists, bit for bit, and inverting a drawn history
  (whole or unbatched) reads its arrays without making them JSON;
- the first read converts once, inside the span ``tio.<T>.resolve``,
  and a record with nothing to convert opens no span;
- a B=8 record holds O(B) Python containers, not O(B n^3).
"""

from __future__ import annotations

import contextlib
import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_config3 import make_batches
from torchio_tpu import random as jax_random
from torchio_tpu_torch.transforms import transform as port_transform

SHAPE = (12, 12, 12)
ISO = (1.0, 1.0, 1.0)
GEOMETRY = {"affine_matrix": np.float64, "control_points": np.float32}

TRANSFORMS = {
    "spatial": lambda pkg, **kw: pkg.Spatial(
        scales=(0.9, 1.1), degrees=(-10, 10), translation=(-1, 1), max_displacement=1.0, **kw
    ),
    "affine": lambda pkg, **kw: pkg.Affine(scales=(0.9, 1.1), degrees=(-10, 10), **kw),
    "elastic": lambda pkg, **kw: pkg.ElasticDeformation(max_displacement=1.0, **kw),
}

CASES = [
    pytest.param(name, b, per_instance, p, id=f"{name}-b{b}-{mode}-p{p}")
    for name in TRANSFORMS
    for b in (1, 3, 8)
    for per_instance, mode in ((True, "per-element"), (False, "shared"))
    for p in (1.0, 0.5)
]


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def batches(b, seed=0):
    return make_batches(b=b, shape=SHAPE, spacing=ISO, channels=1, seed=seed)


def applied(name, b, seed=3, **kwargs):
    """The port's transform, output, record and seed: the first seed from
    ``seed`` on whose gates keep at least one element."""
    transform = TRANSFORMS[name](tt, **kwargs)
    for seed in range(seed, seed + 16):
        tt.seed(seed)
        out = transform(batches(b)[1])
        if out.applied_transforms:
            return transform, out, out.applied_transforms[-1], seed
    raise AssertionError("every seed gated the transform out")


def parent_json(raw):
    """What the history recorded before arrays: each geometry array as
    ``np.asarray(x, dtype).tolist()``, element by element."""
    out = dict(raw)
    for key, dtype in GEOMETRY.items():
        if key not in raw:
            continue
        value = raw[key]
        if "_batched_keys" in raw:
            out[key] = [None if v is None else np.asarray(v, dtype).tolist() for v in value]
        else:
            out[key] = None if value is None else np.asarray(value, dtype).tolist()
    return out


def jax_params(name, b, seed, **kwargs):
    """The JAX package's params from the same seed and the same draws
    (the p-gate coin first where the gate is batch-wide), or None."""
    transform = TRANSFORMS[name](tj, **kwargs)
    batch = batches(b)[0]
    tj.seed(seed)
    if not transform._per_instance_p_active(batch) and float(jax_random.random()) >= kwargs["p"]:
        return None
    params = transform.make_params(batch)
    keep = params.get("_keep")
    if keep is not None and not any(keep):
        return None
    return json.loads(json.dumps(params))


def leaves(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from leaves(v)
    else:
        yield value


def containers(value) -> int:
    """Python lists, tuples and dicts reachable from ``value`` (arrays are
    leaves)."""
    if isinstance(value, dict):
        return 1 + sum(containers(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return 1 + sum(containers(v) for v in value)
    return 0


@pytest.mark.parametrize("name,b,per_instance,p", CASES)
def test_history_reads_as_the_drawn_lists(name, b, per_instance, p):
    _, _, record, seed = applied(name, b, per_instance=per_instance, p=p)
    want = jax_params(name, b, seed, per_instance=per_instance, p=p)
    raw = record.raw_params()
    per_element = "_batched_keys" in raw
    assert per_element == (per_instance and b > 1)
    for key, dtype in GEOMETRY.items():
        drawn = raw[key] if per_element else [raw[key]]
        if per_element:
            assert type(raw[key]) is list and len(raw[key]) == b
        for array in drawn:
            assert array is None or (
                type(array) is np.ndarray and array.dtype == dtype and not array.flags.writeable
            )
    expected = parent_json(raw)
    params = record.params
    assert params == expected
    assert all(v is None or type(v) is float for k in GEOMETRY for v in leaves(params[k]))
    assert json.loads(json.dumps(params)) == params
    assert json.loads(json.dumps(params, sort_keys=True)) == want


@pytest.mark.parametrize("name,b,per_instance,p", [c for c in CASES if c.values[1] > 1])
def test_unbatch_slices_the_same_histories(name, b, per_instance, p):
    _, out, record, _ = applied(name, b, per_instance=per_instance, p=p)
    params = parent_json(record.raw_params())
    keep = params.get("_keep")
    for index, subject in enumerate(out.unbatch()):
        if keep is not None and not keep[index]:
            assert subject.applied_transforms == []
            continue
        (got,) = subject.applied_transforms
        want = {
            k: v[index] if k in params.get("_batched_keys", ()) else v
            for k, v in params.items()
            if k not in ("_batch_size", "_batched_keys", "_keep")
        }
        assert got.params == want
        assert got == port_transform.AppliedTransform(record.name, want)


@pytest.mark.parametrize("per_instance", [True, False], ids=["per-element", "shared"])
def test_arrays_and_json_lists_apply_and_invert_alike(per_instance):
    transform, out, record, _ = applied("spatial", 3, per_instance=per_instance, p=0.7, seed=5)
    raw = record.raw_params()
    loaded = json.loads(json.dumps(record.params))
    forward = [
        TRANSFORMS["spatial"](tt).apply_transform(batches(3)[1], params)
        for params in (raw, loaded)
    ]
    backward = [
        transform.inverse(params).apply_transform(copy.deepcopy(out), params)
        for params in (raw, loaded)
    ]
    for a, b in (forward, backward):
        for image in ("ch", "seg"):
            assert torch.equal(a.images[image].data, b.images[image].data)
            assert all(
                np.array_equal(x.data, y.data)
                for x, y in zip(a.images[image].affines, b.images[image].affines)
            )
    assert torch.equal(forward[0].ch.data, out.ch.data)


@pytest.mark.parametrize("per_instance", [True, False], ids=["per-element", "shared"])
def test_inverting_a_drawn_history_reads_its_arrays(per_instance):
    _, out, record, _ = applied("spatial", 3, per_instance=per_instance, p=0.7, seed=5)
    loaded = copy.deepcopy(out)
    params = json.loads(json.dumps(parent_json(record.raw_params())))
    loaded.applied_transforms = [port_transform.AppliedTransform(record.name, params)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inverted = [x.apply_inverse_transform() for x in (out, *out.unbatch())]
    assert [e.name for e in prof.events() if e.name.endswith(".resolve")] == []
    drawn = record.raw_params()["control_points"]
    drawn = drawn if per_instance else [drawn]
    assert all(cp is None or type(cp) is np.ndarray for cp in drawn)
    assert any(cp is not None for cp in drawn)
    replayed = [x.apply_inverse_transform() for x in (loaded, *loaded.unbatch())]
    assert len(inverted) == len(replayed) == 4
    for a, b in zip(inverted, replayed):
        for image in ("ch", "seg"):
            assert torch.equal(a[image].data, b[image].data)


def test_a_history_read_twice_converts_once(monkeypatch):
    record = applied("spatial", 3)[2]
    calls = []
    monkeypatch.setattr(
        port_transform, "span",
        lambda owner, phase=None: calls.append((owner, phase)) or contextlib.nullcontext(),
    )
    first = record.params
    assert calls == [("Spatial", "resolve")]
    walks = []
    for name in ("_holds", "json_params"):
        walk = getattr(port_transform, name)
        monkeypatch.setattr(
            port_transform, name, lambda *args, walk=walk: walks.append(1) or walk(*args)
        )
    assert record.params is first and record.raw_params() is first
    assert calls == [("Spatial", "resolve")] and walks == []
    record.params = {"control_points": np.zeros((4, 4, 4, 3), np.float32)}
    assert record.params == {"control_points": np.zeros((4, 4, 4, 3)).tolist()}
    assert calls == [("Spatial", "resolve")] * 2 and walks


def resolve_spans(record) -> list[str]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        record.params
        record.params
    return [e.name for e in prof.events() if e.name.endswith(".resolve")]


def spatial_record():
    return applied("spatial", 3)[2]


def rescale_record():
    tt.seed(1)
    out = tt.RescaleIntensity(out_min=0.0, out_max=1.0)(batches(2)[1])
    return out.applied_transforms[0]


def flip_record():
    tt.seed(1)
    return tt.Flip(axes=(0,))(batches(2)[1]).applied_transforms[0]


def json_loaded_record():
    record = spatial_record()
    params = json.loads(json.dumps(record.params))
    return port_transform.AppliedTransform(record.name, params)


@pytest.mark.parametrize(
    "make,spans",
    [
        (spatial_record, ["tio.Spatial.resolve"]),
        (rescale_record, ["tio.Normalize.resolve"]),  # RescaleIntensity's class
        (flip_record, []),
        (json_loaded_record, []),
    ],
    ids=["spatial-arrays", "deferred-statistic", "lists-only", "json-loaded"],
)
def test_the_resolve_span_opens_only_where_params_convert(make, spans):
    assert resolve_spans(make()) == spans


@pytest.mark.parametrize("per_instance", [True, False], ids=["per-element", "shared"])
def test_a_b8_history_holds_containers_by_element_not_by_number(per_instance):
    counts = []
    for grid in (5, 7, 10):
        transform = tt.Spatial(
            degrees=(-10, 10), max_displacement=0.5, num_control_points=grid,
            per_instance=per_instance,
        )
        tt.seed(2)
        out = transform(batches(8)[1])
        raw = out.applied_transforms[0].raw_params()
        counts.append(containers(raw))
        # the parent's lists: a field of n^3 x 3 numbers is 1 + n + n^2 lists
        assert containers(parent_json(raw)) - counts[-1] >= grid**2 * (8 if per_instance else 1)
    assert counts[0] == counts[1] == counts[2]
    assert counts[0] < 64
