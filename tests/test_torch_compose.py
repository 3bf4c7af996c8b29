"""Port parity: OneOf, SomeOf and the per-element history against the JAX
package.

The same numpy volumes (B=4 x 24^3 at 1 mm unless stated) go through
``torchio_tpu`` and ``torchio_tpu_torch`` on the CPU from one seed:

- OneOf (a list or a weight dict) and SomeOf (``num_transforms`` an int
  or a range, with and without ``replace``), per instance and batch-wide,
  at p = 0, 0.5 and 1: images within 1e-5, labels equal, every element's
  history equal as JSON, the same next host draw (so the host streams
  stayed in step); the seeds pick every branch;
- a batch of one (the batch-wide branch), ``|`` and ``+`` flattening,
  ``to_hydra`` with ``torchio_tpu.`` mapped to ``torchio_tpu_torch.``;
- the re-stack's errors (shapes: a per-instance OneOf over Resamples of
  different targets; names and types), with the JAX package's messages;
- ``unbatch`` (frozen per-element history, then the batch-wide suffix),
  ``get_inverse_transform`` raising, ``apply_inverse_transform`` within
  1e-4;
- the docs' composition policy (``docs/tutorials/augmentation.md:82-91``:
  Flip, Spatial, a SomeOf of BiasField, Blur and Gamma, RescaleIntensity)
  and k-space OneOf (``:48-52``: Motion, Ghosting, Spike by weight):
  images within 1e-4 (the pipelines' bound), labels equal (off near ties
  of Spatial's nearest resample in the policy);
- ``Queue.device_batches(prep_batch > 1)``'s check sees the children of
  OneOf and SomeOf.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_config3 import make_batches, nearest_ties, spatial_grids
from torchio_tpu import config as jax_config
from torchio_tpu.transforms import compose as jax_compose
from torchio_tpu_torch.transforms import compose as port_compose

STEP_ATOL = 1e-5
PIPELINE_ATOL = 1e-4
SHAPE = (24, 24, 24)
ISO = (1.0, 1.0, 1.0)


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference to its exact float32 corner gather (see
    ``tests/test_torch_inverse.py``)."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def batches(b=4, name="t1", labels=True, seed=0, shape=SHAPE):
    return make_batches(
        b=b, shape=shape, spacing=ISO, channels=1, name=name, labels=labels, seed=seed
    )


#: history keys whose values are statistics of the data (not host draws):
#: their floats are held to STEP_ATOL, every other leaf is equal
DATA_STATS = ("in_ranges", "stats")


def histories(out):
    """Every element's history as JSON (name, params, include, exclude),
    parsed back."""
    subjects = out.unbatch() if hasattr(out, "unbatch") else [out]
    return [
        json.loads(
            json.dumps(
                [[h.name, h.params, h.include, h.exclude] for h in s.applied_transforms],
                sort_keys=True,
            )
        )
        for s in subjects
    ]


def assert_json_equal(got, want, stats=False):
    """Equal JSON trees; floats under DATA_STATS keys within STEP_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for key in want:
            assert_json_equal(got[key], want[key], stats or key in DATA_STATS)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_json_equal(g, w, stats)
    elif stats and isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= STEP_ATOL
    else:
        assert got == want and type(got) is type(want)


def run_both(make, seed, b=4, labels=True, batch_seed=0):
    """``make(pkg)`` on the same batch in both packages from one seed:
    (jax output, port output); histories equal and the next host draw
    equal."""
    outs, draws = [], []
    for pkg, batch in zip((tj, tt), batches(b=b, labels=labels, seed=batch_seed)):
        transform = make(pkg)
        pkg.seed(seed)
        outs.append(transform(batch))
        draws.append(float(pkg.random.random()))
    assert draws[0] == draws[1]
    jax_out, port_out = outs
    assert_json_equal(histories(port_out), histories(jax_out))
    assert (jax_out._per_element_history is None) == (port_out._per_element_history is None)
    return jax_out, port_out


def assert_close(jax_out, port_out, atol, names=("t1",)):
    for name in names:
        want = np.asarray(jax_out.images[name].data)
        got = port_out.images[name].data.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        for a, c in zip(jax_out.images[name].affines, port_out.images[name].affines):
            np.testing.assert_array_equal(a.data, c.data)


def branch_names(out):
    return [[h.name for h in s.applied_transforms] for s in out.unbatch()]


def policy_pipeline(pkg):
    """``docs/tutorials/augmentation.md:82-91``."""
    return pkg.Compose(
        [
            pkg.Flip(axes=(0,), p=0.5),
            pkg.Spatial(scales=(0.95, 1.05), degrees=5.0),
            pkg.SomeOf(
                [pkg.BiasField(), pkg.Blur(std=(0.1, 0.8)), pkg.Gamma()],
                num_transforms=(0, 2),
            ),
            pkg.RescaleIntensity(out_min=0.0, out_max=1.0),
        ]
    )


def kspace_pipeline(pkg):
    """``docs/tutorials/augmentation.md:48-52``."""
    return pkg.OneOf({pkg.Motion(): 0.5, pkg.Ghosting(): 0.3, pkg.Spike(): 0.2})



# --- OneOf and SomeOf ----------------------------------------------------------


def oneof_children(pkg):
    return [
        pkg.Flip(axes=(0, 1, 2), flip_probability=1.0),
        pkg.Gamma(log_gamma=(-0.3, 0.3)),
        pkg.Noise(std=0.1),
    ]


def make_oneof(weights, p, per_instance):
    def make(pkg):
        children = oneof_children(pkg)
        spec = dict(zip(children, (0.2, 0.5, 0.3))) if weights else children
        return pkg.OneOf(spec, p=p, per_instance=per_instance)

    return make


#: seeds whose draws pick every branch, batch-wide and per instance
SEEDS = (2, 8, 11, 22)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("per_instance", [True, False], ids=["per-instance", "batch-wide"])
@pytest.mark.parametrize("weights", [False, True], ids=["list", "weights"])
def test_oneof_matches_jax(weights, p, per_instance):
    chosen = set()
    for seed in SEEDS:
        jax_out, port_out = run_both(make_oneof(weights, p, per_instance), seed)
        assert_close(jax_out, port_out, STEP_ATOL)
        np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))
        chosen |= {name for names in branch_names(port_out) for name in names}
        if per_instance and 0 < p:
            assert port_out._per_element_history is not None
    if p == 0:
        assert chosen == set()
    else:  # the seeds pick every branch
        assert chosen == {"Flip", "Gamma", "Noise"}


def make_someof(num_transforms, replace, p, per_instance):
    def make(pkg):
        return pkg.SomeOf(
            oneof_children(pkg), num_transforms=num_transforms, replace=replace, p=p,
            per_instance=per_instance,
        )

    return make


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("per_instance", [True, False], ids=["per-instance", "batch-wide"])
@pytest.mark.parametrize(
    "num_transforms, replace", [(2, False), ((0, 2), False), ((1, 3), True)],
    ids=["two", "range", "replace"],
)
def test_someof_matches_jax(num_transforms, replace, p, per_instance):
    counts = set()
    for seed in SEEDS:
        jax_out, port_out = run_both(make_someof(num_transforms, replace, p, per_instance), seed)
        assert_close(jax_out, port_out, STEP_ATOL)
        np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))
        counts |= {len(names) for names in branch_names(port_out)}
    if p == 0:
        assert counts == {0}
    elif per_instance and isinstance(num_transforms, tuple):
        assert len(counts) > 1  # the elements drew different subset sizes


@pytest.mark.parametrize("composer", ["OneOf", "SomeOf"])
def test_a_batch_of_one_takes_the_batch_wide_branch(composer):
    def make(pkg):
        if composer == "OneOf":
            return pkg.OneOf(oneof_children(pkg))
        return pkg.SomeOf(oneof_children(pkg), num_transforms=(1, 2))

    for seed in SEEDS:
        jax_out, port_out = run_both(make, seed, b=1)
        assert port_out._per_element_history is None
        assert_close(jax_out, port_out, STEP_ATOL)


def test_a_subject_goes_through_oneof_with_its_history():
    subjects = [batch.unbatch()[0] for batch in batches(b=1)]
    outs = []
    for pkg, subject in zip((tj, tt), subjects):
        pkg.seed(3)
        outs.append(pkg.OneOf(oneof_children(pkg))(subject))
    assert_json_equal(histories(outs[1]), histories(outs[0]))
    np.testing.assert_allclose(
        outs[1].t1.data.numpy(), np.asarray(outs[0].t1.data), rtol=0, atol=STEP_ATOL
    )


# --- operators and hydra ---------------------------------------------------------


def structure(transform):
    children = getattr(transform, "transforms", None)
    if children is None:
        return type(transform).__name__
    return [type(transform).__name__, [structure(t) for t in children]]


def operators(pkg):
    flip, noise, gamma = pkg.Flip(axes=(0,)), pkg.Noise(std=0.1), pkg.Gamma()
    motion, ghost = pkg.Motion(), pkg.Ghosting()
    return {
        "or": flip | noise,
        "or-chain": (flip | noise) | gamma,
        "or-of-oneofs": pkg.OneOf([flip, noise]) | pkg.OneOf([gamma, motion]),
        "plus-chain": flip + noise + gamma,
        "mixed": (flip + noise) | (motion | ghost),
    }


@pytest.mark.parametrize("name", list(operators(tt)))
def test_operators_flatten_as_in_jax(name):
    port, ref = operators(tt)[name], operators(tj)[name]
    assert structure(port) == structure(ref)
    if isinstance(port, tt.OneOf):
        assert port.weights == ref.weights


def test_operators_refuse_non_transforms():
    with pytest.raises(TypeError):
        tt.Flip() | 3
    with pytest.raises(TypeError):
        tt.Flip() + "noise"


def map_prefix(cfg):
    """A JAX package hydra config with its ``_target_`` prefix mapped."""
    if isinstance(cfg, dict):
        return {
            k: (v.replace("torchio_tpu.", "torchio_tpu_torch.", 1) if k == "_target_" else map_prefix(v))
            for k, v in cfg.items()
        }
    if isinstance(cfg, list):
        return [map_prefix(v) for v in cfg]
    return cfg


def hydra_pipelines(pkg):
    return {
        "policy": policy_pipeline(pkg),
        "kspace": kspace_pipeline(pkg),
        "someof-replace": pkg.SomeOf(
            [pkg.Noise(std=(0.0, 0.2)), pkg.Blur(std=1.0)], num_transforms=(1, 3),
            replace=True, p=0.7, per_instance=False,
        ),
        "nested": pkg.Compose(
            [pkg.OneOf([pkg.Flip(axes=(1, 2)), pkg.Clamp(out_min=0.0)]), pkg.Mask(labels=[1])],
            fuse=True, exclude=["seg"],
        ),
        "zoo": pkg.Compose(
            [pkg.Standardize(masking_method="seg"), pkg.ZNormalization(), pkg.Clamp(out_max=2.0)]
        ),
    }


@pytest.mark.parametrize("name", list(hydra_pipelines(tt)))
def test_to_hydra_equals_jax_with_the_prefix_mapped(name):
    port = hydra_pipelines(tt)[name].to_hydra()
    ref = hydra_pipelines(tj)[name].to_hydra()
    assert port == map_prefix(ref)
    assert port["_target_"].startswith("torchio_tpu_torch.")
    json.dumps(port)


# --- re-stacking, unbatch and the inverse ---------------------------------------


def test_mixed_shapes_refuse_to_restack_with_the_jax_message():
    def make(pkg):
        return pkg.OneOf([pkg.Resample(target=1.0), pkg.Resample(target=2.0)])

    messages = []
    for pkg, batch in zip((tj, tt), batches(labels=False)):
        pkg.seed(0)
        with pytest.raises(RuntimeError) as error:
            make(pkg)(batch)
        messages.append(str(error.value))
    assert messages[0] == messages[1]
    assert "different shapes or schemas" in messages[1]


def test_mixed_schemas_refuse_to_restack_with_the_jax_message():
    messages = []
    for pkg, compose in ((tj, jax_compose), (tt, port_compose)):
        data = np.zeros((1, 4, 4, 4), np.float32)
        subjects = [
            pkg.Subject(t1=pkg.ScalarImage(data.copy())),
            pkg.Subject(t1=pkg.LabelMap(data.copy())),
        ]
        with pytest.raises(RuntimeError) as error:
            compose._check_consistent_schema(subjects, "SomeOf")
        messages.append(str(error.value))
    assert messages[0] == messages[1]
    assert "image names or types" in messages[1]


def test_unbatch_puts_the_frozen_history_before_the_batch_wide_suffix():
    def make(pkg):
        return pkg.Compose(
            [pkg.OneOf(oneof_children(pkg)), pkg.RescaleIntensity(out_min=0.0, out_max=1.0)]
        )

    jax_out, port_out = run_both(make, 2)
    assert [h.name for h in port_out.applied_transforms] == ["Normalize"]
    for jax_subject, port_subject in zip(jax_out.unbatch(), port_out.unbatch()):
        names = [h.name for h in port_subject.applied_transforms]
        assert len(names) == 2 and names[-1] == "Normalize"
        np.testing.assert_allclose(
            port_subject.t1.data.numpy(), np.asarray(jax_subject.t1.data), rtol=0, atol=STEP_ATOL
        )


def test_set_per_element_history_checks_the_count():
    batch = batches(b=2)[1]
    with pytest.raises(ValueError, match="Expected 2 per-element histories, got 3"):
        batch.set_per_element_history([[], [], []])
    batch.applied_transforms = ["x"]
    batch.set_per_element_history([["a"], ["b"]])
    assert batch.applied_transforms == []
    assert [s.applied_transforms for s in batch.unbatch()] == [["a"], ["b"]]
    batch.clear_history()
    assert batch._per_element_history is None and batch.applied_transforms == []


@pytest.mark.parametrize("per_element", [True, False])
def test_adopt_history_follows_the_source(per_element):
    source = batches(b=2)[1]
    if per_element:
        source.set_per_element_history([["a"], ["b"]])
    else:
        source.applied_transforms = ["shared"]
    subjects = source.unbatch()
    target = tt.SubjectsBatch.from_subjects(subjects)
    target.adopt_history(source, subjects)
    if per_element:
        assert target._per_element_history == [["a"], ["b"]]
    else:
        assert target.applied_transforms == ["shared"] and target._per_element_history is None


def invertible_oneof(pkg):
    return pkg.Compose(
        [
            pkg.OneOf(
                [pkg.Affine(degrees=(5.0, 10.0)), pkg.Flip(axes=(0, 1), flip_probability=1.0),
                 pkg.RescaleIntensity(out_min=-1.0, out_max=2.0)]
            ),
            pkg.Gamma(log_gamma=(-0.2, 0.2)),
        ]
    )


def test_per_element_batch_refuses_a_single_inverse():
    messages = []
    for pkg in (tj, tt):
        batch = batches(labels=False)[0 if pkg is tj else 1]
        pkg.seed(1)
        out = invertible_oneof(pkg)(batch)
        with pytest.raises(RuntimeError) as error:
            out.get_inverse_transform()
        messages.append(str(error.value))
    assert messages[0] == messages[1]
    assert "per-element transform histories" in messages[1]


@pytest.mark.parametrize("seed", [1, 4])
def test_apply_inverse_transform_per_element_matches_jax(seed):
    jax_out, port_out = run_both(invertible_oneof, seed, labels=False)
    assert port_out._per_element_history is not None
    backs = []
    for out in (jax_out, port_out):
        back = out.apply_inverse_transform(warn=False)
        backs.append(back)
        assert back.batch_size == 4
    jax_back, port_back = backs
    assert_close(jax_back, port_back, PIPELINE_ATOL)
    assert all(not s.applied_transforms for s in port_back.unbatch())
    # the module-level entry point delegates to the batch's own
    via_module = tt.apply_inverse_transform(port_out, warn=False)
    np.testing.assert_array_equal(via_module.t1.data.numpy(), port_back.t1.data.numpy())


# --- the docs' pipelines ---------------------------------------------------------


def policy_ties(port_out):
    """Where each element's seg may differ: near ties of its Spatial draw."""
    ties = []
    affine = port_out.seg.affines[0]
    for subject in port_out.unbatch():
        spatial = next(h for h in subject.applied_transforms if h.name == "Spatial")
        maps, fields, out_shape = spatial_grids(spatial.params, affine, SHAPE)
        ties.append(nearest_ties(maps, fields, out_shape)[0])
    return torch.stack(ties)


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_policy_someof_matches_jax(seed):
    jax_out, port_out = run_both(policy_pipeline, seed)
    assert_close(jax_out, port_out, PIPELINE_ATOL)
    got, want = port_out.seg.data.numpy(), np.asarray(jax_out.seg.data)
    assert got.dtype == want.dtype == np.int32
    assert not ((got != want) & ~policy_ties(port_out).numpy()).any()
    names = branch_names(port_out)
    assert all(n[-1] == "Normalize" and "Spatial" in n for n in names)


def test_policy_someof_seeds_draw_every_subset_size():
    sizes = set()
    for seed in (0, 3, 8):
        tt.seed(seed)
        out = policy_pipeline(tt)(batches()[1])
        for names in branch_names(out):
            sizes.add(sum(n in ("BiasField", "Blur", "Gamma") for n in names))
    assert sizes == {0, 1, 2}


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_kspace_oneof_matches_jax(seed):
    jax_out, port_out = run_both(kspace_pipeline, seed)
    assert_close(jax_out, port_out, PIPELINE_ATOL)
    seg_in = batches()[1].seg.data
    assert torch.equal(port_out.seg.data, seg_in)
    np.testing.assert_array_equal(port_out.seg.data.numpy(), np.asarray(jax_out.seg.data))


def test_kspace_oneof_seeds_pick_every_artifact():
    chosen = set()
    for seed in (0, 2, 5):
        tt.seed(seed)
        out = kspace_pipeline(tt)(batches()[1])
        chosen |= {n for names in branch_names(out) for n in names}
    assert chosen == {"Motion", "Ghosting", "Spike"}


# --- the Queue's prep_batch check -------------------------------------------------


def queue_of(transform):
    data = np.random.default_rng(0).random((1, 12, 12, 12), np.float32)
    seg = np.zeros((1, 12, 12, 12), np.int32)
    seg[0, 3:9, 3:9, 3:9] = 1
    subjects = [
        tt.Subject(t1=tt.ScalarImage(data.copy()), seg=tt.LabelMap(seg.copy())) for _ in range(2)
    ]
    return tt.Queue(
        subjects, tt.LabelSampler(patch_size=4, label_name="seg"), max_length=4,
        patches_per_volume=2, transform=transform,
    )


@pytest.mark.parametrize(
    "transform, raises",
    [
        (tt.OneOf([tt.Gamma(), tt.Noise(std=0.1)], p=0.5), False),
        (tt.OneOf([tt.Gamma(), tt.Noise(std=0.1)], p=0.5, per_instance=False), True),
        (tt.OneOf([tt.Ghosting(intensity=0.5, p=0.5, per_instance=False)]), False),
        (tt.OneOf([tt.Ghosting(intensity=0.5, p=0.5, per_instance=False)], per_instance=False), True),
        (tt.Compose([tt.SomeOf([tt.Compose([tt.Pad(padding=1, p=0.5)])], per_instance=False)]), True),
        (tt.Compose([tt.SomeOf([tt.Gamma(), tt.Flip(axes=(0,), p=0.5)], num_transforms=2)]), False),
    ],
    ids=[
        "oneof-p", "oneof-batch-wide-p", "oneof-child-runs-per-element",
        "oneof-batch-wide-child", "someof-nested-child", "someof-per-instance",
    ],
)
def test_prep_batch_check_sees_oneof_and_someof(transform, raises):
    batches_iter = queue_of(transform).device_batches(batch_size=2, prep_batch=2)
    if raises:
        with pytest.raises(ValueError, match="gates batch-wide"):
            next(batches_iter)
    else:
        assert next(batches_iter).batch_size == 2
