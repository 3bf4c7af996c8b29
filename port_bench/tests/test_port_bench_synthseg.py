"""The SynthSeg generator's parts on the CPU: the grid label layout keeps
every declared label at every shape (and the block layouts are as they
were), a generated map that lacks a declared label is refused, the plain
references of Gamma, Anisotropy and RescaleIntensity against the port's
CPU path one transform at a time, and LabelsToImage's two readers on
synthetic timelines."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import harness, inputs, registry
from port_bench.reference.context import Context
from port_bench.registry import metric_reader, reference_transform
from port_bench.timeline import Event, Timeline

SMALL, FULL = (32, 30, 28), (256, 256, 256)
SEED = 2**31 + 2828


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    import torchio_tpu_torch as tio

    previous = tio.set_default_device("cpu")
    yield
    tio.set_default_device(previous)


def seg_spec(name: str, shape) -> inputs.ImageSpec:
    return inputs.images(registry.cell(name).config, shape)["seg"]


# the grid layout and the guard


@pytest.mark.parametrize("shape", [SMALL, FULL])
def test_the_grid_keeps_every_declared_label(shape):
    spec = seg_spec("synthseg-labels-b4", shape)
    labels = inputs.label_map(spec, "cpu")
    assert labels.shape == (1, *shape) and labels.dtype == torch.int32
    assert sorted(torch.unique(labels).tolist()) == sorted(spec.spec["values"])


def test_the_grid_gives_every_label_an_equal_share_at_full_size():
    labels = inputs.grid(seg_spec("synthseg-labels-b4", FULL).spec, FULL, "cpu")
    counts = torch.bincount(labels.reshape(-1))
    assert counts.tolist() == [256**3 // 32] * 32


def test_the_grid_is_its_formula():
    spec = {"grid": [3, 2, 4], "values": [5, 0, 7, 2, 9]}
    shape = (7, 5, 9)
    got = inputs.grid(spec, shape, "cpu")[0].numpy()
    for i, j, k in np.ndindex(*shape):
        p = (i * 3 // 7, j * 2 // 5, k * 4 // 9)
        assert got[i, j, k] == spec["values"][(p[0] * 8 + p[1] * 4 + p[2]) % 5]


@pytest.mark.parametrize("shape", [SMALL, None])
@pytest.mark.parametrize("workload", ["t1-headline-b8", "brats-augment-b4"])
def test_the_block_maps_are_as_before(workload, shape):
    spec = seg_spec(workload, shape)
    n, values = spec.spec["block"], spec.spec["values"]
    i, j, k = np.ogrid[tuple(slice(0, s) for s in spec.shape)]
    want = np.asarray(values, np.int32)[(i // n + j // n + k // n) % len(values)]
    made = inputs.make({"seg": spec}, 2, SEED, "cpu")["seg"]
    assert made.shape == (2, 1, *spec.shape)
    assert np.array_equal(made[0, 0].numpy(), want) and torch.equal(made[0], made[1])


def test_a_map_that_lacks_a_declared_label_is_refused():
    spec = seg_spec("synthseg-labels-b4", SMALL)
    spec.spec = {**spec.spec, "labels": "blocks", "block": 16}  # labels 0-3 only at SMALL
    with pytest.raises(ValueError, match=r"lacks the declared values \[4, 5, .*31\]"):
        inputs.make({"seg": spec}, 1, SEED, "cpu")


# the references against the port's CPU path, one transform at a time


def specs_of(shape) -> dict:
    """A scalar image and a label map of 8 labels at ``shape``."""
    return inputs.images({"images": {
        "image": {"kind": "scalar", "channels": 1, "shape": list(shape), "dtype": "float32"},
        "seg": {"kind": "label", "channels": 1, "shape": list(shape), "dtype": "int32",
                "labels": "grid", "grid": [4, 3, 2], "values": list(range(8))},
    }})


def tensors_of(specs, batch: int, image: torch.Tensor) -> dict:
    tensors = inputs.make(specs, batch, SEED, "cpu")
    tensors["image"] = image
    return tensors


def program(transform, specs, tensors, seed: int | None = None, params=None) -> dict:
    """The port's transform on the CPU: a whole call from ``seed``, or
    its ``apply_transform`` with ``params``; name -> (B, C, I, J, K)."""
    import torchio_tpu_torch as tio

    batch = harness.make_batch(tio, specs, tensors)
    if params is None:
        tio.seed(seed)
        batch = transform(batch)
    else:
        batch = transform.apply_transform(batch, params)
    return {name: images.data for name, images in batch.images.items()}


def reference(name: str, args: dict, specs, tensors, seed: int | None = None,
              params=None) -> dict:
    """The plain reference of ``name``: drawn from ``seed`` as the window
    draws, or given ``params``; every element."""
    batch = len(next(iter(tensors.values())))
    ctx = Context(specs, batch, torch.device("cpu"))
    module = reference_transform(name)
    if params is None:
        params = module.draw(args, np.random.default_rng(seed), ctx)
    return module.apply(params, args, dict(tensors), list(range(batch)), ctx.at(tensors))


def test_gamma_agrees_on_negative_voxels():
    import torchio_tpu_torch as tio

    specs = specs_of((9, 8, 7))
    image = torch.randn((3, 1, 9, 8, 7), generator=torch.Generator().manual_seed(1))
    assert (image < 0).any()
    tensors = tensors_of(specs, 3, image)
    args = {"log_gamma": [-0.3, 0.3]}
    got = program(tio.Gamma(**args), specs, tensors, seed=SEED)
    want = reference("Gamma", args, specs, tensors, seed=SEED)
    assert torch.equal(got["image"], want["image"]) and torch.equal(got["seg"], want["seg"])
    assert not torch.equal(want["image"], image) and (want["image"] < 0).any()


def test_the_gamma_reference_refuses_what_the_cell_does_not_use():
    specs = specs_of((4, 4, 4))
    with pytest.raises(NotImplementedError, match="p"):
        reference("Gamma", {"log_gamma": 0.3, "p": 0.5}, specs, tensors_of(
            specs, 2, torch.rand(2, 1, 4, 4, 4)), seed=SEED)


def test_anisotropy_agrees_when_drawn():
    import torchio_tpu_torch as tio

    specs = specs_of((30, 26, 22))
    tensors = tensors_of(specs, 4, torch.rand((4, 1, 30, 26, 22),
                                              generator=torch.Generator().manual_seed(2)))
    args = {"downsampling": [1.5, 5.0]}
    for seed in range(SEED, SEED + 3):
        got = program(tio.Anisotropy(**args), specs, tensors, seed=seed)
        want = reference("Anisotropy", args, specs, tensors, seed=seed)
        assert torch.equal(got["image"], want["image"]) and torch.equal(got["seg"], want["seg"])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_anisotropy_agrees_on_each_axis(axis):
    """Linear on the scalar image and nearest on the label map (here each
    voxel's index along the axis); 30 / 4 = 7.5 rounds to 8 samples
    (Python's ``round``); a factor of 1 or less leaves the element as it
    is."""
    import torchio_tpu_torch as tio

    specs = specs_of((30, 30, 30))
    image = torch.rand((5, 1, 30, 30, 30), generator=torch.Generator().manual_seed(3))
    tensors = tensors_of(specs, 5, image)
    shape = [1, 1, 1, 1, 1]
    shape[axis + 2] = 30
    tensors["seg"] = torch.arange(30, dtype=torch.int32).reshape(shape).expand(
        5, 1, 30, 30, 30).contiguous()
    factors = [4.0, 1.0, 2.5, 1.7, 0.5]
    params = {"axis": [axis] * 5, "factor": factors, "_batch_size": 5,
              "_batched_keys": ["axis", "factor"]}
    got = program(tio.Anisotropy(downsampling=(1.5, 5)), specs, tensors, params=params)
    want = reference("Anisotropy", {}, specs, tensors,
                     params={"axis": [axis] * 5, "factor": factors})
    assert torch.equal(got["image"], want["image"]) and torch.equal(got["seg"], want["seg"])
    for b in (1, 4):
        assert torch.equal(want["image"][b], image[b])
        assert torch.equal(want["seg"][b], tensors["seg"][b])
    assert torch.unique(want["seg"][0]).tolist() == [m * 30 // 8 for m in range(8)]
    assert not torch.equal(want["image"][0], image[0])


def test_rescale_intensity_clips_the_other_elements_to_the_first():
    import torchio_tpu_torch as tio

    specs = specs_of((10, 9, 8))
    image = torch.rand((3, 1, 10, 9, 8), generator=torch.Generator().manual_seed(4))
    image[1] = image[1] * 3.0 - 1.0  # beyond element 0's range on both sides
    image[2] = image[2] * 0.5 + 0.6
    tensors = tensors_of(specs, 3, image)
    args = {"out_min": 0.0, "out_max": 1.0}
    got = program(tio.RescaleIntensity(**args), specs, tensors, seed=SEED)
    want = reference("RescaleIntensity", args, specs, tensors, seed=SEED)
    assert torch.equal(got["image"], want["image"]) and torch.equal(got["seg"], want["seg"])
    assert want["image"][0].min() == 0.0 and want["image"][0].max() == 1.0
    assert (want["image"][1] == 0.0).any() and (want["image"][1] == 1.0).any()
    assert (want["image"][2] == 1.0).any()


# LabelsToImage's readers on synthetic timelines

#: one call (us): Spatial, LabelsToImage with its phases, BiasField
CALL_SPANS = [
    ("tio.Compose", 1, 99),
    ("tio.Spatial", 2, 20),
    ("tio.Spatial.apply", 5, 18),
    ("tio.LabelsToImage", 22, 60),
    ("tio.LabelsToImage.draw", 23, 30),
    ("tio.LabelsToImage.apply", 31, 58),
    ("tio.BiasField", 62, 80),
    ("tio.BiasField.apply", 63, 79),
]
#: the device runs 10-15, 40-45 and 70-75: 38 - 5 us of LabelsToImage's
#: spans are idle
KERNELS = [(10, 15), (40, 45), (70, 75)]
#: runtime syncs: Spatial's apply, LabelsToImage's draw and apply twice,
#: the harness's own after the composer
SYNCS = [12, 24, 35, 50, 99.5]
READERS = ("labels_to_image_exposed_ms_per_call", "labels_to_image_syncs_per_call")


def synthetic(calls: int = 2, owners=("Spatial", "LabelsToImage", "BiasField", "Compose"),
              program_spans: bool = True) -> Timeline:
    events, bounds = [], []
    for c in range(calls):
        t = 200.0 * c
        bounds.append((t, t + 100.0))
        if program_spans:
            events += [Event("cpu", name, t + lo, t + hi) for name, lo, hi in CALL_SPANS
                       if name.split(".")[1] in owners]
        events += [Event("kernel", "elementwise_kernel", t + lo, t + hi) for lo, hi in KERNELS]
        events += [Event("cpu", "cudaStreamSynchronize", t + s, t + s + 0.4) for s in SYNCS]
        events.append(Event("cpu", "cudaMemcpyAsync", t + 33, t + 34))  # does not wait
    return Timeline(calls=bounds, events=events, window=(0.0, 200.0 * calls - 100.0))


def test_labels_to_image_readers_take_only_its_spans():
    line = synthetic()
    assert metric_reader(READERS[0])(line) == pytest.approx(33 / 1e3)
    assert metric_reader(READERS[1])(line) == 3.0
    # every program span, as before: the harness's sync is outside them
    assert metric_reader("host_syncs_per_call")(line) == 4.0


def test_labels_to_image_readers_read_nothing_without_its_spans():
    for line in (synthetic(program_spans=False), synthetic(owners=("Spatial", "BiasField")),
                 Timeline(calls=[], events=synthetic().events, window=(0.0, 1.0))):
        assert all(metric_reader(name)(line) is None for name in READERS)
    assert metric_reader("host_syncs_per_call")(synthetic(owners=("Spatial",))) == 1.0
