"""Port parity: the Queue and the loaders against the JAX package.

Both packages draw from the same stdlib ``random`` (subject and patch
shuffles), the same numpy algorithm (corners, ring rows, transform
parameters) and the same threefry draws, so with one seed and
``num_workers=0`` they give the same patches in the same order:

- ``Queue.__iter__`` and ``Queue.device_batches`` with and without
  shuffles, a ``subject_sampler``, and ``prep_batch`` 1 and 2, all behind
  BASELINE.json config 5's Motion + Ghosting: images within
  ``KSPACE_ATOL``, labels, locations, affines and metadata equal;
- the ``prep_batch > 1`` check, which the port makes on the instance and
  through nested Composes (the JAX package's check reads the class and
  stops at the top: ROADMAP's "Known faults in the reference");
- with worker threads only invariants (their child generators are drawn
  in the pool's order): counts, shapes and labelled patch centres;
- the loaders over a GridSampler (the batched fetch), a list and a Queue;
- kernel launches counted from many threads at once lose no count.
"""

from __future__ import annotations

import random
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu.config as jax_config
import torchio_tpu_torch as tt
from torchio_tpu_torch.data.queue import Queue as PortQueue
from torchio_tpu_torch.ops import kernel_lib

KSPACE_ATOL = 1e-5
SIZE = 24
PATCH = 8


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    """These tests build images from numpy and compare on the CPU: ask the
    port to put host data there (its default is the card)."""
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """Pin the JAX reference (Motion's dense resample) to its exact
    float32 corner gather: its opt-in float16 gather (left on for the rest
    of a process by importing ``bench.py``) rounds by up to 2^-11."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def subjects(pkg, n=2, size=SIZE, seed=0):
    """``n`` subjects of a float32 ``t1`` and an int32 block ``seg`` (as
    ``benchmarks/patches_bench.py``), each with its index as ``sid``; the
    JAX package's on ``jnp`` arrays (its device branch)."""
    rng = np.random.default_rng(seed)
    conv = jnp.asarray if pkg is tj else torch.as_tensor
    out = []
    for sid in range(n):
        t1 = rng.random((1, size, size, size), np.float32)
        seg = np.zeros((1, size, size, size), np.int32)
        q = size // 4
        seg[0, q:-q, q:-q, q : 2 * q] = 1
        seg[0, q:-q, q:-q, 2 * q : -q] = 2
        out.append(
            pkg.Subject(t1=pkg.ScalarImage(conv(t1)), seg=pkg.LabelMap(conv(seg)), sid=sid)
        )
    return out


def config5(pkg):
    """BASELINE.json config 5's transform (benchmarks/patches_bench.py)."""
    return pkg.Compose(
        [
            pkg.Motion(degrees=5, translation=3, num_transforms=1, p=0.5),
            pkg.Ghosting(intensity=(0.3, 0.7), p=0.5),
        ]
    )


def make_queue(pkg, n=2, **kwargs):
    options = dict(
        patch_sampler=pkg.LabelSampler(patch_size=PATCH, label_name="seg"),
        max_length=6,
        patches_per_volume=4,
        transform=config5(pkg),
    )
    options.update(kwargs)
    return pkg.Queue(subjects(pkg, n), **options)


def run_both(make_run, seed):
    """``make_run(pkg)`` for each package, after seeding the stdlib
    ``random`` and the package's generator with ``seed``."""
    out = []
    for pkg in (tj, tt):
        random.seed(seed)
        pkg.seed(seed)
        out.append(make_run(pkg))
    return out


def assert_patch_equal(want, got):
    assert got.patch_location.to_json() == want.patch_location.to_json()
    assert got.metadata["sid"] == want.metadata["sid"]
    np.testing.assert_allclose(
        got.t1.data.numpy(), np.asarray(want.t1.data), rtol=0, atol=KSPACE_ATOL
    )
    np.testing.assert_array_equal(got.seg.data.numpy(), np.asarray(want.seg.data))
    for name in ("t1", "seg"):
        np.testing.assert_array_equal(got[name].affine.data, np.asarray(want[name].affine.data))
        assert type(got[name]).__name__ == type(want[name]).__name__


def assert_batch_equal(want, got, batch_size, patch=PATCH):
    assert [loc.to_json() for loc in got.metadata["patch_location"]] == [
        loc.to_json() for loc in want.metadata["patch_location"]
    ]
    assert got.metadata["sid"] == want.metadata["sid"]
    t1, seg = got.images["t1"], got.images["seg"]
    assert t1.data.shape == (batch_size, 1, patch, patch, patch)
    np.testing.assert_allclose(
        t1.data.numpy(), np.asarray(want.images["t1"].data), rtol=0, atol=KSPACE_ATOL
    )
    np.testing.assert_array_equal(seg.data.numpy(), np.asarray(want.images["seg"].data))
    assert seg.data.dtype == torch.int32
    for name in ("t1", "seg"):
        for a, b in zip(got.images[name].affines, want.images[name].affines, strict=True):
            np.testing.assert_array_equal(a.data, np.asarray(b.data))
        assert got.images[name].image_class.__name__ == want.images[name].image_class.__name__


@pytest.fixture
def motion_calls(monkeypatch):
    """Counts the port's Motion applications, so that a parity run can
    show it held Motion's resample path at least once."""
    calls = []
    apply = tt.Motion.apply_transform

    def counting(self, batch, params):
        calls.append(batch.batch_size)
        return apply(self, batch, params)

    monkeypatch.setattr(tt.Motion, "apply_transform", counting)
    return calls


QUEUES = {
    "shuffled": dict(),
    "no-shuffles": dict(shuffle_subjects=False, shuffle_patches=False),
    "subjects-shuffled-only": dict(shuffle_patches=False),
    "subject-sampler": dict(shuffle_subjects=False, subject_sampler=[1, 0, 1]),
    "small-buffer": dict(max_length=3),
}


@pytest.mark.parametrize("name", list(QUEUES))
def test_queue_iteration_matches_jax(name, motion_calls):
    want, got = run_both(lambda pkg: list(make_queue(pkg, **QUEUES[name])), seed=5)
    n_subjects = len(QUEUES[name].get("subject_sampler", [0, 0]))
    assert len(got) == len(want) == 4 * n_subjects
    for a, b in zip(want, got):
        assert_patch_equal(a, b)
    assert motion_calls


DEVICE_BATCHES = {
    "shuffled": (dict(), dict(batch_size=3)),
    "no-shuffles-two-epochs": (
        dict(shuffle_subjects=False, shuffle_patches=False),
        dict(batch_size=2, epochs=2),
    ),
    "subject-sampler": (dict(shuffle_subjects=False, subject_sampler=[1, 1, 0]), dict(batch_size=4)),
    "over-capacity": (dict(max_length=3, patches_per_volume=5), dict(batch_size=2)),
    "prep-batch-2": (dict(), dict(batch_size=3, prep_batch=2)),
    "prep-batch-2-odd": (dict(), dict(batch_size=2, prep_batch=2)),
}


@pytest.mark.parametrize("name", list(DEVICE_BATCHES))
def test_device_batches_match_jax(name, motion_calls):
    queue_kwargs, call_kwargs = DEVICE_BATCHES[name]
    n = 3 if name.endswith("odd") else 2
    want, got = run_both(
        lambda pkg: list(make_queue(pkg, n, **queue_kwargs).device_batches(**call_kwargs)),
        seed=8,
    )
    assert len(got) == len(want) >= 2
    for a, b in zip(want, got):
        assert_batch_equal(a, b, call_kwargs["batch_size"])
    assert motion_calls


def prep_check_pipelines(pkg):
    return {
        "per-instance-gates": pkg.Compose(
            [pkg.Ghosting(intensity=0.5, p=0.5), pkg.Motion(degrees=5, p=1.0)]
        ),
        "class-gates-batch-wide": pkg.Compose([pkg.Pad(padding=1, p=0.5)]),
        "instance-gates-batch-wide": pkg.Compose(
            [pkg.Ghosting(intensity=0.5, p=0.5, per_instance=False)]
        ),
    }


@pytest.mark.parametrize(
    "name",
    [
        "per-instance-gates",
        "class-gates-batch-wide",
        pytest.param(
            "instance-gates-batch-wide",
            marks=pytest.mark.skip(
                reason="the JAX package's check reads the class, not the instance:"
                " ROADMAP.md, 'Known faults in the reference', data/queue.py:188-192"
            ),
        ),
    ],
)
def test_prep_batch_check_matches_jax(name):
    outcomes = []
    for pkg in (tj, tt):
        queue = make_queue(pkg, transform=prep_check_pipelines(pkg)[name])
        try:
            next(queue.device_batches(batch_size=2, prep_batch=2))
            outcomes.append(None)
        except ValueError as error:
            outcomes.append(str(error))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize(
    "transform, raises",
    [
        (tt.Ghosting(intensity=0.5, p=0.5, per_instance=False), True),
        (tt.Compose([tt.Compose([tt.Ghosting(intensity=0.5, p=0.5, per_instance=False)])]), True),
        (tt.Compose([tt.Compose([tt.Pad(padding=1, p=0.5)])]), True),
        (tt.Compose([tt.Ghosting(intensity=0.5)], p=0.5), True),
        (tt.Compose([tt.Compose([tt.Ghosting(intensity=0.5, p=0.5)]), tt.Pad(padding=1)]), False),
    ],
    ids=["instance", "nested-instance", "nested-class", "compose-p", "nested-ok"],
)
def test_prep_batch_check_reads_the_instance_and_nested_composes(transform, raises):
    queue = make_queue(tt, transform=transform)
    batches = queue.device_batches(batch_size=2, prep_batch=2)
    if raises:
        with pytest.raises(ValueError, match="gates batch-wide"):
            next(batches)
    else:
        assert next(batches).batch_size == 2


def assert_labelled_centres(patches_seg):
    """LabelSampler's contract: every patch's centre voxel is labelled."""
    c = PATCH // 2
    assert (patches_seg[:, 0, c, c, c] > 0).all()


def test_queue_with_worker_threads_keeps_counts_shapes_and_centres():
    tt.seed(1)
    queue = make_queue(tt, 4, num_workers=2, max_length=5)
    patches = list(queue)
    assert len(patches) == 16
    assert sorted(p.metadata["sid"] for p in patches) == sorted(list(range(4)) * 4)
    assert all(p.t1.shape == (1, PATCH, PATCH, PATCH) for p in patches)
    assert_labelled_centres(torch.stack([p.seg.data for p in patches]))
    batches = list(queue.device_batches(batch_size=4, epochs=2))
    assert len(batches) == 8
    for batch in batches:
        assert batch.images["t1"].data.shape == (4, 1, PATCH, PATCH, PATCH)
        assert_labelled_centres(batch.images["seg"].data)


def test_device_staged_is_one_ahead_and_leaves_subjects_alone():
    events = []
    pool = subjects(tt, 3)

    def producer():
        for i, subject in enumerate(pool):
            events.append(f"prep{i}")
            yield subject

    before = [s.t1.data for s in pool]
    for i, (subject, staged) in enumerate(PortQueue._device_staged(producer(), torch.device("meta"))):
        events.append(f"use{i}")
        assert set(staged) == {"t1", "seg"}
        assert staged["t1"].device.type == "meta" and staged["seg"].dtype == torch.int32
        assert subject.t1.data is before[i]
    assert events == ["prep0", "prep1", "use0", "prep2", "use1", "use2"]
    staged = [s for _, s in PortQueue._device_staged(iter(pool), torch.device("cpu"))]
    assert staged == [{}, {}, {}]


def test_device_batches_errors_and_properties_match_jax():
    for pkg in (tj, tt):
        queue = make_queue(pkg, transform=None)
        with pytest.raises(ValueError, match="batch_size must be >= 1"):
            next(queue.device_batches(batch_size=0))
        assert (queue.num_subjects, queue.patches_per_epoch) == (2, 8)
        assert queue.max_memory == 4 * 2 * PATCH**3 * 6
    port, ref = make_queue(tt, max_length=10**9), make_queue(tj, max_length=10**9)
    assert port.max_memory_pretty == ref.max_memory_pretty
    assert isinstance(port, torch.utils.data.IterableDataset)
    with pytest.raises(ValueError, match="subject_sampler"):
        make_queue(tt, subject_sampler=[0])
    mixed = subjects(tt, 2)
    mixed[1] = tt.Subject(t1=mixed[1].t1, other=mixed[1].seg)
    queue = tt.Queue(mixed, tt.UniformSampler(patch_size=4), patches_per_volume=2,
                     shuffle_subjects=False)
    with pytest.raises(ValueError, match="same image names"):
        list(queue.device_batches(batch_size=2))


def test_sampler_without_corners_falls_back_and_device_batches_refuse_it():
    class HostOnly(tt.UniformSampler):
        def _sample_corners(self, subject, num_patches):
            raise NotImplementedError

    queue = tt.Queue(subjects(tt, 1), HostOnly(patch_size=4), patches_per_volume=3)
    tt.seed(2)
    assert len(list(queue)) == 3
    with pytest.raises(ValueError, match="sample_locations"):
        next(queue.device_batches(batch_size=2))


# --- loaders -----------------------------------------------------------------


def test_subjects_loader_over_a_grid_sampler_matches_jax():
    jax_subject, port_subject = subjects(tj, 1)[0], subjects(tt, 1)[0]
    want, got = run_both(
        lambda pkg: list(
            pkg.SubjectsLoader(
                pkg.GridSampler(jax_subject if pkg is tj else port_subject, PATCH, 2),
                batch_size=5,
                shuffle=True,
            )
        ),
        seed=3,
    )
    assert len(got) == len(want) == 13  # 4^3 patches
    for a, b in zip(want, got):
        assert_batch_equal(a, b, a.batch_size)
        np.testing.assert_array_equal(b.images["t1"].data.numpy(), np.asarray(a.images["t1"].data))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_subjects_loader_over_a_list_matches_jax(num_workers):
    want, got = run_both(
        lambda pkg: list(
            pkg.SubjectsLoader(subjects(pkg, 5), batch_size=2, shuffle=True,
                               num_workers=num_workers, drop_last=True)
        ),
        seed=4,
    )
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert b.metadata["sid"] == a.metadata["sid"]
        np.testing.assert_array_equal(b.images["t1"].data.numpy(), np.asarray(a.images["t1"].data))


def test_subjects_loader_over_a_queue_matches_jax():
    want, got = run_both(
        lambda pkg: list(pkg.SubjectsLoader(make_queue(pkg), batch_size=3)), seed=6
    )
    assert [b.batch_size for b in got] == [3, 3, 2]
    for a, b in zip(want, got):
        assert_batch_equal(a, b, a.batch_size)


def test_images_loader_and_loader_errors():
    images = [s.t1 for s in subjects(tt, 3)]
    batches = list(tt.ImagesLoader(images, batch_size=2))
    assert [b.batch_size for b in batches] == [2, 1]
    torch.testing.assert_close(batches[0].data[1], images[1].data, rtol=0, atol=0)
    assert len(tt.ImagesLoader(images, batch_size=2)) == 2
    assert tt.StudiesLoader is tt.SubjectsLoader and tt.collate_studies is tt.collate_subjects
    with pytest.raises(ValueError, match="collate_fn"):
        tt.SubjectsLoader(images, collate_fn=lambda x: x)
    queue = make_queue(tt)
    with pytest.raises(ValueError, match="shuffle requires a map-style dataset"):
        next(iter(tt.SubjectsLoader(queue, shuffle=True)))
    with pytest.raises(TypeError, match="no length"):
        len(tt.SubjectsLoader(queue))


def test_queue_through_torch_data_loader():
    tt.seed(8)
    queue = make_queue(tt, transform=None)
    loader = torch.utils.data.DataLoader(queue, batch_size=4, collate_fn=tt.collate_subjects)
    batches = list(loader)
    assert [b.batch_size for b in batches] == [4, 4]
    assert_labelled_centres(torch.cat([b.images["seg"].data for b in batches]))


# --- launch counts -------------------------------------------------------------


def test_launch_counts_from_threads_lose_no_count():
    """Worker threads of a Queue launch kernels at once: the count is a
    read-modify-write, taken under a lock (a lost update would show here
    with the interpreter switching threads every microsecond)."""
    kernel_lib.LAUNCHES.setdefault("resample_coords", 0)
    before = dict(kernel_lib.LAUNCHES)
    threads_n, per_thread = 8, 4000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [kernel_lib.count_launch("resample_coords") for _ in range(per_thread)]
            )
            for _ in range(threads_n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    after = kernel_lib.LAUNCHES["resample_coords"]
    assert after - before["resample_coords"] == threads_n * per_thread
    kernel_lib.reset_launches()
    assert set(kernel_lib.LAUNCHES.values()) == {0}
    kernel_lib.LAUNCHES.update(before)
