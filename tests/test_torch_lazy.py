"""Port parity: images read from files, and what reads through them.

Small volumes (about 12-20 voxels a side) are written with the JAX
package's writers, so both packages read the same files:

- ``ScalarImage(path)`` is lazy: ``shape``, ``spatial_shape``, ``affine``
  and ``dtype`` come from the header with no voxel read (a spy on the
  NIfTI reader's data access), equal to the JAX package's; ``load``/
  ``unload``/``is_loaded``/``path``; sources given as a path, ``bytes``,
  ``BytesIO``, a file object or a backend; region reads through
  ``image[...]`` without a full load, equal (data and affine); ``save``
  through every writer; a deep copy stays lazy; ``Subject``/``Study``
  load and unload, and ``StudiesBatch.from_subjects`` loads;
- a lazy CropOrPad (crop, pad, both; every padding mode; centre and
  random locations; a Subject and an Image) equals the JAX package's lazy
  one and the port's eager one (data, dtype, affine, history), and reads
  no voxel before the data is used;
- ``Spatial``/``Resample`` with a target given as a path equal the same
  target given as an Image, and the JAX package's result;
- ``compute_histogram_landmarks`` on paths equals the JAX result;
- the Queue over subjects of paths yields the patches it yields over the
  same subjects in memory, loading them in its worker threads;
- the port's public names are ``torchio_tpu.__all__`` less the names of
  later slices.
"""

from __future__ import annotations

import copy
import io
import random
import threading

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import config as jax_config
from torchio_tpu.io import nifti as jax_nifti
from torchio_tpu_torch.io import backends as port_backends
from torchio_tpu_torch.io import nifti as port_nifti

SHAPE = (14, 12, 16)
LINEAR_ATOL = 1e-5
#: names of ``torchio_tpu.__all__`` that the port does not have yet: none
DEFERRED: set[str] = set()


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


@pytest.fixture(autouse=True)
def exact_jax_gather(monkeypatch):
    """The JAX package's exact corner gather (``bench.py``'s import turns
    the float16 one on for the rest of an xdist worker)."""
    monkeypatch.setenv("TORCHIO_TPU_GATHER16", "0")
    monkeypatch.setattr(jax_config, "use_gather16", None)


def oblique(spacing=(0.9375, 0.9375, 1.2)):
    out = np.eye(4)
    angle = 0.2
    out[:3, :3] = np.array(
        [[np.cos(angle), -np.sin(angle), 0.0], [np.sin(angle), np.cos(angle), 0.0], [0.0, 0.0, 1.0]]
    ) @ np.diag(spacing)
    out[:3, 3] = (-8.5, 6.25, -10.0)
    return out


def t1_volume(seed=0, dtype=np.int16, shape=SHAPE, channels=1):
    rng = np.random.default_rng(seed)
    data = rng.random((channels, *shape)) ** 2 * 1000
    return data.astype(dtype)


def seg_volume(shape=SHAPE):
    seg = np.zeros((1, *shape), np.int32)
    q = [s // 4 for s in shape]
    seg[0, q[0] : -q[0], q[1] : -q[1], q[2] : 2 * q[2]] = 1
    seg[0, q[0] : -q[0], q[1] : -q[1], 2 * q[2] : -q[2]] = 2
    return seg


def write_subject(tmp_path, name, seed=0, suffix=".nii.gz", dtype=np.int16):
    """A t1 and a seg written by the JAX package: the two paths."""
    t1, seg = tmp_path / f"{name}_t1{suffix}", tmp_path / f"{name}_seg{suffix}"
    jax_nifti.write_nifti(t1, t1_volume(seed, dtype), oblique())
    jax_nifti.write_nifti(seg, seg_volume(), oblique())
    return t1, seg


class DataReads:
    """Counts the voxel reads of every NIfTI file in the port and the
    JAX package."""

    def __init__(self, monkeypatch):
        self.count = 0
        for module in (port_nifti, jax_nifti):
            original = module.NiftiFile._disk_array

            def spy(file, original=original):
                self.count += 1
                return original(file)

            monkeypatch.setattr(module.NiftiFile, "_disk_array", spy)


@pytest.fixture
def reads(monkeypatch):
    return DataReads(monkeypatch)


# --- the lazy image --------------------------------------------------------


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.uint32, np.float32, np.uint8])
def test_metadata_reads_no_voxel(tmp_path, reads, dtype, suffix):
    path, _ = write_subject(tmp_path, "a", dtype=dtype, suffix=suffix)
    port, jax_image = tt.ScalarImage(path), tj.ScalarImage(path)
    assert port.shape == jax_image.shape == (1, *SHAPE)
    assert port.spatial_shape == jax_image.spatial_shape
    np.testing.assert_array_equal(port.affine.data, jax_image.affine.data)
    assert port.spacing == jax_image.spacing and port.orientation == jax_image.orientation
    assert port.dtype == getattr(torch, np.dtype(dtype).name)
    assert str(port.dtype).removeprefix("torch.") == np.dtype(jax_image.dtype).name
    assert not port.is_loaded and port.device is None and port.path == path
    assert "lazy" in repr(port)
    assert reads.count == 0
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(jax_image.data))
    assert port.is_loaded and port.data.device.type == "cpu"


def test_load_unload(tmp_path):
    path, _ = write_subject(tmp_path, "a")
    image = tt.ScalarImage(path)
    image.load()
    assert image.is_loaded
    image.unload()
    assert not image.is_loaded
    np.testing.assert_array_equal(image.numpy(), t1_volume())
    image.set_data(image.data * 2)  # no longer the file's data: stays
    image.unload()
    assert image.is_loaded and image.path is None
    memory = tt.ScalarImage(t1_volume())
    memory.unload()
    assert memory.is_loaded


def as_file(path):
    return open(path, "rb")  # noqa: SIM115  (closed by the test)


SOURCES = {
    "path": lambda path: path,
    "str": lambda path: str(path),
    "bytes": lambda path: path.read_bytes(),
    "BytesIO": lambda path: io.BytesIO(path.read_bytes()),
}


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("kind", [*SOURCES, "file", "backend"])
def test_sources(tmp_path, kind, suffix):
    path, _ = write_subject(tmp_path, "a", suffix=suffix)
    want = tj.ScalarImage(path)
    if kind == "file":
        with as_file(path) as f:
            image = tt.ScalarImage(f)
    elif kind == "backend":
        image = tt.ScalarImage(port_backends.NiftiBackend(path))
    else:
        image = tt.ScalarImage(SOURCES[kind](path))
    assert not image.is_loaded
    np.testing.assert_array_equal(image.affine.data, want.affine.data)
    np.testing.assert_array_equal(image.numpy(), np.asarray(want.data))
    assert image.data.dtype == torch.int16


def test_bad_sources(tmp_path):
    with pytest.raises(ValueError, match="Unsupported Image source"):
        tt.ScalarImage(3.5)
    with pytest.raises(RuntimeError, match="no data"):
        tt.ScalarImage().data
    assert repr(tt.ScalarImage()) == "ScalarImage(empty)"
    # a URI goes to the remote matcher (fsspec): a missing file is refused
    # there, an unknown scheme by fsspec, never read as a local path
    pytest.importorskip("fsspec")
    with pytest.raises(FileNotFoundError):
        tt.ScalarImage("memory://missing/t1.nii.gz").shape
    with pytest.raises(ValueError, match="Protocol not known"):
        tt.ScalarImage("nosuchscheme://host/t1.nii.gz").shape
    missing = tt.ScalarImage(tmp_path / "missing.nii.gz")
    with pytest.raises(FileNotFoundError):
        missing.shape


REGIONS = (
    (slice(None), slice(2, 9), slice(0, 12), slice(3, 15)),
    (0, 5, slice(1, 11, 2), slice(None)),
    (Ellipsis, slice(-4, None)),
)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("region", range(len(REGIONS)))
def test_region_read_without_load(tmp_path, monkeypatch, region, suffix):
    path, _ = write_subject(tmp_path, "a", suffix=suffix)
    full_reads = []
    read = port_nifti.NiftiFile.read
    monkeypatch.setattr(port_nifti.NiftiFile, "read", lambda f: full_reads.append(1) or read(f))
    image = tt.ScalarImage(path)
    got = image[REGIONS[region]]
    want = tj.ScalarImage(path)[REGIONS[region]]
    assert not image.is_loaded and not full_reads
    assert type(got) is tt.ScalarImage and got.data.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.affine.data, want.affine.data)
    loaded = tt.ScalarImage(path)
    loaded.load()
    np.testing.assert_array_equal(loaded[REGIONS[region]].numpy(), got.numpy())


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".nrrd", ".nhdr", ".mha", ".mhd"])
def test_save(tmp_path, suffix):
    path, _ = write_subject(tmp_path, "a")
    image = tt.ScalarImage(path)
    image.save(tmp_path / f"out{suffix}")
    back, want = tt.ScalarImage(tmp_path / f"out{suffix}"), tj.ScalarImage(tmp_path / f"out{suffix}")
    np.testing.assert_array_equal(back.numpy(), t1_volume())
    np.testing.assert_array_equal(back.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(back.affine.data, want.affine.data)
    np.testing.assert_allclose(back.affine.data, oblique(), atol=1e-5)


def test_deepcopy_keeps_lazy(tmp_path, reads):
    path, _ = write_subject(tmp_path, "a")
    image = tt.ScalarImage(path, site="IOP")
    image.shape  # noqa: B018  (the header only)
    clone = copy.deepcopy(image)
    assert not clone.is_loaded and clone.path == path and clone["site"] == "IOP"
    assert reads.count == 0
    image.load()
    clone2 = copy.deepcopy(image)
    assert clone2.is_loaded and clone2.path == path
    clone2.unload()
    np.testing.assert_array_equal(clone2.numpy(), image.numpy())


def test_subject_study_and_batch(tmp_path):
    t1, seg = write_subject(tmp_path, "a")
    subject = tt.Study(t1=tt.ScalarImage(t1), seg=tt.LabelMap(seg), age=40)
    assert tt.Study is tt.Subject and tt.StudiesBatch is tt.SubjectsBatch
    assert subject.spatial_shape == SHAPE and subject.device is None
    subject.load()
    assert all(image.is_loaded for image in subject.images.values())
    subject.unload()
    assert not any(image.is_loaded for image in subject.images.values())
    batch = tt.StudiesBatch.from_subjects([subject, copy.deepcopy(subject)])
    assert batch.t1.data.shape == (2, 1, *SHAPE) and batch.seg.data.dtype == torch.int32
    np.testing.assert_array_equal(batch.t1.data[1].numpy(), t1_volume())


# --- lazy CropOrPad ----------------------------------------------------------


def path_subjects(pkg, tmp_path, loaded=False):
    t1, seg = write_subject(tmp_path, "s", seed=3)
    subject = pkg.Subject(t1=pkg.ScalarImage(t1), seg=pkg.LabelMap(seg), sid=0)
    if loaded:
        subject.load()
    return subject


CROP_OR_PADS = {
    "crop": dict(target_shape=(10, 9, 12)),
    "pad": dict(target_shape=(18, 15, 20)),
    "both": dict(target_shape=(10, 16, 13)),
    "both-fill": dict(target_shape=(17, 8, 19), fill=-3),
    "random": dict(target_shape=(9, 15, 11), location="random"),
    "mm": dict(target_shape=(12.0, None, 15.0), units="mm"),
    "only-crop": dict(target_shape=(10, 16, 13), only_crop=True),
    "include": dict(target_shape=(10, 16, 13), include=["t1"]),
    **{mode: dict(target_shape=(10, 16, 13), padding_mode=mode)
       for mode in ("reflect", "replicate", "circular", "mean", "median", "minimum")},
}


def assert_subjects_equal(got, want, exact=True):
    for name in ("t1", "seg"):
        g, w = got[name], want[name]
        assert g.data.dtype == getattr(torch, np.dtype(np.asarray(w.data).dtype).name)
        if exact or name == "seg":
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        else:
            # float32 sums in another order: a few ulps of the largest value
            scale = max(1.0, float(np.abs(np.asarray(w.data)).max()))
            np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data), rtol=0, atol=LINEAR_ATOL * scale)
        np.testing.assert_array_equal(g.affine.data, np.asarray(w.affine.data))
    hist = [(h.name, h.params, h.include, h.exclude) for h in got.applied_transforms]
    assert hist == [(h.name, h.params, h.include, h.exclude) for h in want.applied_transforms]


@pytest.mark.parametrize(
    "name, as_image",
    [(name, False) for name in CROP_OR_PADS] + [(name, True) for name in CROP_OR_PADS if name != "include"],
)
def test_lazy_crop_or_pad(tmp_path, reads, name, as_image):
    kwargs = CROP_OR_PADS[name]
    outs = {}
    for key, pkg, loaded in (("port-lazy", tt, False), ("jax-lazy", tj, False), ("port-eager", tt, True)):
        subject = path_subjects(pkg, tmp_path, loaded)
        pkg.seed(7)
        before = reads.count
        source = subject.t1 if as_image else subject
        out = pkg.CropOrPad(**kwargs)(source)
        if key == "port-lazy":
            constant = kwargs.get("padding_mode", "constant") == "constant"
            assert (reads.count == before) == constant  # views until the data is used
        if as_image:
            out = pkg.Subject(t1=out, seg=out)  # compare the image under both names
            out.applied_transforms = []
        outs[key] = out
    for other in ("jax-lazy", "port-eager"):
        assert_subjects_equal(outs["port-lazy"], outs[other], exact=other == "port-eager" or "mean" not in name)


def test_lazy_crop_or_pad_then_pipeline(tmp_path):
    """A lazy CropOrPad's output feeds a batch pipeline: equal to the
    eager one's output through the same Flip and Pad."""
    outs = []
    for loaded in (False, True):
        subject = path_subjects(tt, tmp_path, loaded)
        tt.seed(2)
        pipeline = tt.Compose([tt.CropOrPad((10, 16, 13)), tt.Flip(axes=(0, 1)), tt.Pad(padding=2)])
        outs.append(pipeline(subject))
    assert_subjects_equal(outs[0], outs[1])


# --- targets, landmarks, the Queue ----------------------------------------------


@pytest.mark.parametrize(
    "make",
    [
        lambda pkg, target: pkg.Resample(target=target),
        lambda pkg, target: pkg.Spatial(target=target, degrees=5, image_interpolation="linear"),
        lambda pkg, target: pkg.Resample(target=target, label_interpolation="label"),
    ],
    ids=["resample", "spatial", "resample-label"],
)
def test_file_target(tmp_path, make):
    reference = tmp_path / "reference.nii.gz"
    ref_affine = np.diag([1.1, 1.0, 1.3, 1.0])
    ref_affine[:3, 3] = (-6.0, 3.0, -9.0)
    jax_nifti.write_nifti(reference, np.zeros((1, 11, 13, 12), np.float32), ref_affine)
    subject_paths = write_subject(tmp_path, "s", seed=4, dtype=np.float32)
    outs = {}
    for key, pkg, target in (
        ("path", tt, reference), ("str", tt, str(reference)), ("image", tt, tt.ScalarImage(reference)),
        ("jax", tj, reference),
    ):
        subject = pkg.Subject(t1=pkg.ScalarImage(subject_paths[0]), seg=pkg.LabelMap(subject_paths[1]))
        pkg.seed(5)
        outs[key] = make(pkg, target)(subject)
    for key in ("str", "image"):
        assert_subjects_equal(outs[key], outs["path"])
    assert outs["path"].t1.shape == (1, 11, 13, 12)
    # the file keeps the affine in float32
    np.testing.assert_array_equal(outs["path"].t1.affine.data, ref_affine.astype(np.float32))
    assert_subjects_equal(outs["path"], outs["jax"], exact=False)


def test_histogram_landmarks_from_paths(tmp_path):
    paths = [write_subject(tmp_path, f"c{i}", seed=10 + i)[0] for i in range(4)]
    want = tj.compute_histogram_landmarks(paths)
    got = tt.compute_histogram_landmarks(paths)
    got_str = tt.compute_histogram_landmarks([str(p) for p in paths])
    in_memory = tt.compute_histogram_landmarks([t1_volume(10 + i) for i in range(4)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_str, got)
    np.testing.assert_array_equal(in_memory, got)
    masked = tt.compute_histogram_landmarks(paths, masking_method=lambda x: x > 100)
    want_masked = tj.compute_histogram_landmarks(paths, masking_method=lambda x: x > 100)
    np.testing.assert_array_equal(masked, want_masked)


def queue_subjects(tmp_path, on_disk, n=3):
    out = []
    for sid in range(n):
        t1, seg = write_subject(tmp_path, f"q{sid}", seed=20 + sid, dtype=np.float32, suffix=".nii")
        if on_disk:
            images = dict(t1=tt.ScalarImage(t1), seg=tt.LabelMap(seg))
        else:
            affine = tt.ScalarImage(t1).affine  # the file's (float32) affine
            images = dict(
                t1=tt.ScalarImage(t1_volume(20 + sid, np.float32), affine=affine),
                seg=tt.LabelMap(seg_volume(), affine=affine),
            )
        out.append(tt.Subject(**images, sid=sid))
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_queue_over_paths(tmp_path, monkeypatch, workers):
    """The same patches from subjects on disk as from the same subjects in
    memory (with Motion + Ghosting when the draws stay in one thread);
    the files are loaded in place, by the workers when there are some."""
    loads = []
    load = tt.Image.load

    def spy(image):
        if not image.is_loaded:
            loads.append(threading.current_thread().name)
        load(image)

    monkeypatch.setattr(tt.Image, "load", spy)
    runs = []
    for on_disk in (True, False):
        subjects = queue_subjects(tmp_path, on_disk)
        artifacts = [tt.Motion(degrees=5, translation=3), tt.Ghosting(intensity=(0.5, 1))]
        transform = None if workers else tt.Compose(artifacts)
        queue = tt.Queue(subjects, tt.LabelSampler(patch_size=6, label_name="seg"), max_length=5,
                         patches_per_volume=3, num_workers=workers, transform=transform)
        random.seed(3)
        tt.seed(3)
        runs.append((list(queue), subjects))
    (disk_patches, disk_subjects), (memory_patches, _) = runs
    assert len(disk_patches) == 9
    if workers:  # when the buffer flushes depends on the workers' timing: compare as sets

        def key(patch):
            return patch.metadata["sid"], patch.patch_location.to_json()["index"]

        disk_patches, memory_patches = (sorted(p, key=key) for p in (disk_patches, memory_patches))
    for got, want in zip(disk_patches, memory_patches, strict=True):
        assert got.patch_location.to_json() == want.patch_location.to_json()
        assert got.metadata["sid"] == want.metadata["sid"]
        for name in ("t1", "seg"):
            np.testing.assert_array_equal(got[name].data.numpy(), want[name].data.numpy())
            np.testing.assert_array_equal(got[name].affine.data, want[name].affine.data)
    assert all(image.is_loaded for s in disk_subjects for image in s.images.values())
    assert len(loads) == 6
    if workers:  # the first subject in the calling thread, the rest in the pool
        assert sum(name != threading.current_thread().name for name in loads) == 4


def test_public_names():
    assert not DEFERRED
    assert set(tj.__all__) == set(tt.__all__) - {"default_device", "set_default_device"}
    for name in tt.__all__:
        assert getattr(tt, name) is not None
    tt.enable_logging("DEBUG", rich=False)
    assert tt.logging.logger.level == 10 and len(tt.logging.logger.handlers) == 2
    tt.disable_logging()
    assert len(tt.logging.logger.handlers) == 1
