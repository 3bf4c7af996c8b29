"""Port parity: ``torchio_tpu_torch.datasets`` and ``utils.download``.

No network: ``urllib.request.urlretrieve`` is replaced by a stand-in that
writes a staged payload (a zip or tar of seeded NIfTI files, NRRD files,
transform files, an npz), chosen by the file name the downloader asks
for. Each package gets its own cache directory (``get_cache_dir``
monkeypatched in its dataset modules), so the whole path runs in both:
``download_url``, ``extract_archive``, the layout each dataset expects.
Every dataset's subjects equal the JAX package's: the keys, the image
classes, the file each image reads, its data and affine, the metadata
and the non-image entries; the URLs fetched and the layout left on disk
are the same. ZonePlate is generated offline and equal too. The download
helpers (md5, the https -> http retry, archive extraction and its
refusals) behave as the JAX package's.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import tarfile
import urllib.error
import urllib.request
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu.datasets as jax_datasets
from torchio_tpu.io import matrix as jax_matrix
from torchio_tpu.io import nifti as jax_nifti
from torchio_tpu.io import other_formats as jax_formats
from torchio_tpu.utils import download as jax_download
import torchio_tpu_torch as tt
import torchio_tpu_torch.datasets as port_datasets
from torchio_tpu_torch.utils import download as port_download

MODULES = ("mni", "fpg", "itk_snap", "slicer", "medmnist")


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def nifti_bytes(name, tmp, label=False):
    """A seeded 4 x 5 x 3 NIfTI file's bytes (``.nii`` or ``.nii.gz``)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    data = rng.integers(0, 4, (4, 5, 3)) if label else rng.standard_normal((4, 5, 3))
    affine = np.diag([1.5, 1.0, 2.0, 1.0])
    affine[:3, 3] = rng.standard_normal(3)
    path = tmp / Path(name).name
    jax_nifti.write_nifti(path, data.astype(np.int16 if label else np.float32), affine)
    return path.read_bytes()


def archive(kind, members, tmp):
    """A zip or tar holding ``members`` (name -> bytes)."""
    buffer = io.BytesIO()
    if kind == "zip":
        with zipfile.ZipFile(buffer, "w") as z:
            for name, payload in members.items():
                z.writestr(name, payload)
    else:
        with tarfile.open(fileobj=buffer, mode="w") as t:
            for name, payload in members.items():
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                t.addfile(info, io.BytesIO(payload))
    return buffer.getvalue()


ICBM = "mni_icbm152_nlin_sym_09c"
ICBM_FILES = [
    f"{ICBM}/mni_icbm152_{m}_tal_nlin_sym_09c.nii" for m in ("t1", "t2", "pd")
] + [f"{ICBM}/mni_icbm152_t1_tal_nlin_sym_09c_{m}.nii" for m in ("eye_mask", "face_mask", "mask")] + [
    f"{ICBM}/mni_icbm152_tal_nlin_sym_09c_tissues.nii"
]
ARCHIVES = {
    "mni_colin27_1998_nifti.zip": [
        f"colin27_t1_tal_lin{s}.nii.gz" for s in ("", "_headmask", "_mask")
    ],
    "mni_colin27_2008_nifti.zip": [f"colin27_{m}_tal_hires.nii.gz" for m in ("t1", "t2", "pd", "cls")],
    f"{ICBM}_nifti.zip": ICBM_FILES,
    "nihpd_asym_04.5-08.5_nifti.zip": [f"nihpd_asym_04.5-08.5_{m}.nii" for m in ("t1w", "t2w", "pdw", "mask")],
    "nihpd_sym_13.0-18.5_nifti.zip": [f"nihpd_sym_13.0-18.5_{m}.nii" for m in ("t1w", "t2w", "pdw", "mask")],
    "NIFTI_ovine_auxiliary_masks.zip": ["ovine/ovine_t1.nii.gz"],
    "braintumor.zip": [f"braintumor/{m}.nii.gz" for m in ("flair", "t1", "t1ce", "t2", "seg")],
    "t1t2.zip": ["t1t2/t1.nii.gz", "t1t2/t2.nii.gz"],
    "bav.zip": ["bav/bav01.nii.gz", "bav/bav01_seg.nii.gz"],
    "IXI-T1.tar": [f"IXI00{i}-Guys-08{i}8-T1.nii.gz" for i in (2, 3, 4)],
    "IXI-T2.tar": [f"IXI00{i}-Guys-08{i}8-T2.nii.gz" for i in (2, 4)],
    "ixi_tiny.zip": [
        f"ixi_tiny/{kind}/IXI00{i}-Guys-08{i}8_{kind}.nii.gz".replace(f"_{kind}.nii", ".nii")
        for i in (2, 3) for kind in ("image", "label")
    ],
}


def payload(name, tmp):
    """The bytes a download of the file ``name`` gets."""
    if name in ARCHIVES:
        kind = "tar" if name.endswith(".tar") else "zip"
        members = {m: nifti_bytes(m, tmp, label=any(k in m for k in ("seg", "mask", "cls", "label")))
                   for m in ARCHIVES[name]}
        return archive(kind, members, tmp)
    if name.endswith((".nii.gz", ".nii")):
        return nifti_bytes(name, tmp, label="seg" in name)
    if name.endswith(".nrrd"):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        jax_formats.write_nrrd(tmp / name, rng.standard_normal((1, 4, 3, 5)).astype(np.float32), np.eye(4))
        return (tmp / name).read_bytes()
    if name.endswith(".tfm"):
        matrix = np.eye(4)
        matrix[:3, 3] = (1.0, -2.0, 3.5)
        jax_matrix.write_matrix(matrix, tmp / name)
        return (tmp / name).read_bytes()
    if name.endswith(".h5"):
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp / name, "w") as f:
            group = f.create_group("TransformGroup").create_group("1")
            group["TransformParameters"] = np.concatenate([np.eye(3).ravel() * 1.1, [0.5, 0.0, -1.0]])
            group["TransformFixedParameters"] = np.zeros(3)
        return (tmp / name).read_bytes()
    if name.endswith(".npz"):
        rng = np.random.default_rng(1)
        volumes = rng.random((3, 28, 28, 28)).astype(np.float32)
        labels = np.array([[0], [1], [2]])
        buffer = io.BytesIO()
        np.savez(buffer, train_images=volumes, train_labels=labels, val_images=volumes[:1],
                 val_labels=labels[:1], test_images=volumes[1:], test_labels=labels[1:])
        return buffer.getvalue()
    raise KeyError(name)


@pytest.fixture
def staged(tmp_path, monkeypatch):
    """Both packages' cache directories and the fetched URLs, with
    ``urlretrieve`` serving the staged payloads."""
    fetched = []
    source = tmp_path / "source"
    source.mkdir()

    def urlretrieve(url, path):
        fetched.append(url)
        Path(path).write_bytes(payload(Path(path).name, source))
        return str(path), None

    monkeypatch.setattr(urllib.request, "urlretrieve", urlretrieve)
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for name, package in (("jax", "torchio_tpu"), ("port", "torchio_tpu_torch")):
        for module in MODULES:
            monkeypatch.setattr(f"{package}.datasets.{module}.get_cache_dir", lambda root=roots[name]: root)
    return roots, fetched


def layout(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def assert_same_subject(want, got, roots):
    assert sorted(got.keys()) == sorted(want.keys())
    for key in want.keys():
        a, b = want[key], got[key]
        if not hasattr(a, "affine"):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
            continue
        assert type(b).__name__ == type(a).__name__, key
        if a.path is not None:
            assert b.path.relative_to(roots["port"]) == a.path.relative_to(roots["jax"])
            assert not b.is_loaded
        assert b.data.dtype == getattr(torch, str(np.asarray(a.data).dtype))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.data))
        np.testing.assert_array_equal(b.affine.data, a.affine.data)
        for meta in ("rigid_matrix", "affine_matrix"):
            if meta in a.metadata:
                np.testing.assert_array_equal(b.metadata[meta], a.metadata[meta])


CASES = {
    "colin27-1998": lambda d, root: d.Colin27(),
    "colin27-2008": lambda d, root: d.Colin27(version=2008),
    "icbm-tissues": lambda d, root: d.ICBM2009CNonlinearSymmetric(),
    "icbm": lambda d, root: d.ICBM2009CNonlinearSymmetric(load_4d_tissues=False),
    "pediatric": lambda d, root: d.Pediatric((4.5, 8.5)),
    "pediatric-symmetric": lambda d, root: d.Pediatric((13, 18.5), symmetric=True),
    "sheep": lambda d, root: d.Sheep(),
    "fpg": lambda d, root: d.FPG(),
    "fpg-all": lambda d, root: d.FPG(load_all=True),
    "braintumor": lambda d, root: d.BrainTumor(),
    "t1t2": lambda d, root: d.T1T2(),
    "aortic-valve": lambda d, root: d.AorticValve(),
    "slicer-mrhead": lambda d, root: d.Slicer(),
    "slicer-ctchest": lambda d, root: d.Slicer("CTChest"),
    "ixi": lambda d, root: d.ixi(root / "ixi", modalities=("T1", "T2"), download=True),
    "ixi-tiny": lambda d, root: d.ixi_tiny(root / "tiny", download=True),
    "organ-mnist": lambda d, root: d.organ_mnist_3d("training"),
    "nodule-mnist-test": lambda d, root: d.nodule_mnist_3d("test"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dataset_as_the_jax_package(staged, case):
    roots, fetched = staged
    want = CASES[case](jax_datasets, roots["jax"])
    jax_urls = list(fetched)
    got = CASES[case](port_datasets, roots["port"])
    assert fetched[len(jax_urls) :] == jax_urls and jax_urls
    want_list = want if isinstance(want, list) else [want]
    got_list = got if isinstance(got, list) else [got]
    assert type(got_list[0]).__name__ == type(want_list[0]).__name__
    assert len(got_list) == len(want_list) > 0
    for a, b in zip(want_list, got_list, strict=True):
        assert_same_subject(a, b, roots)
    assert layout(roots["port"]) == layout(roots["jax"])
    # a second construction reads the cache: nothing is fetched again
    count = len(fetched)
    CASES[case](port_datasets, roots["port"])
    assert len(fetched) == count


def test_fpg_palette_and_offline_errors(tmp_path):
    assert port_datasets.FPG.GIF_COLORS == jax_datasets.FPG.GIF_COLORS
    assert len(port_datasets.FPG.GIF_COLORS) == 161
    assert port_datasets.__all__ == jax_datasets.__all__
    for d in (jax_datasets, port_datasets):
        with pytest.raises(ValueError, match="1998 or 2008"):
            d.Colin27(version=2020)
        with pytest.raises(ValueError, match="years must be one of"):
            d.Pediatric((1.0, 2.0))
        with pytest.raises(ValueError, match="name must be one of"):
            d.Slicer("Nothing")
        with pytest.raises(FileNotFoundError, match="download=True"):
            d.ixi(tmp_path / "no_ixi")
        with pytest.raises(FileNotFoundError, match="download=True"):
            d.ixi_tiny(tmp_path / "no_tiny")
        with pytest.raises(ValueError, match="train/val/test"):
            d.organ_mnist_3d("bogus")
        with pytest.raises(ValueError, match="at least 3"):
            d.ZonePlate(size=2)


@pytest.mark.parametrize("size", [3, 16, 17])
def test_zone_plate(size):
    want, got = jax_datasets.ZonePlate(size), port_datasets.ZonePlate(size)
    assert got.image.data.dtype == torch.float32
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image.data))
    np.testing.assert_array_equal(got.image.affine.data, want.image.affine.data)


def test_download_helpers(tmp_path, monkeypatch):
    payload_bytes = b"dataset payload"
    md5 = hashlib.md5(payload_bytes).hexdigest()
    calls = []

    def https_fails(url, path):
        calls.append(url)
        if url.startswith("https://"):
            raise urllib.error.URLError("refused")
        Path(path).write_bytes(payload_bytes)

    monkeypatch.setattr(urllib.request, "urlretrieve", https_fails)
    for name, module in (("jax", jax_download), ("port", port_download)):
        root = tmp_path / name
        # https refused, http served, md5 checked
        assert module.download_url("https://host/a.bin", root, md5=md5).read_bytes() == payload_bytes
        with pytest.warns(RuntimeWarning, match="without an md5"):
            module.download_url("https://host/b.bin", root)
        with pytest.raises(RuntimeError, match="corrupted"):
            module.download_url("http://host/c.bin", root, md5="0" * 32)
        assert module.check_integrity(root / "a.bin", md5) and not module.check_integrity(root / "zz", None)
    assert calls[: len(calls) // 2] == calls[len(calls) // 2 :]


def test_download_non_https_error(tmp_path, monkeypatch):
    def refuse(url, path):
        raise urllib.error.URLError("refused")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    for module in (jax_download, port_download):
        with pytest.raises(urllib.error.URLError):
            module.download_url("http://host/x.bin", tmp_path)


def test_extract_archive(tmp_path):
    members = {"inner/a.txt": b"a", "b.txt": b"bb"}
    sources = tmp_path / "sources"
    sources.mkdir()
    (sources / "x.zip").write_bytes(archive("zip", members, sources))
    (sources / "x.tar").write_bytes(archive("tar", members, sources))
    (sources / "x.tar.gz").write_bytes(gzip.compress(archive("tar", members, sources)))
    (sources / "x.txt.gz").write_bytes(gzip.compress(b"plain"))
    (sources / "evil.zip").write_bytes(archive("zip", {"../escape.txt": b"no"}, sources))
    (sources / "x.rar").write_bytes(b"?")
    for name, module in (("jax", jax_download), ("port", port_download)):
        out = tmp_path / name
        for archive_name in ("x.zip", "x.tar", "x.tar.gz"):
            module.extract_archive(sources / archive_name, out / archive_name)
        assert module.extract_archive(sources / "x.txt.gz", out).read_bytes() == b"plain"
        with pytest.raises(RuntimeError, match="escapes"):
            module.extract_archive(sources / "evil.zip", out / "evil")
        with pytest.raises(ValueError, match="Unknown archive"):
            module.extract_archive(sources / "x.rar", out)
    assert layout(tmp_path / "port") == layout(tmp_path / "jax")
    assert (tmp_path / "port" / "x.tar.gz" / "inner" / "a.txt").read_bytes() == b"a"
    assert port_download.get_cache_dir() == jax_download.get_cache_dir()
