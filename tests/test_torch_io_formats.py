"""Port parity: NRRD, MetaImage and transform files across the two packages.

Each file is written by one package and read by the other, both ways:

- NRRD (``.nrrd`` raw and gzip, detached ``.nhdr``) and MetaImage
  (``.mha`` compressed or not, detached ``.mhd``), 1 and 3 channels,
  integer and float dtypes, an oblique affine: data, dtype and float64
  affine equal to what the writing package's reader gets;
- ``read_matrix``/``write_matrix`` on ``.tfm``, ``.txt``, ``.trsf`` and
  ``.h5`` (h5py), equal in float64;
- ``write_image`` picks the writer by suffix as the JAX package does,
  the same suffixes; ``.dcm`` and a directory write DICOM (the JAX
  package's bytes, UIDs aside), ``.nii.zarr`` needs ``zarr``.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import matrix as jax_matrix
from torchio_tpu.io import other_formats as jax_formats
from torchio_tpu.io import write as jax_write
import torchio_tpu_torch as tt
from torchio_tpu_torch.external.imports import get_optional
from torchio_tpu_torch.io import matrix as port_matrix
from torchio_tpu_torch.io import other_formats as port_formats
from torchio_tpu_torch.io import write as port_write

PACKAGES = {"jax": (jax_formats, jax_matrix, jax_write), "port": (port_formats, port_matrix, port_write)}


def oblique_affine():
    angle = 0.4
    out = np.eye(4)
    out[:3, :3] = np.array(
        [[np.cos(angle), 0.0, np.sin(angle)], [0.0, 1.0, 0.0], [-np.sin(angle), 0.0, np.cos(angle)]]
    ) @ np.diag([0.9375, 1.25, 2.0])
    out[:3, 3] = (-91.5, 17.25, 60.0)
    return out


def data(dtype, channels, seed=0):
    rng = np.random.default_rng(seed)
    shape = (channels, 7, 6, 5)
    if np.issubdtype(dtype, np.floating):
        return (rng.standard_normal(shape) * 50).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)


IMAGE_FILES = {
    "nrrd-gzip": ("x.nrrd", "nrrd", dict(encoding="gzip")),
    "nrrd-raw": ("x.nrrd", "nrrd", dict(encoding="raw")),
    "nhdr": ("x.nhdr", "nrrd", dict(encoding="gzip")),
    "mha": ("x.mha", "meta", {}),
    "mha-raw": ("x.mha", "meta", dict(compressed=False)),
    "mhd": ("x.mhd", "meta", {}),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.uint32, np.float32, np.float64, np.uint8])
@pytest.mark.parametrize("kind", list(IMAGE_FILES))
def test_images_cross_packages(tmp_path, kind, dtype, channels, writer):
    name, fmt, kwargs = IMAGE_FILES[kind]
    volume = data(dtype, channels, seed=channels)
    path = tmp_path / name
    formats = PACKAGES[writer][0]
    write = formats.write_nrrd if fmt == "nrrd" else formats.write_meta_image
    source = torch.from_numpy(volume) if writer == "port" and dtype != np.uint32 else volume
    write(path, source, oblique_affine(), **kwargs)
    reads = {}
    for reader, (module, _, _) in PACKAGES.items():
        read = module.read_nrrd if fmt == "nrrd" else module.read_meta_image
        reads[reader] = read(path)
    (got, got_affine), (want, want_affine) = reads["port"], reads["jax"]
    assert got.dtype == want.dtype == volume.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, volume)
    assert got_affine.dtype == np.float64
    np.testing.assert_array_equal(got_affine, want_affine)
    np.testing.assert_allclose(got_affine, oblique_affine(), atol=1e-12)


@pytest.mark.parametrize("fmt", ["nrrd", "meta"])
def test_image_writer_errors(tmp_path, fmt):
    for module, _, _ in PACKAGES.values():
        write = module.write_nrrd if fmt == "nrrd" else module.write_meta_image
        with pytest.raises(ValueError, match="Expected"):
            write(tmp_path / ("x.nrrd" if fmt == "nrrd" else "x.mha"), np.zeros((2, 2)))
    for module, _, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="Unsupported NRRD encoding"):
            module.write_nrrd(tmp_path / "x.nrrd", np.zeros((1, 2, 2, 2)), encoding="bzip2")


def matrix(seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    out = np.eye(4)
    out[:3, :3] = q * rng.uniform(0.8, 1.2, 3)
    out[:3, 3] = rng.uniform(-20, 20, 3)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("suffix", [".tfm", ".txt", ".trsf", ".h5"])
def test_matrices_cross_packages(tmp_path, suffix, writer):
    if suffix == ".h5":
        pytest.importorskip("h5py")
    path = tmp_path / f"m{suffix}"
    PACKAGES[writer][1].write_matrix(matrix(), path)
    got = port_matrix.read_matrix(path)
    want = jax_matrix.read_matrix(path)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    atol = 1e-7 if suffix in (".txt", ".trsf") else 1e-12  # the text files keep 8 decimals
    np.testing.assert_allclose(got, matrix(), atol=atol)


def test_matrix_from_tensor_and_errors(tmp_path):
    port_matrix.write_matrix(torch.from_numpy(matrix(1)), tmp_path / "t.tfm")
    jax_matrix.write_matrix(matrix(1), tmp_path / "j.tfm")
    assert (tmp_path / "t.tfm").read_text() == (tmp_path / "j.tfm").read_text()
    bad = tmp_path / "bad.tfm"
    bad.write_text("#Insight Transform File V1.0\nParameters: 1 0 0\n")
    for _, module, _ in PACKAGES.values():
        with pytest.raises(ValueError, match="Could not parse ITK transform"):
            module.read_matrix(bad)
        with pytest.raises(ValueError, match="Unknown suffix"):
            module.read_matrix(tmp_path / "t.mystery")
        with pytest.raises(ValueError, match="Unknown suffix"):
            module.write_matrix(np.eye(4), tmp_path / "t.mystery")


def test_optional_dependency_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # an import of it fails
    with pytest.raises(ImportError, match="pip install h5py"):
        get_optional("h5py", ".h5 transform files")
    with pytest.raises(ImportError, match="'h5py'"):
        port_matrix.read_matrix("t.h5")


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".nrrd", ".nhdr", ".mha", ".mhd"])
def test_write_image_by_suffix(tmp_path, suffix):
    volume = data(np.int16, 2, seed=5)
    jax_write.write_image(tmp_path / f"j{suffix}", volume, oblique_affine())
    port_write.write_image(tmp_path / f"p{suffix}", torch.from_numpy(volume), oblique_affine())
    previous = tt.set_default_device("cpu")
    try:
        for name in ("j", "p"):
            image = tt.ScalarImage(tmp_path / f"{name}{suffix}")
            np.testing.assert_array_equal(image.numpy(), volume)
            np.testing.assert_allclose(image.affine.data, oblique_affine(), atol=1e-5)
    finally:
        tt.set_default_device(previous)


def test_write_image_suffixes_and_deferred(tmp_path):
    """Every suffix the JAX package writes, the port writes: ``.dcm`` and a
    directory (existing, or a path ending in a separator) as DICOM that
    the JAX reader reads back; ``.nii.zarr`` as the JAX package does
    (an ``ImportError`` without zarr)."""
    from torchio_tpu.io import dicom as jax_dicom

    assert port_write.supported_write_suffixes() == jax_write.supported_write_suffixes()
    volume = data(np.int16, 1, seed=6)
    (tmp_path / "existing").mkdir()
    for target in ("x.dcm", "existing", f"{tmp_path}/series/"):
        path = tmp_path / target if not target.endswith("/") else target
        port_write.write_image(path, torch.from_numpy(volume), oblique_affine())
        read = jax_dicom.read_dicom_file if target.endswith(".dcm") else jax_dicom.read_dicom_dir
        got, affine = read(tmp_path / target.rstrip("/").split("/")[-1])
        np.testing.assert_array_equal(got, volume)
        np.testing.assert_allclose(affine, oblique_affine(), atol=1e-6)
    errors = []
    for module in (jax_write, port_write):
        try:
            module.write_image(tmp_path / f"{module.__name__}.nii.zarr", volume)
        except ImportError as error:  # zarr is not installed
            errors.append(str(error))
        else:
            errors.append(None)
    assert errors[0] == errors[1]
    for module in (jax_write, port_write):
        with pytest.raises(ValueError, match="Unsupported output format"):
            module.write_image(tmp_path / "x.png", np.zeros((1, 2, 2, 2), np.float32))
