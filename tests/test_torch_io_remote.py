"""Port parity: remote sources (fsspec) and NIfTI-Zarr stores.

- ``is_remote``/``is_nifti_zarr``/``is_remote_nifti_zarr`` and
  ``resolve_source`` (a path, a URI, an fsspec ``OpenFile``, a refused
  type) answer as the JAX package's.
- fsspec's ``memory://`` filesystem plays a remote store: a NIfTI file
  there is fetched by the registry's remote matcher, lazily from a
  ``ScalarImage``, and reads the JAX package's data and affine.
- ``ZarrBackend`` over an in-memory stand-in of ``zarr`` (``zarr.open``
  and array duck typing; the wheel is not installed here), 3D and 4D,
  through the registry too; with the real ``zarr`` (``importorskip``) a
  store written by the port's ``write_nifti_zarr`` reads back in both
  packages; without it, the ``ImportError``s are the JAX package's.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import backends as jax_backends
from torchio_tpu.io import nifti as jax_nifti
from torchio_tpu.io import remote as jax_remote
from torchio_tpu.io import write as jax_write
import torchio_tpu_torch as tt
from torchio_tpu_torch.io import backends as port_backends
from torchio_tpu_torch.io import remote as port_remote
from torchio_tpu_torch.io import write as port_write

fsspec = pytest.importorskip("fsspec")


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def affine():
    out = np.diag([0.8, 1.2, 2.5, 1.0])
    out[:3, 3] = (-30.0, 12.5, 7.25)
    return out


@pytest.fixture
def memory_nifti(tmp_path):
    """A ``.nii.gz`` in fsspec's memory filesystem; its URI and data."""
    data = np.random.default_rng(0).standard_normal((1, 6, 7, 5)).astype(np.float32)
    local = tmp_path / "t1.nii.gz"
    jax_nifti.write_nifti(local, data, affine())
    fs = fsspec.filesystem("memory")
    fs.pipe_file("/port_remote_t1.nii.gz", local.read_bytes())
    yield "memory://port_remote_t1.nii.gz", data
    fs.rm("/port_remote_t1.nii.gz")


SOURCES = (
    "http://x/y.nii", "s3://b/k.nii.gz", "gs://b/k.nii", "memory://t1.nii.gz", "abfs://c/p.nii",
    "/local/path.nii.gz", "relative.nii", "store.nii.zarr", "store.nii.zarr/", "s3://b/v.nii.zarr",
    "x.ome.zarr", 12, None,
)


def test_source_predicates():
    for source in SOURCES:
        for name in ("is_remote", "is_nifti_zarr", "is_remote_nifti_zarr"):
            assert getattr(port_remote, name)(source) == getattr(jax_remote, name)(source), (name, source)


def test_remote_nifti_through_the_registry(memory_nifti):
    uri, data = memory_nifti
    want = jax_backends.resolve_backend(jax_backends.BackendRequest(source=uri))
    got = port_backends.resolve_backend(port_backends.BackendRequest(source=uri))
    assert isinstance(got, port_backends.NiftiBackend)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_array_equal(got.to_array(), want.to_array())
    image = tt.ScalarImage(uri)
    assert image._uri == uri and not image.is_loaded
    assert image.shape == (1, 6, 7, 5)
    np.testing.assert_array_equal(image.numpy(), data)
    np.testing.assert_array_equal(image.affine.data, want.affine)
    flipped = tt.Flip(axes=(0,))(tt.ScalarImage(uri))
    np.testing.assert_array_equal(flipped.numpy(), data[:, ::-1])


def test_fetch_and_resolve(tmp_path):
    fs = fsspec.filesystem("memory")
    fs.pipe_file("/port_raw.nii.gz", b"not-really-nifti")
    try:
        for module in (jax_remote, port_remote):
            local = module._fetch_remote("memory://port_raw.nii.gz")
            assert str(local).endswith(".nii.gz") and local.read_bytes() == b"not-really-nifti"
            local.unlink()
    finally:
        fs.rm("/port_raw.nii.gz")
    path = tmp_path / "x.nii"
    assert port_remote.resolve_source(path) is path
    assert port_remote.resolve_source(str(path)) == jax_remote.resolve_source(str(path)) == path
    payload = tmp_path / "payload.nii.gz"
    payload.write_bytes(b"openfile-bytes")
    for module in (jax_remote, port_remote):
        local = module.resolve_source(fsspec.open(str(payload), "rb"), suffix=".nii.gz")
        assert local.read_bytes() == b"openfile-bytes" and str(local).endswith(".nii.gz")
        local.unlink()
        with pytest.raises(TypeError, match="Cannot resolve"):
            module.resolve_source(12345)


def test_missing_remote_file(memory_nifti):
    for make in (lambda uri: tt.ScalarImage(uri).shape, lambda uri: jax_remote.resolve_source(uri)):
        with pytest.raises(FileNotFoundError):
            make("memory://no_such_file.nii.gz")


@pytest.fixture
def zarr_stub(monkeypatch):
    """A stand-in ``zarr`` module: ``open`` returns a registered array (or
    the array it is given, as a store object)."""

    class FakeArray:
        def __init__(self, arr, attrs=None):
            self._arr = arr
            self.shape = arr.shape
            self.dtype = arr.dtype
            self.attrs = attrs or {}

        def __getitem__(self, key):
            return self._arr[key]

        def __array__(self, dtype=None, copy=None):
            return np.asarray(self._arr, dtype)

    FakeArray.__module__ = "zarr.core"
    module = types.ModuleType("zarr")
    module.stores = {}
    module.open = lambda source, mode="r": (
        source if isinstance(source, FakeArray) else module.stores[source]
    )
    module.FakeArray = FakeArray
    monkeypatch.setitem(sys.modules, "zarr", module)
    return module


REGIONS = (
    (slice(0, 1), slice(1, 3), slice(2, 5), slice(0, 4)),
    (slice(None), slice(0, 6, 2), slice(None), slice(3, 4)),
)


@pytest.mark.parametrize("channels", [None, 2])
def test_zarr_backend(zarr_stub, channels):
    rng = np.random.default_rng(channels or 1)
    shape = (6, 7, 8) if channels is None else (channels, 6, 7, 8)
    arr = rng.standard_normal(shape).astype(np.float32)
    attrs = {"affine": affine().tolist()} if channels is None else {}
    zarr_stub.stores["store.nii.zarr"] = zarr_stub.FakeArray(arr, attrs)
    backends = [module.ZarrBackend("store.nii.zarr") for module in (jax_remote, port_remote)]
    request = port_backends.BackendRequest(source="store.nii.zarr")
    backends.append(port_backends.resolve_backend(request))
    backends.append(port_backends.resolve_backend(port_backends.BackendRequest(source=zarr_stub.stores["store.nii.zarr"])))
    want = backends[0]
    for got in backends[1:]:
        assert isinstance(got, port_remote.ZarrBackend)
        assert got.shape == want.shape == ((1,) + shape if channels is None else shape)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.affine, want.affine)
        np.testing.assert_array_equal(got.to_array(), want.to_array())
        for region in REGIONS:
            np.testing.assert_array_equal(got[region], want[region])
    image = tt.ScalarImage("store.nii.zarr")
    np.testing.assert_array_equal(image.numpy(), want.to_array())
    np.testing.assert_array_equal(image.affine.data, want.affine)


def test_zarr_missing_errors(tmp_path):
    if "zarr" in sys.modules or _importable("zarr"):
        pytest.skip("zarr is installed: its absence cannot be shown")
    for remote, write in ((jax_remote, jax_write), (port_remote, port_write)):
        with pytest.raises(ImportError) as read_error:
            remote.ZarrBackend("anything.nii.zarr")
        with pytest.raises(ImportError) as write_error:
            write.write_image(tmp_path / "x.nii.zarr", np.zeros((1, 2, 2, 2), np.float32))
        if remote is jax_remote:
            want = str(read_error.value), str(write_error.value)
        else:
            assert (str(read_error.value), str(write_error.value)) == want
    with pytest.raises(ImportError, match="requires the 'zarr' package"):
        tt.ScalarImage(str(tmp_path / "y.nii.zarr")).shape


def _importable(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


def test_zarr_round_trip(tmp_path):
    pytest.importorskip("zarr")
    arr = np.random.default_rng(3).standard_normal((2, 4, 5, 6)).astype(np.float32)
    store = tmp_path / "v.nii.zarr"
    port_write.write_nifti_zarr(store, arr, affine(), chunks=(2, 2, 2, 2))
    for module in (jax_remote, port_remote):
        backend = module.ZarrBackend(str(store))
        np.testing.assert_array_equal(backend.to_array(), arr)
        np.testing.assert_array_equal(backend.affine, affine())
        np.testing.assert_array_equal(backend[REGIONS[0]], arr[REGIONS[0]])
    np.testing.assert_array_equal(tt.ScalarImage(store).numpy(), arr)
