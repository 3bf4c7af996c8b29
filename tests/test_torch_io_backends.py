"""Port parity: the lazy backends and their registry against the JAX package.

- ``normalize_index`` and ``slices_shape`` on seeded indices;
- ``ArrayBackend``, ``NiftiBackend``, ``CroppedBackend`` and
  ``PaddedBackend`` (fills 0, -1.5 and 7; crops of pads and pads of
  crops; regions inside, across and outside the parent) read equal
  regions, shapes, dtypes and float64 affines in both packages;
- the registry: the same matcher names in the same order, a custom
  reader (a callable and a ``LazyReader``), a user-registered backend and
  an incomplete one, the NIfTI sniff of an unusual suffix, and the
  DICOM, remote and zarr sources, which the port does not read yet
  (``NotImplementedError``).
"""

from __future__ import annotations

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

from torchio_tpu.io import backends as jb
from torchio_tpu.io import nifti as jax_nifti
from torchio_tpu_torch.io import backends as pb

SHAPE = (2, 9, 8, 7)


def volume(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE) * 100).astype(dtype)


def affine():
    out = np.diag([0.9, 1.1, 2.5, 1.0])
    out[:3, :3] += 0.05
    out[:3, 3] = (-40.0, 30.5, -12.25)
    return out


def random_index(rng, shape):
    """A seeded index: ints, slices with negative starts and steps, an
    ellipsis."""
    items = []
    for size in shape:
        kind = rng.integers(0, 4)
        if kind == 0:
            items.append(int(rng.integers(-size, size)))
        elif kind == 1:
            a, b = sorted(rng.integers(-size, size + 1, 2))
            items.append(slice(int(a), int(b)))
        elif kind == 2:
            a, b = sorted(rng.integers(0, size + 1, 2))
            items.append(slice(int(b), int(a), -int(rng.integers(1, 3))))
        else:
            items.append(slice(None, None, int(rng.integers(1, 3))))
    cut = int(rng.integers(0, 5))
    index = tuple(items[:cut])
    if rng.integers(0, 2):
        index = index + (Ellipsis,)
    return index


def test_normalize_index_and_slices_shape():
    rng = np.random.default_rng(0)
    for _ in range(300):
        index = random_index(rng, SHAPE)
        got = pb.normalize_index(index, SHAPE)
        assert got == jb.normalize_index(index, SHAPE)
        assert pb.slices_shape(got) == jb.slices_shape(got)


@pytest.mark.parametrize(
    "index, error",
    [((0, 0, 0, 0, 0), "Too many"), ((..., 0, ...), "single ellipsis"), ((9,), "out of range"),
     (([0],), "Unsupported index")],
)
def test_normalize_index_errors(index, error):
    for module in (jb, pb):
        with pytest.raises(IndexError, match=error):
            module.normalize_index(index, SHAPE)


def regions(rng, shape, n=12):
    for _ in range(n):
        index = []
        for size in shape:
            a, b = sorted(rng.integers(0, size + 1, 2))
            index.append(slice(int(a), int(max(b, a + 1))))
        yield pb.normalize_index(tuple(index), shape)


def assert_same_backend(jax_backend, port_backend, seed=0):
    assert tuple(port_backend.shape) == tuple(jax_backend.shape)
    assert port_backend.dtype == jax_backend.dtype
    np.testing.assert_array_equal(port_backend.affine, jax_backend.affine)
    assert port_backend.affine.dtype == np.float64
    np.testing.assert_array_equal(port_backend.to_array(), jax_backend.to_array())
    for region in regions(np.random.default_rng(seed), tuple(port_backend.shape)):
        want, got = jax_backend[region], port_backend[region]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def parents(kind, tmp_path, dtype=np.float32):
    data = volume(1, dtype)
    if kind == "array":
        return jb.ArrayBackend(data, affine()), pb.ArrayBackend(data, affine())
    path = tmp_path / ("v.nii.gz" if kind == "nifti-gz" else "v.nii")
    jax_nifti.write_nifti(path, data, affine())
    return jb.NiftiBackend(path), pb.NiftiBackend(path)


@pytest.mark.parametrize("kind", ["array", "nifti", "nifti-gz"])
def test_parents(tmp_path, kind):
    assert_same_backend(*parents(kind, tmp_path))


CROPS = (
    (slice(0, 2), slice(1, 8), slice(0, 5), slice(2, 7)),
    (slice(1, 2), slice(3, 4), slice(2, 8), slice(0, 7)),
)
PADS = (((1, 2, 0), (0, 3, 2)), ((4, 0, 1), (2, 2, 0)))


@pytest.mark.parametrize("fill", [0.0, -1.5, 7.0])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint16])
@pytest.mark.parametrize("kind", ["array", "nifti", "nifti-gz"])
def test_crop_and_pad_views(tmp_path, kind, dtype, fill):
    """Crops, pads, crops of pads and pads of crops equal in both
    packages, every region read through all the views at once."""
    jax_parent, port_parent = parents(kind, tmp_path, dtype)
    for crop in CROPS:
        jax_crop = jb.CroppedBackend(jax_parent, crop)
        port_crop = pb.CroppedBackend(port_parent, crop)
        assert_same_backend(jax_crop, port_crop)
        for before, after in PADS:
            assert_same_backend(
                jb.PaddedBackend(jax_crop, before, after, fill),
                pb.PaddedBackend(port_crop, before, after, fill),
            )
    for n, (before, after) in enumerate(PADS):
        jax_pad = jb.PaddedBackend(jax_parent, before, after, fill)
        port_pad = pb.PaddedBackend(port_parent, before, after, fill)
        assert_same_backend(jax_pad, port_pad, seed=n)
        window = pb.normalize_index((slice(None), slice(0, 6), slice(2, 11), slice(1, 8)), port_pad.shape)
        assert_same_backend(jb.CroppedBackend(jax_pad, window), pb.CroppedBackend(port_pad, window))


def test_pad_region_outside_parent():
    data = volume(2)
    jax_pad = jb.PaddedBackend(jb.ArrayBackend(data), (3, 3, 3), (3, 3, 3), 5.0)
    port_pad = pb.PaddedBackend(pb.ArrayBackend(data), (3, 3, 3), (3, 3, 3), 5.0)
    region = (slice(0, 2), slice(0, 2), slice(0, 3), slice(0, 3))
    np.testing.assert_array_equal(port_pad[region], jax_pad[region])
    assert np.all(port_pad[region] == 5.0)


def test_registry_names_and_order():
    assert pb.registered_backends() == jb.registered_backends()


class _Reader:
    """A LazyReader: hands back an ArrayBackend of the module it is for."""

    def __init__(self, module):
        self.module = module

    def get_backend(self, request):
        return self.module.ArrayBackend(volume(3), affine())


@pytest.mark.parametrize("lazy", [False, True])
def test_custom_reader(tmp_path, lazy):
    for module in (jb, pb):
        reader = _Reader(module) if lazy else (lambda source: (volume(3), affine()))
        backend = module.resolve_backend(module.BackendRequest(source=tmp_path / "x.any", reader=reader))
        np.testing.assert_array_equal(backend.to_array(), volume(3))
        np.testing.assert_array_equal(backend.affine, affine())


def test_user_backend_and_incomplete_backend(tmp_path):
    class Incomplete:
        shape = SHAPE

    for module in (jb, pb):
        def magic(request, module=module):
            return module.ArrayBackend(volume(4)) if request.suffix == ".magic" else None

        module.register_backend("magic", magic)
        module.register_backend("incomplete", lambda r: Incomplete() if r.suffix == ".bad" else None)
        try:
            backend = module.resolve_backend(module.BackendRequest(source=b"raw", suffix=".magic"))
            np.testing.assert_array_equal(backend.to_array(), volume(4))
            with pytest.raises(TypeError, match="does not implement ImageDataBackend"):
                module.resolve_backend(module.BackendRequest(source=b"raw", suffix=".bad"))
        finally:
            module.unregister_backend("magic")
            module.unregister_backend("incomplete")
        assert "magic" not in module.registered_backends()
    assert pb.registered_backends() == jb.registered_backends()


def test_sniff_and_unreadable(tmp_path):
    path = tmp_path / "volume.img_data"
    jax_nifti.write_nifti(path, volume(5))
    want = jb.resolve_backend(jb.BackendRequest(source=path))
    got = pb.resolve_backend(pb.BackendRequest(source=path))
    assert isinstance(got, pb.NiftiBackend)
    assert_same_backend(want, got)
    junk = tmp_path / "junk.txt"
    junk.write_bytes(b"junk" * 200)
    for module in (jb, pb):
        with pytest.raises(ValueError, match="No backend can read"):
            module.resolve_backend(module.BackendRequest(source=junk))
        with pytest.raises(ValueError, match="No backend can read"):
            module.resolve_backend(module.BackendRequest(source=b"junk" * 200))


def test_deferred_sources_raise(tmp_path):
    """DICOM, remote and zarr sources are the next slice's: recognised and
    refused with the ROADMAP item, never read as something else."""
    dicom = tmp_path / "slice.dcm"
    dicom.write_bytes(b"\x00" * 128 + b"DICM" + b"\x00" * 64)
    series = tmp_path / "series"
    series.mkdir()
    (series / "001").write_bytes(b"\x00" * 128 + b"DICM" + b"\x00" * 64)
    for source in (dicom, series, "https://example.org/t1.nii.gz", str(tmp_path / "a.nii.zarr")):
        with pytest.raises(NotImplementedError, match="Queue 1, item 3b"):
            pb.resolve_backend(pb.BackendRequest(source=source))
    plain_dir = tmp_path / "plain"
    plain_dir.mkdir()
    (plain_dir / "notes.txt").write_text("no images here")
    with pytest.raises(ValueError, match="No backend can read"):
        pb.resolve_backend(pb.BackendRequest(source=plain_dir))
