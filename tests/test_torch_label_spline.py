"""Port parity: the label vote and the labelled B-spline slice against the
JAX package.

On the CPU the port runs its plain versions (what the CUDA kernels are
held to on the card; the prefilter and the spline alone are held to the
JAX package in ``test_torch_bspline.py`` and
``test_torch_spline_window.py``):

- the label vote, :func:`resample_label_plain`, against the JAX
  package's XLA vote (``_resample_element_label``) and its Pallas
  "corners" kernels in interpret mode (``window_resample_label_fused``,
  ``shear_resample_label_fused``): EXACTLY equal, except at voxels whose
  vote is a near tie (top two label scores, or the in-bounds weight
  against 0.5, within 1e-4), where the two float pipelines may round
  either way (XLA contracts the coordinate math into FMAs, the port
  does not);
- the slice end to end: ``Compose([Spatial(image_interpolation=<spline>,
  label_interpolation="label"), BiasField, Noise], fuse=True)`` on
  4-channel images and int32 label maps: history params equal, images
  within 1e-4, labels equal off near ties.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from test_torch_intensity import block_labels, jax_device_normal, make_batches
from test_torch_resample import _rot
from torchio_tpu.ops.resample import _resample_element_label
from torchio_tpu.ops.shear_resample import shear_eligible, shear_resample_label_fused
from torchio_tpu.ops.window_resample import window_eligible, window_resample_label_fused
from torchio_tpu_torch.ops import bspline as bs
from torchio_tpu_torch.ops import kernel_lib
from torchio_tpu_torch.transforms._utils import unique_labels
from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

# the ops package exports the function ``resample`` under its module's name
rs = importlib.import_module("torchio_tpu_torch.ops.resample")

TIE_BAND = 1e-4
SLICE_ATOL = 1e-4

pytestmark = pytest.mark.filterwarnings("ignore:The maximum displacement")


def _maps(spatial, rng, *, angles=((0.12, -0.08, 0.1), (-0.06, 0.1, -0.04)),
          elastic=(True, False), amplitude=2.0):
    ms = [
        _rot(*angles[i], scale=(1.05, 0.95)[i], shift=rng.uniform(-2, 2, 3),
             spatial=spatial)
        for i in range(len(angles))
    ]
    cps = [
        rng.uniform(-amplitude, amplitude, (5, 5, 5, 3)) if e else None for e in elastic
    ]
    return ms, cps


# --------------------------------------------------------------------------
# the label vote
# --------------------------------------------------------------------------


def _label_case(shape, *, out=None, dtype=np.int32, offset=0, labels=4, seed=0, **kw):
    rng = np.random.default_rng(seed)
    b, spatial = shape[0], shape[2:]
    data = np.stack([block_labels(rng, spatial, block=3) for _ in range(b)])
    if labels != 4:
        data = rng.integers(0, labels, shape)
    data = (data + offset).astype(dtype)
    ms, cps = _maps(spatial, rng, **kw)
    return dict(data=data, ms=ms, cps=cps, out=tuple(out or spatial), pad=7)


LABEL_CASES = {
    "int32-elastic": _label_case((2, 1, 16, 18, 40)),
    "int32-out-shape": _label_case((2, 1, 16, 18, 20), out=(19, 15, 23)),
    "random-labels": _label_case((2, 1, 14, 12, 16), labels=5, elastic=(True, True)),
    "above-2-24": _label_case((2, 1, 16, 18, 40), offset=2**24 + 1),
    "float-labels": _label_case((2, 1, 16, 18, 20), dtype=np.float32),
    "size-1-axis": _label_case(
        (2, 1, 16, 20, 1), angles=((0.0, 0.0, 0.2), (0.0, 0.0, -0.15))
    ),
    "window": _label_case(
        (2, 1, 16, 16, 40), elastic=(True, True),
        angles=((0.01, 0.0, -0.01), (0.0, 0.012, 0.0)),
    ),
}


def _port_labels(case) -> np.ndarray:
    out = rs.resample_label_fused(
        torch.as_tensor(case["data"]), case["ms"], case["cps"],
        out_shape=case["out"], pad_label=case["pad"],
    )
    assert out.dtype == torch.as_tensor(case["data"]).dtype
    return out.numpy()


def _near_ties(data, ms, cps, out_shape) -> np.ndarray:
    """(B, 1, *out) True where the vote is a near tie: the top two label
    scores, or the in-bounds weight against 0.5, within TIE_BAND (float64
    from the port's coordinates)."""
    maps, fields = rs._marshal_maps(ms, cps, "cpu")
    ties = []
    for b in range(len(ms)):
        coords = [c.double().numpy().reshape(-1) for c in rs._element_coords(
            maps, fields, b, out_shape)]
        vol = np.asarray(data[b, 0])
        sizes = vol.shape
        floors, weights = [], []
        for c, size in zip(coords, sizes):
            c = np.zeros_like(c) if size == 1 else c
            f = np.floor(c)
            frac = c - f
            floors.append(f.astype(np.int64))
            weights.append((
                (1 - frac) * ((f >= 0) & (f < size)),
                frac * ((f + 1 >= 0) & (f + 1 < size)),
            ))
        w, labs = [], []
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    w.append(weights[0][di] * weights[1][dj] * weights[2][dk])
                    idx = [np.clip(f + d, 0, s - 1) for f, d, s in zip(
                        floors, (di, dj, dk), sizes)]
                    labs.append(vol[idx[0], idx[1], idx[2]])
        w, labs = np.stack(w, 1), np.stack(labs, 1)
        scores = (w[:, None, :] * (labs[:, :, None] == labs[:, None, :])).sum(-1)
        top = scores.max(1)
        winner = labs[np.arange(len(labs)), scores.argmax(1)]
        second = np.where(labs != winner[:, None], scores, -1.0).max(1)
        wsum = w.sum(1)
        # a near tie between labels matters only where no pad replaces it
        near = ((top - second < TIE_BAND) & (wsum > 0.5 - TIE_BAND)) | (
            np.abs(wsum - 0.5) < TIE_BAND
        )
        ties.append(near.reshape(out_shape))
    return np.stack(ties)[:, None]


def _assert_labels_match(case, got, want):
    assert got.shape == want.shape
    ok = ~_near_ties(case["data"], case["ms"], case["cps"], case["out"])
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])


def _jax_vote(case) -> np.ndarray:
    outs = []
    for b in range(case["data"].shape[0]):
        cp = case["cps"][b]
        outs.append(_resample_element_label(
            jnp.asarray(case["data"][b]),
            jnp.asarray(np.asarray(case["ms"][b], np.float64), jnp.float32),
            jnp.zeros((1, 1, 1, 3), jnp.float32) if cp is None
            else jnp.asarray(cp, jnp.float32),
            case["pad"], case["out"], cp is not None,
        ))
    return np.stack([np.asarray(o) for o in outs])


@pytest.mark.parametrize("name", list(LABEL_CASES))
def test_label_vote_matches_jax_gather(name):
    case = LABEL_CASES[name]
    _assert_labels_match(case, _port_labels(case), _jax_vote(case))


@pytest.mark.parametrize("kernel", ["window", "shear"])
def test_label_vote_matches_jax_pallas_interpret(kernel, monkeypatch):
    monkeypatch.setenv("TORCHIO_TPU_WINDOW_INTERPRET", "1")
    case = LABEL_CASES["window" if kernel == "window" else "int32-elastic"]
    data, ms, cps, out = (case[k] for k in ("data", "ms", "cps", "out"))
    if kernel == "window":
        pads = window_eligible(data.shape, out, ms, cps, "linear")
        assert pads is not None
        want = window_resample_label_fused(data, ms, cps, case["pad"],
                                           padi=pads[0], padj=pads[1])
    else:
        plan = shear_eligible(data.shape, out, ms, cps, "linear")
        assert plan is not None
        want = shear_resample_label_fused(data, ms, cps, case["pad"], plan)
    _assert_labels_match(case, _port_labels(case), np.asarray(want))


def test_label_vote_exact_half_ties_pick_smallest_label():
    """Coordinates at exact .5 offsets: every corner weighs 1/8 and
    scores tie exactly; both packages take the smallest label."""
    lab = (np.arange(8 * 8 * 8).reshape(1, 1, 8, 8, 8) % 3).astype(np.int32)
    cp = np.full((2, 2, 2, 3), 0.5)
    case = dict(data=lab, ms=[np.eye(4)], cps=[cp], out=(8, 8, 8), pad=0)
    got = _port_labels(case)
    np.testing.assert_array_equal(got, _jax_vote(case))
    window = window_resample_label_fused(lab, [np.eye(4)], [cp], 0, padi=4, padj=8)
    np.testing.assert_array_equal(got, np.asarray(window))


def test_label_vote_keeps_labels_above_2_24():
    """int32 labels 2^24 + {1, 2} differ by one: a float32 round trip
    would merge them."""
    case = LABEL_CASES["above-2-24"]
    got = _port_labels(case)
    assert got.dtype == np.int32
    assert set(np.unique(got)) - {case["pad"]} <= set(np.unique(case["data"]))
    assert len(np.unique(got)) >= 4


def test_label_vote_identity_map_returns_the_labels():
    rng = np.random.default_rng(3)
    lab = torch.as_tensor(rng.integers(-5, 9, (2, 1, 6, 7, 9)), dtype=torch.int16)
    out = rs.resample_label_fused(lab, [np.eye(4)] * 2, [None, None])
    assert out.dtype == torch.int16 and torch.equal(out, lab)


def test_label_vote_rejects_several_channels():
    with pytest.raises(ValueError, match="B, 1, I, J, K"):
        rs.resample_label_fused(torch.zeros((1, 2, 4, 4, 4)), [np.eye(4)], [None])


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

SHAPE = (4, 16, 18, 24)


def brats_like(pkg, image_interpolation="bspline", **kw):
    return pkg.Compose(
        [
            pkg.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
                image_interpolation=image_interpolation,
                label_interpolation="label",
                **kw,
            ),
            pkg.BiasField(std=0.5),
            pkg.Noise(std=0.1),
        ],
        fuse=True,
    )


def _label_ties_from_history(port_out, seg_in, name="seg"):
    params = port_out.applied_transforms[0].params
    affine = port_out.images[name].affines[0]
    grids = [
        _build_grid(
            input_affine=affine, output_shape=SHAPE[1:], output_affine=affine,
            affine_matrix=params["affine_matrix"][i],
            control_points=params["control_points"][i],
            max_displacement=params["max_displacement"][i], affine_first=True,
        )
        for i in range(len(params["affine_matrix"]))
    ]
    return _near_ties(seg_in, [g[0] for g in grids], [g[1] for g in grids], SHAPE[1:])


@pytest.mark.parametrize(
    "interpolation", ["bspline", 2, 3, "fourth", 5, "sixth", 7],
)
def test_labelled_slice_matches_jax(interpolation, monkeypatch):
    monkeypatch.setattr(tt.random, "device_normal", jax_device_normal)
    jax_batch, port_batch = make_batches(b=2, shape=SHAPE, seed=1, names=("mri",),
                                         labels=("seg",))
    seg_in = port_batch.seg.data.numpy()
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(2024)
        outs.append(brats_like(pkg, interpolation)(batch))
    jax_out, port_out = outs
    assert [(h.name, h.params) for h in jax_out.applied_transforms] == [
        (h.name, h.params) for h in port_out.applied_transforms
    ]
    order = {"bspline": 3, "fourth": 4, "sixth": 6}.get(interpolation, interpolation)
    assert port_out.applied_transforms[0].params["image_interpolation"] == [
        None, None, "quadratic", "cubic", "fourth", "fifth", "sixth", "seventh"
    ][order]
    mri = port_out.mri.data.numpy()
    assert mri.shape == (2, *SHAPE) and np.isfinite(mri).all()
    np.testing.assert_allclose(mri, np.asarray(jax_out.mri.data), rtol=0, atol=SLICE_ATOL)
    seg = port_out.seg.data
    assert seg.dtype == torch.int32 and seg.shape == (2, 1, *SHAPE[1:])
    ok = ~_label_ties_from_history(port_out, seg_in)
    np.testing.assert_array_equal(seg.numpy()[ok], np.asarray(jax_out.seg.data)[ok])


@pytest.mark.parametrize("one_hot", ["nearest", "cubic"])
def test_one_hot_label_path_matches_jax(one_hot):
    """One channel with a non-linear one-hot interpolation takes the
    unique-labels one-hot path; near ties of the one-hot maps masked."""
    jax_batch, port_batch = make_batches(b=2, shape=(1, *SHAPE[1:]), seed=2,
                                         names=("t1",), labels=("seg",))
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(5)
        spatial = pkg.Spatial(degrees=(-10.0, 10.0), max_displacement=5.0,
                              label_interpolation="label",
                              one_hot_label_interpolation=one_hot)
        outs.append(spatial(batch))
    jax_out, port_out = outs
    assert jax_out.applied_transforms[0].params == port_out.applied_transforms[0].params
    got, want = port_out.seg.data.numpy(), np.asarray(jax_out.seg.data)
    assert got.dtype == want.dtype == np.int32
    assert (got == want).mean() > 0.995
    assert set(np.unique(got)) <= {0, 1, 2, 4}


def test_multichannel_label_map_matches_jax():
    """Several channels: each is resampled as a float map (int labels
    come back float32, as in the JAX package)."""
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 2, (2, *SHAPE[1:])).astype(np.int32)
    outs = []
    for pkg in (tj, tt):
        pkg.seed(6)
        subject = pkg.Subject(seg=pkg.LabelMap(seg))
        spatial = pkg.Affine(degrees=(-10.0, 10.0), label_interpolation="label")
        outs.append(spatial(subject).seg.data)
    got, want = np.asarray(outs[1]), np.asarray(outs[0])
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("make", ["affine", "elastic"])
def test_wrappers_take_label_and_spline_modes(make, monkeypatch):
    monkeypatch.setattr(tt.random, "device_normal", jax_device_normal)
    jax_batch, port_batch = make_batches(b=2, shape=(1, *SHAPE[1:]), seed=3,
                                         names=("t1",), labels=("seg",))
    outs = []
    for pkg, batch in ((tj, jax_batch), (tt, port_batch)):
        pkg.seed(8)
        cls = pkg.Affine if make == "affine" else pkg.ElasticDeformation
        kw = {"degrees": (-8.0, 8.0)} if make == "affine" else {"max_displacement": 4.0}
        outs.append(cls(image_interpolation=4, label_interpolation="label", **kw)(batch))
    jax_out, port_out = outs
    assert jax_out.applied_transforms[0].params == port_out.applied_transforms[0].params
    np.testing.assert_allclose(port_out.t1.data.numpy(), np.asarray(jax_out.t1.data),
                               rtol=0, atol=SLICE_ATOL)
    assert (port_out.seg.data.numpy() == np.asarray(jax_out.seg.data)).mean() > 0.995


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"image_interpolation": "label"}, 'cannot be "label"'),
        ({"one_hot_label_interpolation": "label"}, 'cannot be "label"'),
        ({"image_interpolation": 8}, "order must be 0-7"),
        ({"label_interpolation": "lanczos"}, "Unknown interpolation"),
    ],
)
def test_interpolation_names_are_checked_like_the_jax_package(kwargs, error):
    for pkg in (tj, tt):
        with pytest.raises(ValueError, match=error):
            pkg.Spatial(**kwargs)


# --------------------------------------------------------------------------
# labels through the data model and the intensity chain
# --------------------------------------------------------------------------


def test_int_label_map_flows_through_batch_and_fused_chain():
    _, batch = make_batches(b=3, shape=(2, 8, 9, 10), names=("mri",), labels=("seg",))
    seg = batch.seg.data.clone()
    assert seg.dtype == torch.int32 and batch.seg.image_class is tt.LabelMap
    batch.to("cpu")
    tt.seed(1)
    out = tt.Compose([tt.BiasField(std=0.5), tt.Noise(std=0.1)], fuse=True)(batch)
    assert torch.equal(out.seg.data, seg)
    assert not torch.equal(out.mri.data, batch.mri.data)
    subjects = out.unbatch()
    for i, subject in enumerate(subjects):
        assert isinstance(subject.seg, tt.LabelMap)
        assert subject.seg.data.dtype == torch.int32
        assert torch.equal(subject.seg.data, seg[i])


def test_unique_labels():
    ints = torch.as_tensor([[3, 0, 3], [7, 0, 1]], dtype=torch.int32)
    assert unique_labels(ints) == [0, 1, 3, 7]
    assert unique_labels(ints - 2) == [-2, -1, 1, 5]
    assert unique_labels(torch.as_tensor([0.0, 2.7, 2.0])) == [0, 2, 2]


# --------------------------------------------------------------------------
# the kernel wrappers on the CPU
# --------------------------------------------------------------------------


def test_other_devices_raise_instead_of_taking_the_plain_path(monkeypatch):
    monkeypatch.setattr(rs, "resample_label_plain", lambda *a: pytest.fail("plain"))
    monkeypatch.setattr(bs, "prefilter_plain", lambda *a: pytest.fail("plain"))
    data = torch.zeros((1, 1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rs.resample_label_fused(data, [np.eye(4)], [None])
    with pytest.raises(ValueError, match="cuda or cpu"):
        bs.bspline_resample_fused(data, [np.eye(4)], [None], order=3)


def test_kernel_wrappers_reject_cpu_tensors():
    from torchio_tpu_torch.ops.bspline_kernel import bspline_resample_cuda, prefilter_cuda
    from torchio_tpu_torch.ops.resample_kernel import resample_label_cuda

    vol = torch.zeros((1, 1, 4, 4, 4))
    maps = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        resample_label_cuda(vol.int(), maps, None, (4, 4, 4), 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        prefilter_cuda(vol, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bspline_resample_cuda(vol, maps, None, torch.zeros((1, 1)), (4, 4, 4), 3)


def test_every_kernel_is_counted_and_rebuilt_when_a_header_changes(tmp_path, monkeypatch):
    assert {"resample", "label_vote", "bspline_prefilter", "bspline_resample"} <= set(
        kernel_lib.LAUNCHES
    )
    monkeypatch.setattr(kernel_lib.config, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "h.cuh").write_text("// header\n")
    library = kernel_lib.KernelLibrary("k.cu", {}, kernels=("k",))
    kernel_lib.LIBRARIES.remove(library)
    before = library.path()
    (tmp_path / "h.cuh").write_text("// header, changed\n")
    assert library.path() != before
    kernel_lib.LAUNCHES.pop("k")


def test_failed_build_reports_the_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_lib.config, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_lib.config, "nvcc", lambda: "false")
    library = kernel_lib.KernelLibrary("resample.cu", {}, kernels=())
    kernel_lib.LIBRARIES.remove(library)
    with pytest.raises(RuntimeError, match="nvcc failed on resample.cu"):
        library.build()
    assert not list(tmp_path.glob("*.so"))
