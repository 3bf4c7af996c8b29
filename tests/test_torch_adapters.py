"""Port parity: MonaiAdapter and CornucopiaAdapter against the JAX package's.

Neither monai nor cornucopia is installed: CornucopiaAdapter takes any
callable, and MONAI is the in-memory stand-in of
``tests/test_adapters.py`` (a module with ``MetaTensor`` and
``MapTransform``, the two symbols the adapter touches), copied here. The
cases of ``tests/test_adapters.py`` run through both packages on the
same data, and their results are equal.

The deliberate divergence: the JAX adapters copy each image through
numpy into a new torch tensor and back; the port hands over the image's
own tensor (a view of the batch's tensor, on its device) and keeps the
tensor it gets back, with no copy to the host.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def make_subjects(site=None) -> list:
    """The same subject in each package: a scalar t1 and a label seg."""
    t1 = np.random.default_rng(0).random((1, 8, 8, 8)).astype(np.float32) * 100 + 1
    seg = np.zeros((1, 8, 8, 8), np.float32)
    seg[0, 2:5, 3:6, 1:4] = 2
    out = []
    for pkg in (tj, tt):
        subject = pkg.Subject(t1=pkg.ScalarImage(t1), seg=pkg.LabelMap(seg))
        if site is not None:
            subject["site"] = site
        out.append(subject)
    return out


def assert_same(want, got):
    assert list(got.images) == list(want.images)
    for name in want.images:
        np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(want[name].data))
        np.testing.assert_array_equal(got[name].affine.data, want[name].affine.data)
    assert [h.name for h in got.applied_transforms] == [h.name for h in want.applied_transforms]


def plus_one(*tensors):
    return tuple(x + 1 for x in tensors)


CORNUCOPIA_CASES = {
    "applies": (plus_one, {}),
    "p-zero": (plus_one, {"p": 0.0}),
    "include": (plus_one, {"include": ["seg"]}),
    "exclude": (plus_one, {"exclude": ["seg"]}),
    "single-tensor": (lambda t1, seg: (t1 * 2, seg), {}),
    "numpy-return": (lambda t: np.asarray(t) * 3, {"include": ["t1"]}),
    "no-match": (plus_one, {"include": ["no_such_image"]}),
    "flip": (lambda *t: tuple(torch.flip(x, (-1,)) for x in t), {}),
}


@pytest.mark.parametrize("case", list(CORNUCOPIA_CASES))
def test_cornucopia_equal_jax(case):
    fn, kwargs = CORNUCOPIA_CASES[case]
    want_in, got_in = make_subjects()
    want = tj.CornucopiaAdapter(fn, **kwargs)(want_in)
    got = tt.CornucopiaAdapter(fn, **kwargs)(got_in)
    assert_same(want, got)


def test_cornucopia_batch_equal_jax():
    batches = [
        pkg.SubjectsBatch.from_subjects([s, s]) for pkg, s in zip((tj, tt), make_subjects())
    ]
    want, got = (pkg.CornucopiaAdapter(plus_one)(b) for pkg, b in zip((tj, tt), batches))
    assert isinstance(got, tt.SubjectsBatch)
    for name in ("t1", "seg"):
        np.testing.assert_array_equal(got[name].data.numpy(), np.asarray(want[name].data))


def test_cornucopia_order_count_and_errors():
    received = []

    def spy(*tensors):
        received.extend("scalar" if float(t.sum()) > 1000 else "label" for t in tensors)
        return tensors

    tt.CornucopiaAdapter(spy)(make_subjects()[1])
    assert received == ["scalar", "label"]
    for pkg, subject in zip((tj, tt), make_subjects()):
        with pytest.raises(ValueError, match="2 input images") as info:
            pkg.CornucopiaAdapter(lambda *t: (t[0],))(subject)
        with pytest.raises(TypeError, match="callable"):
            pkg.CornucopiaAdapter(42)
        assert pkg.CornucopiaAdapter(lambda *t: t).invertible is False
    assert str(info.value) == "Cornucopia transform returned 1 tensors for 2 input images"


def test_cornucopia_hands_over_the_images_own_tensors():
    """The tensors a callable gets are views of the batch's tensors (no
    copy through numpy), and the ones it returns are kept."""
    _, subject = make_subjects()
    batch = tt.SubjectsBatch.from_subjects([subject, subject])
    seen, returned = [], []

    def spy(*tensors):
        seen.extend(tensors)
        out = tuple(t * 2 for t in tensors)
        returned.extend(out)
        return out

    t1 = batch.images["t1"].data
    result = tt.CornucopiaAdapter(spy)(batch)
    # scalars first, then labels, element by element: t1[0], seg[0], t1[1], seg[1]
    assert [t.data_ptr() for t in seen[::2]] == [t1[0].data_ptr(), t1[1].data_ptr()]
    assert all(type(t) is torch.Tensor for t in seen)
    assert torch.equal(result["t1"].data[1], returned[2])


# ── MONAI stand-in (tests/test_adapters.py) ──────────────────────────


class _MetaTensor(torch.Tensor):
    """Minimal MetaTensor: a torch.Tensor with an .affine attribute."""

    affine = None

    @staticmethod
    def __new__(cls, data, affine=None):
        obj = torch.as_tensor(data).as_subclass(cls)
        obj.affine = affine
        return obj


class _MapTransform:
    pass


@pytest.fixture
def monai_stub(monkeypatch):
    if "monai" in sys.modules and hasattr(sys.modules["monai"], "__version__"):
        pytest.skip("real MONAI installed; stub not needed")
    monai = types.ModuleType("monai")
    data_mod = types.ModuleType("monai.data")
    data_mod.MetaTensor = _MetaTensor
    transforms_mod = types.ModuleType("monai.transforms")
    transforms_mod.MapTransform = _MapTransform
    monai.data = data_mod
    monai.transforms = transforms_mod
    monkeypatch.setitem(sys.modules, "monai", monai)
    monkeypatch.setitem(sys.modules, "monai.data", data_mod)
    monkeypatch.setitem(sys.modules, "monai.transforms", transforms_mod)
    return monai


class DoubleAll(_MapTransform):
    def __call__(self, data):
        return {k: v * 2 for k, v in data.items() if isinstance(v, torch.Tensor)}


class TouchT1(_MapTransform):
    def __call__(self, data):
        return {"t1": data["t1"] + 1}


class ShiftAffine(_MapTransform):
    def __call__(self, data):
        out = {}
        for name, value in data.items():
            if not isinstance(value, torch.Tensor):
                continue
            new = _MetaTensor(torch.as_tensor(value))
            affine = value.affine.clone()
            affine[0, 3] += 10.0
            new.affine = affine
            out[name] = new
        return out


class FlipK(_MapTransform):
    def __call__(self, data):
        return {k: torch.flip(v, (-1,)) for k, v in data.items() if isinstance(v, torch.Tensor)}


MONAI_CASES = {
    "array": (lambda: (lambda t: t + 5), {}),
    "array-exclude": (lambda: (lambda t: t + 5), {"exclude": ["t1"]}),
    "array-identity": (lambda: (lambda t: t), {}),
    "dict-all": (DoubleAll, {}),
    "dict-untouched-keys": (TouchT1, {}),
    "dict-affine": (ShiftAffine, {}),
    "dict-flip": (FlipK, {}),
}


@pytest.mark.parametrize("case", list(MONAI_CASES))
def test_monai_equal_jax(monai_stub, case):
    make, kwargs = MONAI_CASES[case]
    want_in, got_in = make_subjects(site="hospital-A")
    want = tj.MonaiAdapter(make(), **kwargs)(want_in)
    got = tt.MonaiAdapter(make(), **kwargs)(got_in)
    assert_same(want, got)
    assert got.site == want.site == "hospital-A"


def test_monai_dict_transform_receives_metatensors_of_the_images_own_data(monai_stub):
    seen = {}

    class Spy(_MapTransform):
        def __call__(self, data):
            seen.update(data)
            return data

    _, subject = make_subjects(site="hospital-A")
    batch = tt.SubjectsBatch.from_subjects([subject])
    tt.MonaiAdapter(Spy())(batch)
    assert set(seen) == {"t1", "seg", "site"}
    assert type(seen["t1"]) is _MetaTensor
    assert seen["t1"].data_ptr() == batch.images["t1"].data.data_ptr()
    assert seen["t1"].affine.dtype == torch.float64
    np.testing.assert_array_equal(seen["seg"].affine.numpy(), subject.seg.affine.data)


def test_monai_results_are_plain_tensors(monai_stub):
    _, subject = make_subjects()
    out = tt.MonaiAdapter(ShiftAffine())(subject)
    assert type(out.t1.data) is torch.Tensor
    assert out.t1.affine.origin[0] == pytest.approx(subject.t1.affine.origin[0] + 10.0)


def test_monai_imageless_subject_and_errors(monai_stub):
    class Identity(_MapTransform):
        def __call__(self, data):
            return data

    result = tt.MonaiAdapter(Identity())(tt.Subject(label=3))
    assert result.label == 3 and not result.images
    with pytest.raises(TypeError, match="callable"):
        tt.MonaiAdapter(7)
    assert tt.MonaiAdapter(lambda t: t).invertible is False


def test_monai_missing_raises_the_same(monkeypatch):
    monkeypatch.setitem(sys.modules, "monai", None)
    errors = []
    for pkg, subject in zip((tj, tt), make_subjects()):
        with pytest.raises(ImportError) as info:
            pkg.MonaiAdapter(lambda t: t)(subject)
        errors.append(str(info.value))
    assert errors[1] == errors[0] == "MonaiAdapter requires MONAI: pip install monai"
