"""Port parity: the notebook cards (``_repr_html_``) against the JAX package's.

On the CPU, with the same data in both packages:

- the HTML of an image card, loaded, lazy (a ``.nii.gz`` read from its
  header: the dtype and memory rows come from the header) and annotated
  (points, bounding boxes, a history), and of a subject card (Images,
  Points, Bounding Boxes, Metadata and History sections), equals the JAX
  package's once the embedded preview is cut out; the dtype row reads
  numpy's name ("float32"), the memory row ``_human_bytes`` of
  ``Image.memory``;
- the preview PNGs decode to equal pixels;
- a preview that fails to render is left out, as in the JAX package, but
  a fault of the device propagates.
"""

from __future__ import annotations

import base64
import io
import re

import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import repr_html as jax_repr
from torchio_tpu_torch import repr_html as port_repr
from torchio_tpu_torch import visualization as port_viz
from torchio_tpu_torch.core.dtypes import dtype_name

PNG = re.compile(r"data:image/png;base64,([A-Za-z0-9+/=]+)")


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def split(html: str) -> tuple[str, list[np.ndarray]]:
    """(the HTML without its previews, the previews' pixels)."""
    from PIL import Image as PILImage

    pixels = [
        np.asarray(PILImage.open(io.BytesIO(base64.b64decode(data))).convert("RGBA"))
        for data in PNG.findall(html)
    ]
    return PNG.sub("data:image/png;base64,", html), pixels


def assert_same_card(want_html: str, got_html: str, previews: int):
    want, want_pixels = split(want_html)
    got, got_pixels = split(got_html)
    assert got == want
    assert len(got_pixels) == len(want_pixels) == previews
    for a, b in zip(want_pixels, got_pixels, strict=True):
        np.testing.assert_array_equal(b, a)


def annotations(pkg):
    return {
        "points": {"lm": pkg.Points(np.asarray([[1.0, 2.0, 3.0], [0.5, 0.5, 0.5]], np.float32))},
        "bounding_boxes": {"roi": pkg.BoundingBoxes(np.asarray([[0, 0, 0, 2, 2, 2]], np.float32))},
    }


def data(shape=(2, 6, 7, 5), dtype=np.float32):
    return np.random.default_rng(0).normal(size=shape).astype(dtype)


def affine():
    out = np.diag([-1.5, 2.0, 1.0, 1.0])
    out[:3, :3] = out[:3, :3] @ np.array([[1, 0, 0], [0, 0.96, -0.28], [0, 0.28, 0.96]])
    out[:3, 3] = (4.0, -3.5, 2.25)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.float64])
def test_loaded_image_card_equal_jax(dtype):
    cards = [pkg.ScalarImage(data(dtype=dtype), affine=affine())._repr_html_() for pkg in (tj, tt)]
    assert_same_card(*cards, previews=1)
    assert f"<code>{np.dtype(dtype).name}</code>" in cards[1]


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_lazy_image_card_equal_jax(tmp_path, dtype):
    path = tmp_path / "t1.nii.gz"
    tj.write_nifti(path, data(dtype=dtype), affine())
    images = [tj.ScalarImage(path), tt.ScalarImage(path)]
    cards = [image._repr_html_() for image in images]
    assert "<code>lazy</code>" in cards[1]
    assert_same_card(*cards, previews=1)


def test_annotated_image_card_equal_jax():
    cards = []
    for pkg in (tj, tt):
        image = pkg.LabelMap(data(dtype=np.int32) % 3, affine=affine(), **annotations(pkg))
        cards.append((image._repr_html_(), pkg.Flip(axes=0, p=1.0)(image)._repr_html_()))
    (want, want_flipped), (got, got_flipped) = cards
    assert "bboxes &#x27;roi&#x27;" in got and "2 points" in got and "Flip" in got_flipped
    assert_same_card(want, got, previews=1)
    assert_same_card(want_flipped, got_flipped, previews=1)


def test_subject_card_equal_jax():
    cards = []
    for pkg in (tj, tt):
        subject = pkg.Subject(
            t1=pkg.ScalarImage(data(), affine=affine()),
            seg=pkg.LabelMap(data(dtype=np.int32) % 3, affine=affine()),
            landmarks=pkg.Points(np.zeros((1, 3), np.float32), axes="IJK"),
            lesions=pkg.BoundingBoxes(
                np.asarray([[0, 0, 0, 2, 2, 2]], np.float32), format=pkg.BoundingBoxFormat("IJK")
            ),
            age=7,
            site="A",
        )
        cards.append((subject._repr_html_(), pkg.Flip(axes=(0,))(subject)._repr_html_()))
    (want, want_flipped), (got, got_flipped) = cards
    for section in ("Images", "Points", "Bounding Boxes", "Metadata"):
        assert section in got
    assert "History" in got_flipped
    assert_same_card(want, got, previews=2)
    assert_same_card(want_flipped, got_flipped, previews=2)


def test_memory_row():
    card = tt.ScalarImage(torch.zeros((1, 64, 64, 64)))._repr_html_()
    assert "<td>memory</td><td><code>1.0 MiB</code></td>" in card
    volume = tt.ScalarImage(torch.zeros((1, 256, 256, 256)))
    assert port_repr._human_bytes(float(volume.memory)) == jax_repr._human_bytes(256**3 * 4)
    assert port_repr._human_bytes(float(volume.memory)) == "64.0 MiB"
    assert dtype_name(torch.float32) == "float32"
    assert dtype_name(torch.bool) == "bool"


def test_failed_preview_is_left_out(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no plot")

    monkeypatch.setattr(port_viz, "plot_image", boom)
    image = tt.ScalarImage(data())
    html = image._repr_html_()
    assert "data:image/png" not in html and "<td>memory</td>" in html
    monkeypatch.setattr(port_viz, "plot_image", lambda *a, **k: None)
    assert "data:image/png" not in image._repr_html_()


def test_device_fault_in_preview_propagates(monkeypatch):
    def fault(*args, **kwargs):
        raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_viz, "plot_image", fault)
    with pytest.raises(torch.AcceleratorError):
        tt.ScalarImage(data())._repr_html_()
