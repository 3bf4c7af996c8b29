"""Port parity: ``torchio_tpu_torch.visualization`` against the JAX package's.

The same numpy volumes (with affines in LPS, PLI and oblique
orientations, so the RAS+ reorientation permutes and flips) are drawn by
both packages on the CPU with matplotlib's Agg canvas:

- the RGBA buffers of ``plot_image`` (scalar and label images, indices,
  coordinates, crosshair, intersections, voxel and no ticks,
  neurological, a channel, no percentile window, a colormap, a color
  table, an image's own ``color_map``, int16 data) and ``plot_subject``
  (indices, coordinates, crosshair, a label map, ``cmap_dict`` with a
  color table, more than three images) are equal;
- the frames of ``make_gif`` (each axis, each direction, reversed,
  ``seconds``, int16 data) are equal, and the ffmpeg command that
  ``make_video`` assembles (ffmpeg is stubbed) and the frames it writes
  are equal;
- the same ValueError for "indices OR coordinates", the same errors for
  a subject with no images and a bad direction, the ImportError of
  ``plot_interactive`` (ipyniivue is not installed);
- FPG's ``plot`` passes its GIF colour table;
- a figure copies only its three planes and a few scalars to the host,
  and a GIF its frames as uint8, once (``HOST_COPIES``).
"""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cpu_warmup  # noqa: E402,F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj  # noqa: E402
import torchio_tpu_torch as tt  # noqa: E402
from torchio_tpu import visualization as jax_viz  # noqa: E402
from torchio_tpu_torch import visualization as port_viz  # noqa: E402

PACKAGES = ((tj, jax_viz), (tt, port_viz))


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)
    plt.close("all")


def affine_of(codes: str, spacing=(1.0, 1.5, 2.0), angle=0.0):
    world = {"R": (0, 1), "L": (0, -1), "A": (1, 1), "P": (1, -1), "S": (2, 1), "I": (2, -1)}
    matrix = np.eye(4)
    matrix[:3, :3] = 0.0
    for voxel, code in enumerate(codes):
        axis, sign = world[code]
        matrix[axis, voxel] = sign * spacing[voxel]
    rotation = np.eye(4)
    c, s = math.cos(angle), math.sin(angle)
    rotation[:2, :2] = [[c, -s], [s, c]]
    out = rotation @ matrix
    out[:3, 3] = (-12.0, 8.5, 3.25)
    return out


SHAPE = (12, 14, 10)


def volume(shape=SHAPE, channels=1, dtype=np.float32, seed=0, labels=0):
    rng = np.random.default_rng(seed)
    if labels:
        return rng.integers(0, labels, (channels, *shape)).astype(dtype)
    data = rng.normal(size=(channels, *shape)) * 30 + 50
    data[0, 0, 0, 0] = 1e4  # an outlier outside the percentile window
    return data.astype(dtype)


def images(kind="ScalarImage", codes="RAS", angle=0.0, **kwargs):
    meta = kwargs.pop("meta", {})
    data = volume(**kwargs)
    affine = affine_of(codes, angle=angle)
    return [getattr(pkg, kind)(data, affine=affine, **meta) for pkg in (tj, tt)]


def rgba(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def assert_same_figure(jax_fig, port_fig):
    want, got = rgba(jax_fig), rgba(port_fig)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for a, b in zip(jax_fig.axes, port_fig.axes, strict=True):
        assert a.get_xlabel() == b.get_xlabel() and a.get_title() == b.get_title()
        for ia, ib in zip(a.get_images(), b.get_images(), strict=True):
            np.testing.assert_array_equal(np.asarray(ib.get_array()), np.asarray(ia.get_array()))
            assert ib.get_clim() == ia.get_clim()


PLOT_IMAGE_CASES = {
    "default-RAS": ({}, {}),
    "LPS": ({"codes": "LPS"}, {}),
    "PLI-indices": ({"codes": "PLI"}, {"indices": (3, 9, 2)}),
    "oblique-coordinates": ({"codes": "ASL", "angle": 0.3}, {"coordinates": (0.0, None, 7.0)}),
    "crosshair-voxels": ({"codes": "IPR"}, {"crosshair": True, "units": "voxel", "indices": (1, 2, 3)}),
    "intersections-neurological": ({"codes": "LPS"}, {"intersections": True, "radiological": False}),
    "no-units-no-window": ({"codes": "RSP"}, {"units": None, "percentiles": None}),
    "channel-cmap": ({"codes": "PLI", "channels": 3}, {"channel": 2, "cmap": "viridis"}),
    "int16": ({"codes": "LPI", "dtype": np.int16}, {"title": "int16"}),
    "label": ({"kind": "LabelMap", "codes": "PLI", "labels": 5, "dtype": np.int32}, {}),
    "label-color-table": (
        {"kind": "LabelMap", "codes": "LPS", "labels": 3, "dtype": np.int32},
        {"cmap": {1: (10, 20, 30), 2: (200, 100, 0)}},
    ),
    "label-own-color-map": (
        {"kind": "LabelMap", "labels": 2, "dtype": np.uint8, "meta": {"color_map": {1: (255, 0, 0)}}},
        {},
    ),
}


@pytest.mark.parametrize("case", list(PLOT_IMAGE_CASES))
def test_plot_image_pixels_equal_jax(case):
    image_kwargs, plot_kwargs = PLOT_IMAGE_CASES[case]
    figs = [
        viz.plot_image(image, show=False, **plot_kwargs)
        for image, (_, viz) in zip(images(**image_kwargs), PACKAGES)
    ]
    assert_same_figure(*figs)


def subjects(n=2, codes=("RAS", "LPS", "PLI", "IPR", "RSP")):
    out = []
    for pkg in (tj, tt):
        entries = {}
        for i in range(n):
            data = volume(shape=(10 + i, 12, 9), seed=i)
            entries[f"im{i}"] = pkg.ScalarImage(data, affine=affine_of(codes[i % len(codes)]))
        seg = volume(shape=(10, 12, 9), labels=3, dtype=np.int32, seed=9)
        entries["seg"] = pkg.LabelMap(seg, affine=affine_of("LPS"))
        out.append(pkg.Subject(**entries))
    return out


PLOT_SUBJECT_CASES = {
    "default": (2, {}),
    "indices-crosshair": (2, {"indices": (4, 5, 6), "crosshair": True}),
    "coordinates-intersections": (1, {"coordinates": (-5.0, 10.0, None), "intersections": True}),
    "cmap-dict-title": (2, {"cmap_dict": {"seg": {1: (1, 2, 3), 2: (90, 80, 70)}, "im0": "magma"},
                            "title": "case 001", "figsize": (8, 6)}),
    "many-images": (4, {"units": "voxel"}),
}


@pytest.mark.parametrize("case", list(PLOT_SUBJECT_CASES))
def test_plot_subject_pixels_equal_jax(case):
    n, kwargs = PLOT_SUBJECT_CASES[case]
    figs = [viz.plot_subject(s, show=False, **kwargs) for s, (_, viz) in zip(subjects(n), PACKAGES)]
    assert_same_figure(*figs)


def test_hooks_draw_the_same(tmp_path):
    jax_image, port_image = images(codes="LPS")
    assert_same_figure(jax_image.plot(show=False), port_image.plot(show=False))
    jax_subject, port_subject = subjects(1)
    assert_same_figure(jax_subject.plot(show=False), port_subject.plot(show=False))
    port_image.plot(output_path=tmp_path / "x.png", show=False)
    assert (tmp_path / "x.png").stat().st_size > 0


def gif_frames(path) -> list[np.ndarray]:
    from PIL import Image as PILImage

    frames = []
    with PILImage.open(path) as gif:
        for index in range(gif.n_frames):
            gif.seek(index)
            frames.append((np.asarray(gif.convert("L")), gif.info.get("duration")))
    return frames


GIF_CASES = {
    "axis-2": ("LPS", {}),
    "axis-0": ("PLI", {"axis": 0}),
    "axis-1-reverse": ("ASL", {"axis": 1, "reverse": True}),
    "direction-S-seconds": ("LPS", {"direction": "S", "seconds": 1.0}),
    "direction-I-reverse": ("RAS", {"direction": "I", "reverse": True}),
    "direction-A": ("PLI", {"direction": "a"}),
    "int16": ("IPR", {"dtype": np.int16}),
}


@pytest.mark.parametrize("case", list(GIF_CASES))
def test_gif_frames_equal_jax(tmp_path, case):
    codes, kwargs = GIF_CASES[case]
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", np.float32)
    got = []
    for image, (pkg, viz) in zip(images(codes=codes, dtype=dtype), PACKAGES):
        path = viz.make_gif(image, tmp_path / f"{pkg.__name__}.gif", **kwargs)
        got.append(gif_frames(path))
    assert len(got[1]) == len(got[0]) > 1
    for (a, da), (b, db) in zip(*got, strict=True):
        np.testing.assert_array_equal(b, a)
        assert db == da


def test_sweep_frames_equal_jax():
    for codes in ("RAS", "LPS", "PLI", "ASL"):
        for dtype in (np.float32, np.int16, np.uint8):
            jax_image, port_image = images(codes=codes, dtype=dtype, channels=2)
            for axis in range(3):
                want = jax_viz._sweep_frames(jax_image, axis, None, False)
                got = port_viz._sweep_frames(port_image, axis, None, False)
                assert len(got) == len(want)
                for a, b in zip(want, got, strict=True):
                    assert b.dtype == np.uint8
                    np.testing.assert_array_equal(b, a)


def test_make_video_command_and_frames_equal_jax(tmp_path, monkeypatch):
    from PIL import Image as PILImage

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/ffmpeg")
    runs = []

    def fake_run(cmd, check, capture_output):
        directory = cmd[cmd.index("-i") + 1].rsplit("/", 1)[0]
        frames = sorted(Path(directory).glob("*.png"))
        runs.append((cmd, [np.asarray(PILImage.open(p)) for p in frames], directory))

        class Result:
            returncode = 0

        return Result()

    monkeypatch.setattr(subprocess, "run", fake_run)
    for image, (pkg, viz) in zip(images(codes="PLI"), PACKAGES):
        out = viz.make_video(image, tmp_path / "clip.mp4", direction="A", seconds=2.0, reverse=True)
        assert out == tmp_path / "clip.mp4"
    (want, want_frames, want_dir), (got, got_frames, got_dir) = runs
    assert got == [part.replace(want_dir, got_dir) for part in want]
    # the 12 slices of the anterior axis (P in PLI) over 2 s: fps round(12 / 2)
    assert got[0] == "ffmpeg" and got[got.index("-framerate") + 1] == "6"
    assert len(got_frames) == len(want_frames) == 12
    for a, b in zip(want_frames, got_frames, strict=True):
        np.testing.assert_array_equal(b, a)


def test_make_video_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    _, port_image = images()
    with pytest.raises(RuntimeError, match="ffmpeg"):
        port_viz.make_video(port_image, tmp_path / "v.mp4")


def raised(fn):
    try:
        fn()
    except Exception as error:  # the error of each package, compared below
        return type(error), str(error)
    return None


def test_errors_equal_jax(tmp_path):
    (jax_image, port_image), (jax_subject, port_subject) = images(), subjects(1)
    cases = [
        (lambda viz, image, subject: viz.plot_image(
            image, indices=(1, 1, 1), coordinates=(0, 0, 0), show=False)),
        (lambda viz, image, subject: viz.plot_subject(
            subject, indices=(1, 1, 1), coordinates=(0.0, 0.0, 0.0), show=False)),
        (lambda viz, image, subject: viz.make_gif(image, tmp_path / "x.gif", direction="Q")),
    ]
    for case in cases:
        want = raised(lambda: case(jax_viz, jax_image, jax_subject))
        got = raised(lambda: case(port_viz, port_image, port_subject))
        assert want is not None and got == want
    assert raised(lambda: port_viz.plot_subject(tt.Subject(age=1), show=False)) == raised(
        lambda: jax_viz.plot_subject(tj.Subject(age=1), show=False)
    )


def test_plot_interactive_import_error():
    jax_image, port_image = images()
    want = raised(lambda: jax_image.plot_interactive())
    got = raised(lambda: port_image.plot_interactive())
    assert got == want and got[0] is ImportError and "ipyniivue" in got[1]


def test_without_matplotlib(monkeypatch):
    """A machine without matplotlib (the card's has none): plotting raises
    the gate's ImportError, a notebook card leaves its preview out, and
    the figure's device side runs."""
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    _, port_image = images(codes="PLI")
    with pytest.raises(ImportError, match="'matplotlib' \\(needed for plotting\\)"):
        port_image.plot(show=False)
    html = port_image._repr_html_()
    assert "data:image/png" not in html and "<td>memory</td>" in html
    view = port_viz._RasView(port_image)
    assert [p.shape for p in view.planes((1, 2, 3), 0)] == [(12, 10), (14, 10), (14, 12)]


def test_colorize_labels_equal_jax():
    plane = np.array([[0.0, 1.0, 2.4], [1e9, -3.0, 2.6]], np.float32)
    table = {1: (10, 20, 30), 3: (1, 2, 3)}
    np.testing.assert_array_equal(
        port_viz._colorize_labels(plane, table), jax_viz._colorize_labels(plane, table)
    )


def test_fpg_plot_passes_its_color_table(monkeypatch):
    from torchio_tpu.datasets.fpg import FPG as JaxFPG
    from torchio_tpu_torch.datasets.fpg import FPG as PortFPG

    assert PortFPG.GIF_COLORS == JaxFPG.GIF_COLORS
    calls = []
    monkeypatch.setattr(port_viz, "plot_subject", lambda subject, **kw: calls.append(kw))
    fpg = PortFPG.__new__(PortFPG)
    tt.Subject.__init__(fpg, seg=tt.LabelMap(np.zeros((1, 4, 4, 4), np.int32)))
    fpg.plot(show=False)
    fpg.plot(show=False, cmap_dict={"seg": "gray"})
    assert calls == [
        {"show": False, "cmap_dict": {"seg": PortFPG.GIF_COLORS}},
        {"show": False, "cmap_dict": {"seg": "gray"}},
    ]


def test_a_figure_copies_its_planes_only():
    _, port_image = images(codes="PLI", channels=2, shape=(20, 22, 24))
    port_viz.HOST_COPIES.update(copies=0, bytes=0)
    port_viz.plot_image(port_image, show=False)
    # three planes of the RAS view (22 x 24 is P x I: 24 x 20, 24 x 22, 20 x 22 in RAS)
    planes = (22 * 20 + 24 * 20 + 24 * 22) * 4
    window = 5 * 4  # two percentiles' neighbours and the largest value
    assert port_viz.HOST_COPIES == {"copies": 2, "bytes": planes + window}
    _, port_labels = images(kind="LabelMap", codes="PLI", shape=(20, 22, 24), labels=4, dtype=np.int32)
    port_viz.HOST_COPIES.update(copies=0, bytes=0)
    port_viz.plot_image(port_labels, show=False)
    assert port_viz.HOST_COPIES == {"copies": 2, "bytes": planes + 4}


def test_a_gif_copies_its_frames_once(tmp_path):
    _, port_image = images(codes="LPS", channels=2, shape=(20, 22, 24))
    port_viz.HOST_COPIES.update(copies=0, bytes=0)
    port_viz.make_gif(port_image, tmp_path / "x.gif")
    # the range (two float32 scalars) and one channel as uint8
    assert port_viz.HOST_COPIES == {"copies": 2, "bytes": 2 * 4 + 20 * 22 * 24}
