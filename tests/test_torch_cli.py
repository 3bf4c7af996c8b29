"""Port parity: ``torchio_tpu_torch.cli`` against ``torchio_tpu.cli``.

Each subcommand runs in-process through ``main([...])`` on the CPU (the
tests ask for it with ``set_default_device("cpu")``; a user's call runs
on the card) beside the JAX package's ``main`` on the same files:

- ``info`` (with ``--load``, ``--label``, an oblique int16 and a float32
  image) prints the same lines;
- ``convert`` (to ``.nii``, ``.nrrd`` and ``.mha``) writes files that read
  back equal to the JAX package's, with the dtype kept;
- ``transform Affine degrees=10 --seed 0`` writes an output within 1e-5
  of the JAX package's; seeded runs repeat; ``Flip``, a non-literal
  string argument and ``--label`` as in the JAX package;
- an unknown transform exits with code 2 and the same list;
- ``plot`` writes a PNG of equal pixels; ``animate`` a GIF of equal
  frames, and an ``.mp4`` through ``make_video``;
- ``cache dir`` and ``cache clean`` print the same;
- ``--version`` and the parser's ``prog`` name the port; ``python -m
  torchio_tpu_torch.cli`` runs.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import torchio_tpu as tj
import torchio_tpu_torch as tt
from torchio_tpu import cli as jax_cli
from torchio_tpu.utils import download as jax_download
from torchio_tpu_torch import cli as port_cli
from torchio_tpu_torch import visualization as port_viz
from torchio_tpu_torch.utils import download as port_download

TRANSFORM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def oblique():
    out = np.eye(4)
    c, s = np.cos(0.2), np.sin(0.2)
    out[:3, :3] = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ np.diag([0.9375, -0.9375, 1.2])
    out[:3, 3] = (-90.25, 110.5, 70.0)
    return out


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(0)
    t1 = tmp_path / "t1.nii.gz"
    tj.write_nifti(t1, (rng.normal(size=(1, 12, 14, 10)) * 300 + 800).astype(np.int16), oblique())
    f32 = tmp_path / "f32.nii"
    tj.write_nifti(f32, rng.normal(size=(1, 10, 12, 8)).astype(np.float32), np.diag([2.0, 2.0, 2.0, 1.0]))
    seg = tmp_path / "seg.nii.gz"
    tj.write_nifti(seg, rng.integers(0, 4, (1, 12, 14, 10)).astype(np.uint8), oblique())
    return {"t1": t1, "f32": f32, "seg": seg}


def run_both(capsys, args):
    """(JAX (code, stdout), port (code, stdout)) of ``main(args)``."""
    out = []
    for main in (jax_cli.main, port_cli.main):
        code = main([str(a) for a in args])
        out.append((code, capsys.readouterr().out))
    return out


@pytest.mark.parametrize(
    "args",
    [("t1",), ("t1", "--load"), ("f32", "--load"), ("seg", "--label", "--load")],
    ids=lambda a: "-".join(a),
)
def test_info_equal_jax(files, capsys, args):
    name, *flags = args
    want, got = run_both(capsys, ["info", files[name], *flags])
    assert got == want and got[0] == 0
    assert "orientation: " in got[1] and ("min/mean/max" in got[1]) == ("--load" in flags)


@pytest.mark.parametrize("suffix", [".nii", ".nrrd", ".mha"])
def test_convert_equal_jax(files, tmp_path, capsys, suffix):
    outputs = [tmp_path / f"jax{suffix}", tmp_path / f"port{suffix}"]
    for main, out in zip((jax_cli.main, port_cli.main), outputs):
        assert main(["convert", str(files["t1"]), str(out)]) == 0
        assert capsys.readouterr().out == f"saved {out}\n"
    want, got = tj.ScalarImage(outputs[0]), tt.ScalarImage(outputs[1])
    assert got.data.numpy().dtype == np.asarray(want.data).dtype == np.int16
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_allclose(got.affine.data, want.affine.data, atol=1e-9)


TRANSFORM_CASES = {
    "affine-seed": ("t1", "Affine", ["degrees=10"], ["--seed", "0"]),
    "affine-float": ("f32", "Affine", ["degrees=10", "scales=(0.9, 1.1)"], ["--seed", "3"]),
    "flip": ("f32", "Flip", ["axes=0"], []),
    "noise-seed": ("f32", "Noise", ["std=0.5"], ["--seed", "5"]),
    "pad-string": ("f32", "Pad", ["padding=1", "padding_mode=mean"], []),
    "label-affine": ("seg", "Affine", ["degrees=10"], ["--label", "--seed", "1"]),
}


@pytest.mark.parametrize("case", list(TRANSFORM_CASES))
def test_transform_equal_jax(files, tmp_path, capsys, case):
    name, transform, kwargs, flags = TRANSFORM_CASES[case]
    outputs = [tmp_path / "jax.nii.gz", tmp_path / "port.nii.gz"]
    for main, out in zip((jax_cli.main, port_cli.main), outputs):
        assert main(["transform", transform, str(files[name]), str(out), *kwargs, *flags]) == 0
        assert capsys.readouterr().out == f"saved {out}\n"
    want, _ = tj.read_nifti(outputs[0])
    got, _ = tt.io.read_nifti(outputs[1])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want.astype(np.float64)).max() <= TRANSFORM_ATOL
    if "--seed" in flags:  # a seeded run repeats
        again = tmp_path / "again.nii.gz"
        assert port_cli.main(["transform", transform, str(files[name]), str(again), *kwargs, *flags]) == 0
        np.testing.assert_array_equal(tt.io.read_nifti(again)[0], got)


def test_unknown_transform_equal_jax(files, capsys):
    """The same exit code and message; the lists hold every registered
    class, so a test process's own Transform subclasses join them: they
    are compared on the packages' public transforms."""
    want, got = run_both(capsys, ["transform", "Nope", files["t1"], "x.nii"])
    assert got[0] == want[0] == 2
    prefix = "Unknown transform 'Nope'. Known: "
    assert got[1].startswith(prefix) and want[1].startswith(prefix)
    public = set(tj.transforms.__all__) | set(tt.transforms.__all__)
    names = [set(out.removeprefix(prefix).strip().split(", ")) & public for _, out in (want, got)]
    assert names[1] == names[0]
    assert {"Affine", "MonaiAdapter", "CornucopiaAdapter", "Transpose"} <= names[1]
    assert "_PerElementComposer" not in got[1]


def test_plot_equal_jax(files, tmp_path, capsys):
    from PIL import Image as PILImage

    outputs = [tmp_path / "jax.png", tmp_path / "port.png"]
    for main, out in zip((jax_cli.main, port_cli.main), outputs):
        assert main(["plot", str(files["t1"]), "-o", str(out)]) == 0
        assert capsys.readouterr().out == f"saved {out}\n"
    want, got = (np.asarray(PILImage.open(p)) for p in outputs)
    np.testing.assert_array_equal(got, want)


def test_animate_equal_jax(files, tmp_path, capsys, monkeypatch):
    from PIL import Image as PILImage

    outputs = [tmp_path / "jax.gif", tmp_path / "port.gif"]
    for main, out in zip((jax_cli.main, port_cli.main), outputs):
        assert main(["animate", str(files["t1"]), str(out), "--axis", "1"]) == 0
    frames = []
    for path in outputs:
        with PILImage.open(path) as gif:
            frames.append([np.asarray(gif.seek(i) or gif.convert("L")) for i in range(gif.n_frames)])
    assert len(frames[1]) == len(frames[0]) > 1
    for a, b in zip(*frames, strict=True):
        np.testing.assert_array_equal(b, a)
    called = {}
    monkeypatch.setattr(port_viz, "make_video", lambda img, out, axis: called.setdefault("out", (out, axis)))
    assert port_cli.main(["animate", str(files["t1"]), str(tmp_path / "o.mp4")]) == 0
    assert called["out"] == (tmp_path / "o.mp4", 2)


def test_cache_equal_jax(tmp_path, capsys, monkeypatch):
    want, got = run_both(capsys, ["cache", "dir"])
    assert got == want and got[1].strip()
    for module, name in ((jax_download, "jax"), (port_download, "port")):
        cache = tmp_path / name
        cache.mkdir()
        (cache / "junk.bin").write_bytes(b"x")
        monkeypatch.setattr(module, "get_cache_dir", lambda cache=cache: cache)
    for main, name in ((jax_cli.main, "jax"), (port_cli.main, "port")):
        assert main(["cache", "clean"]) == 0
        assert capsys.readouterr().out == f"removed {tmp_path / name}\n"
        assert main(["cache", "clean"]) == 0
        assert capsys.readouterr().out == f"nothing to remove at {tmp_path / name}\n"


def test_version_and_prog(capsys):
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--version", "info", "missing.nii"])
    assert exc.value.code == 0
    assert capsys.readouterr().out == f"torchio-tpu-torch {tt.__version__}\n"
    assert port_cli.build_parser().prog == "torchio-tpu-torch"
    with pytest.raises((FileNotFoundError, ValueError, RuntimeError)):
        port_cli.main(["convert", "no.nii", "o.nrrd"])


def test_module_entry_point():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "torchio_tpu_torch.cli", "cache", "dir"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(port_download.get_cache_dir())
    assert "jax" not in proc.stderr.lower()
