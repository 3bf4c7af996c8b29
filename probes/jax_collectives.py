"""Which stages the JAX package keeps on each device's region when a batch
is sharded: the collectives in the programs it compiles for a stage, and
the arrays it pulls to the host.

Runs the JAX package (the reference, never the port) on 8 virtual CPU
devices, ``make_mesh()`` = (data 4, space 2), B=4 subjects of
(1, 16, 32, 16) sharded over B and J (``shard_(mesh, spatial=True)``),
or over B only (``--batch-only``: ``shard_(mesh)``). For each stage, in
a process of its own, XLA dumps every program it compiles after
optimisation; the stage's programs are those dumped during its call,
and their collective ops (all-gather, all-reduce, collective-permute,
all-to-all, reduce-scatter) are counted, each with the shape it moves.
A host pull of a sharded array (``np.asarray``) is counted too: it
gathers the array to the host, which is no device's region either. A
stage is local where both counts are zero.

    JAX_PLATFORMS=cpu python probes/jax_collectives.py               # every stage
    JAX_PLATFORMS=cpu python probes/jax_collectives.py Motion        # one stage
    JAX_PLATFORMS=cpu python probes/jax_collectives.py --batch-only  # B split only
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

COLLECTIVES = ("all-gather", "all-reduce", "collective-permute", "all-to-all",
               "reduce-scatter")
#: the stages that gather in the port, then the pointwise stages it keeps
#: on each rank's region
STAGES = ("Motion", "Ghosting", "Spike", "Swap", "LabelsToImage", "HistogramStandardization",
          "OneHot", "OneHot3", "Contour", "KeepLargestComponent", "RemapLabels", "RemoveLabels",
          "SequentialLabels", "Resize", "Anisotropy", "Crop", "Pad", "PadReflect", "CropOrPad",
          "Transpose", "Reorient", "PCA",
          "Noise", "BiasField", "Gamma", "Clamp", "Flip", "ZNormalization", "Mask",
          "RescaleIntensity")


def stage(tj, name, np):
    """The stage ``name`` with arguments that make it do work."""
    if name == "Motion":
        return tj.Motion(degrees=5.0, translation=3.0, num_transforms=2)
    if name == "Ghosting":
        return tj.Ghosting(intensity=(0.3, 0.7))
    if name == "Spike":
        return tj.Spike(num_spikes=2, intensity=(0.5, 1.0))
    if name == "Swap":
        return tj.Swap(patch_size=4, num_iterations=4)
    if name == "LabelsToImage":
        return tj.LabelsToImage(label_key="seg")
    if name == "HistogramStandardization":
        return tj.HistogramStandardization(np.linspace(0.0, 100.0, 13), include=["t1"])
    if name == "RemapLabels":
        return tj.RemapLabels({1: 2, 2: 1})
    if name == "RemoveLabels":
        return tj.RemoveLabels([2])
    if name == "Resize":
        return tj.Resize((16, 24, 16))
    if name == "Anisotropy":
        return tj.Anisotropy(downsampling=(2.0, 3.0))
    if name == "OneHot3":
        return tj.OneHot(num_classes=3)
    if name == "Crop":
        return tj.Crop(cropping=(2, 3, 1))
    if name == "Pad":
        return tj.Pad(padding=(2, 3, 1))
    if name == "PadReflect":
        return tj.Pad(padding=(2, 3, 1), padding_mode="reflect")
    if name == "CropOrPad":
        return tj.CropOrPad((12, 40, 16))
    if name == "Reorient":
        return tj.Reorient("PLI")
    if name == "PCA":
        return tj.PCA(num_components=1)
    if name == "Noise":
        return tj.Noise(std=0.1)
    if name == "Gamma":
        return tj.Gamma(log_gamma=(-0.3, 0.3))
    if name == "Clamp":
        return tj.Clamp(out_min=10.0, out_max=90.0)
    if name == "Flip":
        return tj.Flip(axes=(1,))
    if name == "Mask":
        return tj.Mask(masking_method="seg")
    if name == "RescaleIntensity":
        return tj.RescaleIntensity(out_min=0.0, out_max=1.0)
    return getattr(tj, name)()


def collectives(text: str) -> dict:
    """Each collective op of an HLO module's text with the shapes it moves
    (``%x = <shape> op(...)``: the shape may be a tuple with spaces; its
    layouts dropped)."""
    found = {}
    for op in COLLECTIVES:
        shapes = re.findall(rf"= (\S.*?) {op}(?:-start)?\(", text)
        if shapes:
            found[op] = [re.sub(r"\{[^}]*\}", "", shape) for shape in shapes]
    return found


def run_one(name: str, spatial: bool = True) -> dict:
    """The probe of one stage, in this process (XLA_FLAGS set by the caller)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax
    import numpy as np

    import torchio_tpu as tj
    from jax._src.array import ArrayImpl
    from torchio_tpu.data.batch import SubjectsBatch
    from torchio_tpu.parallel.mesh import make_mesh

    dump = Path(os.environ["PROBE_DUMP"])
    rng = np.random.default_rng(0)
    subjects = [
        tj.Subject(
            t1=tj.ScalarImage(rng.random((1, 16, 32, 16), np.float32) * 100.0),
            seg=tj.LabelMap(rng.integers(0, 3, (1, 16, 32, 16)).astype(np.int32)),
        )
        for _ in range(4)
    ]
    batch = SubjectsBatch.from_subjects(subjects).shard_(make_mesh(), spatial=spatial)
    transform = stage(tj, name, np)
    pulls = []
    real = ArrayImpl.__array__

    def spy(self, *args, **kwargs):
        if len(self.sharding.device_set) > 1:
            pulls.append(list(self.shape))
        return real(self, *args, **kwargs)

    tj.seed(0)
    before = set(dump.glob("*after_optimizations.txt"))
    ArrayImpl.__array__ = spy
    try:
        out = transform(batch)
        for ib in out.images.values():
            jax.block_until_ready(ib.data)
    finally:
        ArrayImpl.__array__ = real
    shapes: dict = {}
    programs = sorted(set(dump.glob("*after_optimizations.txt")) - before)
    for path in programs:
        for op, found in collectives(path.read_text()).items():
            shapes.setdefault(op, []).extend(found)
    return {"stage": name, "programs": len(programs),
            "collectives": {op: len(found) for op, found in shapes.items()},
            "shapes": shapes, "host_pulls": pulls}


def main(argv: list[str]) -> int:
    if argv and argv[0] == "--one":
        print(json.dumps(run_one(argv[1], spatial=argv[2:] != ["--batch-only"])))
        return 0
    layout = [a for a in argv if a == "--batch-only"]
    argv = [a for a in argv if a != "--batch-only"]
    print(f"layout: mesh (data 4, space 2), B=4 x (1, 16, 32, 16) sharded over"
          f" {'B only' if layout else 'B and J'}", flush=True)
    results = []
    for name in argv or STAGES:
        with tempfile.TemporaryDirectory(prefix="jax_collectives_") as dump:
            env = dict(os.environ, JAX_PLATFORMS="cpu", PROBE_DUMP=dump, XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8 --xla_dump_hlo_as_text"
                f" --xla_dump_to={dump} --xla_dump_hlo_pass_re=^$"
            ))
            proc = subprocess.run([sys.executable, __file__, "--one", name, *layout], env=env,
                                  capture_output=True, text=True,
                                  cwd=Path(__file__).resolve().parents[1])
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            if proc.returncode or not lines:
                tail = proc.stderr.strip().splitlines()[-1:] or [f"rc {proc.returncode}"]
                results.append({"stage": name, "error": tail[0]})
            else:
                results.append(json.loads(lines[-1]))
        result = results[-1]
        local = not result.get("error") and not result["collectives"] and not result["host_pulls"]
        print(f"{name}: {'local' if local else 'not local'} {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
