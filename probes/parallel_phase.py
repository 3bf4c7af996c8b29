#!/usr/bin/env python3
"""Probe: ``chip_smoke.py``'s device, build, threefry and ``parallel``
phases alone, on one card.

The quick check of the sharded path and the threefry kernel (the
strided segments, the contiguous draw against ``probes/threefry_parent.cu``
in the same process) without the rest of the smoke test::

    chiprun --timeout 600 -- python3 probes/parallel_phase.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this probe needs a CUDA GPU")

    import torchio_tpu_torch as tio
    from torchio_tpu_torch import config, native
    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.ops import kernel_lib as kl
    from torchio_tpu_torch.ops import threefry_kernel as tk

    t0 = time.perf_counter()
    smi = cs.phase_device(torch, config)
    cs.phase_build(kl, native)
    cs.phase_threefry_kernel(torch, tr, tk, kl)
    cs.phase_parallel(torch, np, tio, tr, tk, kl, smi)
    print(f"probe: {time.perf_counter() - t0:.1f} s; card: {smi}")


if __name__ == "__main__":
    main()
