"""Pipeline warm-up: build the kernels and run a transform once before the
first real batch.

Counterpart of ``torchio_tpu/warmup.py``. A first call on the card pays
for ``nvcc`` (every kernel library is compiled at its first use) and for
PyTorch's own first-use costs (the CUDA context, the caching allocator's
first blocks, the library handles). :func:`warmup` compiles every kernel
library at once, then runs the transform on a dummy batch of the shapes
you are about to use, on the package's default device, so real data
meets built kernels and a warm allocator. The host RNG state is saved and
restored: the device draws' keys come from it, so warming up does NOT
change what a seeded pipeline draws afterwards.
"""

from __future__ import annotations

import copy
from typing import Any, Sequence

import torch

from . import config
from . import random as tio_random
from .data.batch import SubjectsBatch
from .data.image import LabelMap, ScalarImage
from .data.subject import Subject
from .ops import kernel_lib
from .profiling import synchronize


def _force_apply(transform: Any) -> None:
    """Set p=1 recursively so gated transforms actually run.

    ``OneOf``/``SomeOf`` still pick random branches: call ``warmup``
    with ``repeats`` to cover the branches of a stochastic composition.
    """
    if hasattr(transform, "p"):
        transform.p = 1.0
    for child in getattr(transform, "transforms", ()) or ():
        _force_apply(child)


def warmup(
    transform: Any,
    spatial_shape: Sequence[int],
    *,
    channels: int = 1,
    batch_size: int = 1,
    label_keys: Sequence[str] = (),
    image_key: str = "t1",
    repeats: int = 1,
) -> None:
    """Build the kernels and run ``transform`` on the given shapes.

    Args:
        transform: Any transform or Compose (a deep copy runs, at p=1).
        spatial_shape: (I, J, K) of the batches you will process.
        channels: Channels of the scalar image.
        batch_size: Batch size to warm.
        label_keys: Names of LabelMap entries to include.
        image_key: Name of the scalar image entry.
        repeats: run the pipeline this many times with fresh random
            params (OneOf branches, Ghosting/Spike axes and Motion segment
            counts each take their own path).
    """
    device = config.default_device()
    if device.type != "cpu":
        # every nvcc at once, before the first launch needs one; a failed
        # build raises here
        kernel_lib.build_all()
    state = tio_random.get_rng().bit_generator.state
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        shape = (channels, *spatial_shape)
        subjects = []
        for _ in range(batch_size):
            images: dict[str, Any] = {
                image_key: ScalarImage(torch.rand(shape, generator=gen, device=device))
            }
            for key in label_keys:
                labels = torch.randint(
                    0, 2, (1, *spatial_shape), generator=gen, device=device, dtype=torch.uint8
                )
                images[key] = LabelMap(labels)
            subjects.append(Subject(**images))
        batch = SubjectsBatch.from_subjects(subjects)
        runner = copy.deepcopy(transform)
        _force_apply(runner)
        for _ in range(max(1, repeats)):
            synchronize(runner(batch))
    finally:
        tio_random.get_rng().bit_generator.state = state
