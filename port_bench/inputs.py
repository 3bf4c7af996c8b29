"""A configuration's inputs, made on the device from the seed: every
scalar image drawn uniform on [0, 1) from one ``torch.Generator`` (in the
configuration's order, one call an image for the whole batch), every
label map the same deterministic block pattern for each element. Both
the program and the reference are given these. The generator follows
``chip_smoke.py``'s ``make_batch``, ``make_brats_batch``, ``suite_labels``
and ``brats_labels`` at commit fe6a028."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "int32": torch.int32}


@dataclass
class ImageSpec:
    name: str
    kind: str
    channels: int
    shape: tuple[int, int, int]
    dtype: torch.dtype
    affine: np.ndarray
    spec: dict


def images(config: dict, shape=None) -> dict:
    """name -> ImageSpec of the configuration (``shape`` overrides every
    image's spatial shape, for the CPU tests)."""
    out = {}
    for name, spec in config["images"].items():
        spacing = np.asarray(spec.get("spacing", (1.0, 1.0, 1.0)), np.float64)
        out[name] = ImageSpec(
            name=name,
            kind=spec["kind"],
            channels=int(spec["channels"]),
            shape=tuple(int(s) for s in (shape or spec["shape"])),
            dtype=DTYPES[spec["dtype"]],
            affine=np.diag([*spacing, 1.0]),
            spec=spec,
        )
    return out


def generator_seed(seed: int) -> int:
    """``--seed`` as a ``torch.Generator`` seed (any whole number)."""
    return int(seed) % 2**63


def blocks(spec: dict, shape, device) -> torch.Tensor:
    """(1, I, J, K) labels ``values[(i // n + j // n + k // n) % len(values)]``."""
    n, values = int(spec["block"]), spec["values"]
    i, j, k = (torch.arange(s, device=device) // n for s in shape)
    index = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % len(values)
    return torch.as_tensor(values, dtype=torch.int32, device=device)[index][None]


def make(specs: dict, batch: int, seed: int, device) -> dict:
    """name -> (B, C, I, J, K) tensor on ``device``."""
    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    out = {}
    for name, image in specs.items():
        if image.kind == "scalar":
            out[name] = torch.rand((batch, image.channels, *image.shape), generator=gen,
                                   device=device, dtype=image.dtype)
        elif image.spec.get("labels") == "blocks":
            out[name] = blocks(image.spec, image.shape, device).expand(batch, *([-1] * 4)).contiguous()
        else:
            raise ValueError(f"no generator for image {name!r}: {image.spec}")
    return out
