"""A configuration's inputs, made on the device from the seed: every
scalar image drawn uniform on [0, 1) from one ``torch.Generator`` (in the
configuration's order, one call an image for the whole batch), every
label map the same deterministic pattern for each element: ``blocks`` of
a fixed size, or a ``grid`` of parts that scales with the shape. Every
declared label has to appear in the map it makes. Both the program and
the reference are given these. An image with
``made_by`` (the transform that writes it, such as ``LabelsToImage``) is
no input: it is listed as the pipeline leaves it, after every input, and
nothing is drawn for it. The generator follows
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
    #: the transform whose step writes the image; None for an input
    made_by: str | None = None


def images(config: dict, shape=None) -> dict:
    """name -> ImageSpec of the configuration (``shape`` overrides every
    image's spatial shape, for the CPU tests). A made image listed before
    an input is refused: the inputs' draws come first."""
    out = {}
    for name, spec in config["images"].items():
        if spec.get("made_by") is None and any(i.made_by for i in out.values()):
            raise ValueError(f"input image {name!r} follows a made image: made images come last")
        spacing = np.asarray(spec.get("spacing", (1.0, 1.0, 1.0)), np.float64)
        out[name] = ImageSpec(
            name=name,
            kind=spec["kind"],
            channels=int(spec["channels"]),
            shape=tuple(int(s) for s in (shape or spec["shape"])),
            dtype=DTYPES[spec["dtype"]],
            affine=np.diag([*spacing, 1.0]),
            spec=spec,
            made_by=spec.get("made_by"),
        )
    return out


def given(specs: dict) -> dict:
    """The inputs among ``specs``: every image but the made ones."""
    return {name: image for name, image in specs.items() if image.made_by is None}


def generator_seed(seed: int) -> int:
    """``--seed`` as a ``torch.Generator`` seed (any whole number)."""
    return int(seed) % 2**63


def blocks(spec: dict, shape, device) -> torch.Tensor:
    """(1, I, J, K) labels ``values[(i // n + j // n + k // n) % len(values)]``."""
    n, values = int(spec["block"]), spec["values"]
    i, j, k = (torch.arange(s, device=device) // n for s in shape)
    index = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % len(values)
    return torch.as_tensor(values, dtype=torch.int32, device=device)[index][None]


def grid(spec: dict, shape, device) -> torch.Tensor:
    """(1, I, J, K) labels ``values[(p_i gj gk + p_j gk + p_k) % len(values)]``
    with ``(gi, gj, gk) = spec["grid"]``: each axis cut into that many
    equal parts, voxel ``(i, j, k)`` in part ``p_i = i gi // I`` (and so
    on): the parts scale with the shape."""
    gi, gj, gk = (int(g) for g in spec["grid"])
    values = spec["values"]
    i, j, k = (torch.arange(s, device=device) * g // s for s, g in zip(shape, (gi, gj, gk)))
    index = (i[:, None, None] * (gj * gk) + j[None, :, None] * gk + k[None, None, :]) % len(values)
    return torch.as_tensor(values, dtype=torch.int32, device=device)[index][None]


LAYOUTS = {"blocks": blocks, "grid": grid}


def label_map(image: ImageSpec, device) -> torch.Tensor:
    """One element's (1, I, J, K) label map. A declared value that the
    layout leaves out at this shape raises: the program draws only the
    labels the map holds, the reference every declared one."""
    layout = LAYOUTS.get(image.spec.get("labels"))
    if layout is None:
        raise ValueError(f"no generator for image {image.name!r}: {image.spec}")
    labels = layout(image.spec, image.shape, device)
    missing = sorted(set(int(v) for v in image.spec["values"])
                     - set(torch.unique(labels).tolist()))
    if missing:
        raise ValueError(f"label map {image.name!r} at {image.shape} lacks the declared"
                         f" values {missing}")
    return labels


def make(specs: dict, batch: int, seed: int, device) -> dict:
    """name -> (B, C, I, J, K) tensor on ``device``, for each input."""
    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    out = {}
    for name, image in given(specs).items():
        if image.kind == "scalar":
            out[name] = torch.rand((batch, image.channels, *image.shape), generator=gen,
                                   device=device, dtype=image.dtype)
        else:
            out[name] = label_map(image, device).expand(batch, *([-1] * 4)).contiguous()
    return out
