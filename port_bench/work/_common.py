"""Helpers the work functions share: which elements of a call a
transform's recorded parameters drew, which images a call holds at each
of its records, and the sizes of the images."""

from __future__ import annotations

import math


def records(history, name: str):
    """The params of every record of transform ``name`` in a call's
    history (a list of ``(name, params)``)."""
    return [params for record, params in history if record == name]


def records_at(history, name: str):
    """``(position, params)`` of every record of transform ``name`` in a
    call's history."""
    return [(i, params) for i, (record, params) in enumerate(history) if record == name]


def present(history, images, position: int) -> dict:
    """The images a call holds at record ``position`` of its history:
    every input, and each made image (``made_by``) once a record of the
    transform that makes it came before."""
    before = {record for record, _ in history[:position]}
    return {name: image for name, image in images.items()
            if image.made_by is None or image.made_by in before}


def per_element(params: dict, key: str, batch: int) -> list:
    """``params[key]`` as one value an element (a batch-wide value
    repeated)."""
    value = params.get(key)
    if key in (params.get("_batched_keys") or []):
        return list(value)
    return [value] * batch


def kept(params: dict, batch: int) -> list[bool]:
    """Which elements the transform's per-element p-gate drew."""
    keep = params.get("_keep")
    return [True] * batch if keep is None else [bool(k) for k in keep]


def voxels(shape) -> int:
    return math.prod(int(s) for s in shape)


def out_voxels(params: dict, image) -> int:
    """Output voxels of a resample: the target's, else the input's."""
    target = params.get("target")
    return voxels(target["shape"] if target else image.shape)


def geometry(params: dict, batch: int) -> list[tuple[bool, bool]]:
    """Per element of a Spatial record: (resampled, with a field). An
    element with neither an affine nor a field is passed through; with a
    target every element is resampled."""
    affines = per_element(params, "affine_matrix", batch)
    fields = per_element(params, "control_points", batch)
    target = params.get("target") is not None
    return [(target or a is not None or f is not None, f is not None)
            for a, f in zip(affines, fields)]


def field_bytes(params: dict, batch: int) -> int:
    """Bytes of one element's map (3x4 float32) and coarse field."""
    fields = [f for f in per_element(params, "control_points", batch) if f is not None]
    cp = 0
    if fields:
        f = fields[0]
        cp = len(f) * len(f[0]) * len(f[0][0]) * 3 * 4
    return 12 * 4 + cp


def scalar_names(images) -> list[str]:
    return [name for name, image in images.items() if image.kind == "scalar"]


def mode(params: dict, image) -> str:
    key = "label_interpolation" if image.kind == "label" else "image_interpolation"
    return params[key]


ORDERS = {"nearest": 0, "linear": 1, "quadratic": 2, "cubic": 3, "fourth": 4,
          "fifth": 5, "sixth": 6, "seventh": 7}
