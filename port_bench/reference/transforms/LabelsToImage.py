"""LabelsToImage: a new scalar image from a label map, SynthSeg's
generative step. Each label's tissue is ``mean + std * N(0, 1)``, the
mean and std drawn on the host for each element (from the given ranges
by the label's place in sorted order, else from the defaults; label 0 at
zero with ``ignore_background``). The fields are drawn by threefry from
the recorded seed: for each label in sorted order that has a nonzero
mean or std in some element, ``key, sub = split(key)`` and a
``(B, 1, I, J, K)`` draw of ``sub``, an element its own rows of it. Each
voxel takes its own label's tissue; a voxel of no drawn label is 0.

The labels are the label map's declared ``values``, sorted. The program
counts the labels of the warped map on the card instead, so this
assumes that every declared label survives the steps before and that no
other value appears: where one does not, the draws fall out of step and
the comparison fails, which is the safe outcome."""

from __future__ import annotations

import math

import torch

from port_bench.reference import draws
from port_bench.reference.threefry import normals, prng_key, split

NEEDS_FIRST = False
SUPPORTED = {
    "label_key", "image_key", "mean", "std", "default_mean", "default_std",
    "ignore_background", "p", "per_instance",
}
DEFAULT_MEAN, DEFAULT_STD = (0.1, 0.9), (0.01, 0.1)


def label_key(args: dict, ctx) -> str:
    """The label map read: ``label_key``, else the first label map."""
    key = args.get("label_key")
    if key is not None:
        return key
    return next(name for name, image in ctx.images.items() if image.kind == "label")


def labels(args: dict, ctx) -> list[int]:
    return sorted(int(v) for v in ctx.images[label_key(args, ctx)].spec["values"])


def _values(args: dict, values: list[int], rng) -> tuple[dict, dict]:
    """One element's mean and std of each label, drawn in the program's
    order: label by label, the mean then the std."""
    means, stds = {}, {}
    mean_ranges, std_ranges = args.get("mean"), args.get("std")
    for index, label in enumerate(values):
        if args.get("ignore_background", False) and label == 0:
            means[label] = stds[label] = 0.0
            continue
        if mean_ranges is not None and index < len(mean_ranges):
            means[label] = draws.sample_1d(mean_ranges[index], rng)
        else:
            means[label] = draws.sample_1d(args.get("default_mean", DEFAULT_MEAN), rng)
        if std_ranges is not None and index < len(std_ranges):
            stds[label] = draws.sample_1d(std_ranges[index], rng)
        else:
            stds[label] = abs(draws.sample_1d(args.get("default_std", DEFAULT_STD), rng))
    return means, stds


def draw(args: dict, rng, ctx):
    unknown = set(args) - SUPPORTED
    if unknown:
        raise NotImplementedError(f"the LabelsToImage reference has no {sorted(unknown)}")
    # the program gates LabelsToImage by one coin a batch, never per element
    if not draws.coin(args, rng, ctx.batch, per_element_p=False):
        return None
    recorded = draws.seed(rng)
    values = labels(args, ctx)
    if draws.per_instance(args, ctx.batch):
        drawn = [_values(args, values, rng) for _ in range(ctx.batch)]
    else:
        drawn = [_values(args, values, rng)] * ctx.batch
    return {"seed": recorded, "labels": values,
            "means": [m for m, _ in drawn], "stds": [s for _, s in drawn]}


def apply(params, args: dict, data: dict, rows: list[int], ctx) -> dict:
    label_map = data[label_key(args, ctx)][:, 0:1]
    count = math.prod(label_map.shape[1:])
    key = prng_key(params["seed"])
    volumes = [torch.zeros(label_map.shape[1:], dtype=torch.float32, device=ctx.device)
               for _ in rows]
    for label in params["labels"]:
        means = [m[label] for m in params["means"]]
        stds = [s[label] for s in params["stds"]]
        if not any(means) and not any(stds):
            continue
        key, sub = split(key)
        for r, b in enumerate(rows):
            tissue = normals(sub, b * count, count, ctx.device).reshape(volumes[r].shape)
            std, mean = (torch.tensor(v[b], dtype=torch.float32, device=ctx.device)
                         for v in (stds, means))
            volumes[r] = torch.where(label_map[r] == label, tissue * std + mean, volumes[r])
    out = dict(data)
    out[args.get("image_key", "image_from_labels")] = torch.stack([ctx.store(v) for v in volumes])
    return out
