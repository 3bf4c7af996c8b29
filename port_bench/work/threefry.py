"""Work of the threefry normals (``threefry::segments_kernel``): the
coarse fields BiasField draws for the elements whose p-gate drew it (a
(C, *small) field each, ``small`` the scaled shape, at least 4 a side),
the noise field Noise draws for each scalar image of those elements (two
with Rician noise), and LabelsToImage's tissue fields: a (B, 1, I, J, K)
field, at the shape of the image it makes, for each label with a nonzero
mean or std in some element. BiasField and Noise count a made image only
after the record of its maker. A normal writes 4 bytes and reads
nothing; it costs ``yardstick.THREEFRY_OPS`` operations."""

from __future__ import annotations

from port_bench.work._common import (
    kept, per_element, present, records, records_at, scalar_names, voxels,
)
from port_bench.yardstick import THREEFRY_OPS


def matches(name: str) -> bool:
    return "segments_kernel" in name


def _small(shape, scale: float) -> int:
    return voxels(max(round(s * scale), 4) for s in shape)


def _by_label(values: dict) -> dict:
    """A label's value by its int label (a JSON history has string keys)."""
    return {int(label): float(v) for label, v in values.items()}


def drawn_labels(params: dict, batch: int) -> int:
    """LabelsToImage's fields: the labels with a nonzero mean or std in
    some element."""
    values = [_by_label(v) for key in ("means", "stds") for v in per_element(params, key, batch)]
    return len({label for v in values for label, x in v.items() if x != 0})


def normals(history, images, batch: int) -> int:
    count = 0
    for position, params in records_at(history, "BiasField"):
        stds = per_element(params, "std", batch)
        for name in scalar_names(present(history, images, position)):
            image = images[name]
            drawn = sum(1 for s in stds if s != 0)
            count += drawn * image.channels * _small(image.shape, params["scale"])
    for position, params in records_at(history, "Noise"):
        fields = 2 if params.get("rician") else 1
        drawn = sum(kept(params, batch))
        for name in scalar_names(present(history, images, position)):
            image = images[name]
            count += fields * drawn * image.channels * voxels(image.shape)
    for params in records(history, "LabelsToImage"):
        made = [image for image in images.values() if image.made_by == "LabelsToImage"]
        if not made:
            raise ValueError("a LabelsToImage record, and no image of the configuration"
                             " is made_by LabelsToImage")
        count += drawn_labels(params, batch) * batch * voxels(made[0].shape)
    return count


def work(history, images, batch: int) -> tuple[float, float]:
    n = normals(history, images, batch)
    return 4 * n, n * THREEFRY_OPS
