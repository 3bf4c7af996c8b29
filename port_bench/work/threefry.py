"""Work of the threefry normals (``threefry::segments_kernel``): the
coarse fields BiasField draws for the elements whose p-gate drew it (a
(C, *small) field each, ``small`` the scaled shape, at least 4 a side),
the noise field Noise draws for each scalar image of those elements (two
with Rician noise), and LabelsToImage's normals: one for each voxel of
the image it makes, in each element where some label has a nonzero std
(an element whose stds are all zero is its means, and needs none),
whatever the number of labels. BiasField and Noise count a made image
only after the record of its maker. A normal writes 4 bytes and reads
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


def tissue_elements(params: dict, batch: int) -> int:
    """LabelsToImage's elements that need normals: those where some label
    has a nonzero std. The history does not hold the warped map's voxels
    a label, so such an element counts every voxel, also where some of
    its labels have a zero std (``ignore_background``): there the count
    is an upper bound, which no cell's traffic meets (the SynthSeg cell
    draws every std from U(0.01, 0.1)). The label map that a one-pass
    kernel reads is not counted, so the least time stays a lower bound
    on what a kernel needs."""
    return sum(1 for stds in per_element(params, "stds", batch)
               if any(float(v) != 0 for v in stds.values()))


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
        count += tissue_elements(params, batch) * voxels(made[0].shape)
    return count


def work(history, images, batch: int) -> tuple[float, float]:
    n = normals(history, images, batch)
    return 4 * n, n * THREEFRY_OPS
