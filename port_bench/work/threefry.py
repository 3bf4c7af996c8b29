"""Work of the threefry normals (``threefry::segments_kernel``): the
coarse fields BiasField draws for the elements whose p-gate drew it (a
(C, *small) field each, ``small`` the scaled shape, at least 4 a side),
and the noise field Noise draws for each scalar image of those elements
(two with Rician noise). A normal writes 4 bytes and reads nothing; it
costs ``yardstick.THREEFRY_OPS`` operations."""

from __future__ import annotations

from port_bench.work._common import kept, per_element, records, scalar_names, voxels
from port_bench.yardstick import THREEFRY_OPS


def matches(name: str) -> bool:
    return "segments_kernel" in name


def _small(shape, scale: float) -> int:
    return voxels(max(round(s * scale), 4) for s in shape)


def normals(history, images, batch: int) -> int:
    count = 0
    for params in records(history, "BiasField"):
        stds = per_element(params, "std", batch)
        for name in scalar_names(images):
            image = images[name]
            drawn = sum(1 for s in stds if s != 0)
            count += drawn * image.channels * _small(image.shape, params["scale"])
    for params in records(history, "Noise"):
        fields = 2 if params.get("rician") else 1
        drawn = sum(kept(params, batch))
        for name in scalar_names(images):
            image = images[name]
            count += fields * drawn * image.channels * voxels(image.shape)
    return count


def work(history, images, batch: int) -> tuple[float, float]:
    n = normals(history, images, batch)
    return 4 * n, n * THREEFRY_OPS
