"""Work of the dense-coordinate resample (``tio_resample_coords``):
Motion's moves, one resample of every scalar image a move, for the
elements whose p-gate drew Motion and that have that move. An element
reads its volume and its (I, J, K, 3) float32 coordinates and writes its
output once; a voxel costs 8 corner weights (16 operations), a channel
15 more (8 products, 7 sums)."""

from __future__ import annotations

from port_bench.work._common import per_element, records, scalar_names, voxels
from port_bench.work.resample import _BODY, _DENSE


def matches(name: str) -> bool:
    return bool(_BODY.search(name)) and bool(_DENSE.search(name))


def work(history, images, batch: int) -> tuple[float, float]:
    nbytes = flops = 0
    for params in records(history, "Motion"):
        moves = [len(t) for t in per_element(params, "transforms", batch)]
        for name in scalar_names(images):
            image = images[name]
            v, c = voxels(image.shape), image.channels
            for count in moves:
                nbytes += count * (4 * c * v + 12 * v + 4 * c * v)
                flops += count * (16 * v + 15 * c * v)
    return nbytes, flops
