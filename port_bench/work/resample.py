"""Work of the grid-spec resample, orders 0 and 1 (``tio_resample``):
each Spatial record's images sampled linearly or at the nearest voxel,
for the elements it resampled. Each element reads its volume (float32:
an integer label map is given to the kernel cast to float32) and writes
its output once, with its 3x4 map, coarse field and fill; a voxel costs
its sample point and the 8 corner weights, a channel 15 more (8
products, 7 sums) when linear."""

from __future__ import annotations

import re

from port_bench.work._common import field_bytes, geometry, mode, out_voxels, records, voxels
from port_bench.yardstick import point_flops

#: the kernel's profiler name: the row-tiled resample body on a grid spec
#: (the dense-coordinate source is ``resample_coords``)
_BODY = re.compile(r"Resample<")
_DENSE = re.compile(r"Source\)2|Source::kDense|SourceE2E")


def matches(name: str) -> bool:
    return bool(_BODY.search(name)) and not _DENSE.search(name)


def work(history, images, batch: int) -> tuple[float, float]:
    nbytes = flops = 0
    for params in records(history, "Spatial"):
        elements = geometry(params, batch)
        for name in params.get("selected_images", []):
            image = images[name]
            how = mode(params, image)
            if how not in ("linear", "nearest"):
                continue
            v_in, v_out, c = voxels(image.shape), out_voxels(params, image), image.channels
            for resampled, field in elements:
                if not resampled:
                    continue
                nbytes += 4 * c * (v_in + v_out) + field_bytes(params, batch) + 4 * c
                flops += v_out * (point_flops(field) + 16)
                if how == "linear":
                    flops += v_out * c * 15
    return nbytes, flops
