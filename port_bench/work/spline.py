"""Work of the grid-spec B-spline (``spline_kernel``, orders 2-7): each
Spatial record's scalar images under a spline interpolation, for the
elements it resampled. An element reads its prefiltered coefficients and
writes its output once, with its map, field and fill; the operations are
``yardstick.spline_flops``."""

from __future__ import annotations

from port_bench.work._common import (
    ORDERS, field_bytes, geometry, mode, out_voxels, records, voxels,
)
from port_bench.yardstick import spline_flops


def matches(name: str) -> bool:
    return "spline_kernel<" in name


def work(history, images, batch: int) -> tuple[float, float]:
    nbytes = flops = 0
    for params in records(history, "Spatial"):
        elements = geometry(params, batch)
        for name in params.get("selected_images", []):
            image = images[name]
            order = ORDERS.get(mode(params, image), 0)
            if image.kind != "scalar" or order < 2:
                continue
            v_in, v_out, c = voxels(image.shape), out_voxels(params, image), image.channels
            for resampled, field in elements:
                if resampled:
                    nbytes += 4 * c * (v_in + v_out) + field_bytes(params, batch) + 4 * c
                    flops += spline_flops(order, v_out, c, field)
    return nbytes, flops
