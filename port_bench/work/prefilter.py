"""Work of the B-spline prefilter (its three axis passes): each Spatial
record's scalar images under a spline interpolation, for the elements it
resampled. An element reads its volume and writes its coefficients once;
the operations are ``yardstick.prefilter_flops``."""

from __future__ import annotations

from port_bench.work._common import ORDERS, geometry, mode, records, voxels
from port_bench.yardstick import prefilter_flops


def matches(name: str) -> bool:
    return "prefilter_" in name


def work(history, images, batch: int) -> tuple[float, float]:
    nbytes = flops = 0
    for params in records(history, "Spatial"):
        elements = geometry(params, batch)
        for name in params.get("selected_images", []):
            image = images[name]
            order = ORDERS.get(mode(params, image), 0)
            if image.kind != "scalar" or order < 2:
                continue
            c = image.channels
            for resampled, _ in elements:
                if resampled:
                    nbytes += 2 * 4 * c * voxels(image.shape)
                    flops += prefilter_flops(order, (c, *image.shape))
    return nbytes, flops
