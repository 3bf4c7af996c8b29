"""Work of the partial-volume label vote (``tio_resample_label``): each
Spatial record's label maps under ``label_interpolation="label"``, for the
elements it resampled. An element reads its int32 labels and writes its
output once, with its map and field; a voxel costs its sample point, 8
corner weights (16 operations), each added to its label's total (7
sums), the top total (7 compares) and the in-bounds weight (7 sums). The
label compares are integer work and not counted."""

from __future__ import annotations

from port_bench.work._common import field_bytes, geometry, mode, out_voxels, records, voxels
from port_bench.yardstick import point_flops


def matches(name: str) -> bool:
    return "Vote<" in name


def work(history, images, batch: int) -> tuple[float, float]:
    nbytes = flops = 0
    for params in records(history, "Spatial"):
        elements = geometry(params, batch)
        for name in params.get("selected_images", []):
            image = images[name]
            if image.kind != "label" or mode(params, image) != "label":
                continue
            v_in, v_out = voxels(image.shape), out_voxels(params, image)
            for resampled, field in elements:
                if resampled:
                    nbytes += 4 * (v_in + v_out) + field_bytes(params, batch)
                    flops += v_out * (point_flops(field) + 16 + 7 + 7 + 7)
    return nbytes, flops
