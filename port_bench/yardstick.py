"""The yardstick of the kernels' rooflines: published peaks, the least
time of a piece of work, and the operations that the work functions of
``work/`` count.

Frozen copies, from ``chip_smoke.py`` at commit fe6a028: ``bound``,
``point_flops``, ``weight_flops``, ``spline_flops``, ``prefilter_flops``,
``THREEFRY_OPS``, ``PEAK_BYTES_PER_S`` and ``PEAK_F32_PER_S``; the
prefilter's poles and horizons from ``torchio_tpu_torch/ops/bspline.py``
(``POLES``, ``pole_constants``) at the same commit. They count the work
from the shapes an operation is given and never from a kernel's launch
plan, so the same work reads the same whatever implements it.
"""

from __future__ import annotations

import math

#: an H100 SXM's published peaks (NVIDIA's data sheet, at its 700 W
#: limit): HBM3 bytes/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

#: operations a threefry normal takes: 2 counter adds, 20 rounds of add,
#: rotate and xor, 5 key injections of 2 adds, the final xor (73 integer
#: operations); the mantissa's shift and or; the uniform's subtract,
#: multiply, add and max; erf_inv's square, log1p, compare, two
#: subtracts, sqrt, 9 coefficient selects, 8 Horner steps of 2, the
#: |x| == 1 test and select, the product with x; the product with
#: sqrt(2) (log1p and sqrt counted as one operation each)
THREEFRY_OPS = 73 + 2 + 4 + (1 + 1 + 1 + 2 + 1 + 1 + 9 + 16 + 2 + 1 + 1) + 1

#: IIR poles of the direct B-spline filters (Unser 1993, table 1)
POLES = {
    2: (-0.17157287525380990239662255158,),
    3: (-0.26794919243112270647255365849,),
    4: (-0.36134122590022017709221284132, -0.01372542929733912136033122694),
    5: (-0.43057534709997379185143478349, -0.04309628820326465382271237682),
    6: (-0.48829458930304475513011803888, -0.08167927107623751259793776574,
        -0.00141415180832581765183631288),
    7: (-0.53528043079643887072821797559, -0.12255461519232669051527226436,
        -0.00914869480960827692853533247),
}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of a kernel's work, the larger
    of its bytes over the memory rate and its operations over the float32
    rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def point_flops(field: bool) -> int:
    """float32 operations per output voxel of a sample point: the 3x4 map
    (9 products, 9 sums) and, with a field, 3 components x 7 lerps x 4."""
    return 18 + (84 if field else 0)


def weight_flops(order: int) -> int:
    """Operations per axis for the fold, the base and the order+1 tap
    weights (closed forms at orders 2-3, Cox-de Boor's 2^order - 1 nodes
    of 5 operations per weight at 4-7)."""
    if order == 2:
        return 7 + 9
    if order == 3:
        return 7 + 28
    return 7 + (order + 1) * 5 * (2**order - 1)


def spline_flops(order: int, voxels: int, channels: int, field: bool) -> int:
    """Per output voxel: its point, the 3-axis fill mask (6 each), the
    weights and the T^2 products wi wj; per voxel and channel, T^2 k sums
    of T products and T - 1 sums, each times its wi wj and added:
    T^2 (2T + 1), 144 at order 3."""
    t = order + 1
    per_voxel = point_flops(field) + 18 + 3 * weight_flops(order) + t * t
    return voxels * per_voxel + voxels * channels * t * t * (2 * t + 1)


def pole_horizons(order: int) -> list[int]:
    """Each pole's truncated start-sum length (a relative 1e-10)."""
    return [int(math.ceil(math.log(1e-10) / math.log(abs(z)))) + 1 for z in POLES[order]]


def prefilter_flops(order: int, shape) -> int:
    """The gain, every pole's start sum (3 operations a term) and its two
    sweeps (2 a sample, 3 for the anticausal start), per line and axis of
    a (..., I, J, K) volume."""
    total = 0
    for n in shape[-3:]:
        if n == 1:
            continue
        lines = math.prod(shape) // n
        per_line = n
        for horizon in pole_horizons(order):
            terms = horizon if horizon < n else 2 * n - 2
            per_line += 3 * terms + 4 * (n - 1) + 3
        total += lines * per_line
    return total
