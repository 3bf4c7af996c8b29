"""B-spline resampling of orders 2-7: IIR prefilter and tap evaluation.

Counterpart of ``torchio_tpu/ops/bspline.py`` and of the spline modes of
``torchio_tpu/ops/window_resample.py``:

- :func:`prefilter`: the direct B-spline transform (Unser et al.,
  "B-spline signal processing"), so that the spline of the coefficients
  reproduces the samples at integer coordinates. Along each axis, the
  gain ``lam``, then for each pole a causal recursion from its
  mirror-boundary start (the truncated geometric sum when the horizon is
  shorter than the axis, the exact sum over the mirrored period
  otherwise) and an anticausal recursion from its closed-form start.
- :func:`bspline_resample_fused`: the prefilter, then (order+1)^3 taps
  at the grid-spec coordinates of :mod:`.resample`: each coordinate is
  folded into the volume under mirror (dct1) symmetry, the tap indices
  are reflected into it, and the weights are closed forms for orders 2
  and 3 and the Cox-de Boor recursion for orders 4-7. The fill ALWAYS
  applies where the raw coordinate's bilinear in-bounds weight is
  <= 0.5 (the mirror-folded spline would leak past the volume).
- :func:`bspline_resample`: the same at the points of a dense
  coordinate tensor (the JAX package's ``bspline_resample``).

A CUDA volume runs the hand-written kernels of ``csrc/bspline.cu``
(:mod:`.bspline_kernel`); a CPU volume runs the plain versions here,
:func:`prefilter_plain`, :func:`bspline_resample_plain` and
:func:`bspline_coords_plain`. Both divide
by a constant as a product with its float32 reciprocal (PyTorch's CUDA
division by a scalar does so), so the kernels and the plain versions
round alike on the card; against the JAX package's true divisions this
moves a weight by at most one ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from .resample import _element_coords, _fill_bc, _marshal_maps, dense_coords

#: IIR poles of the direct B-spline filters (Unser 1993, table 1).
POLES: dict[int, tuple[float, ...]] = {
    2: (-0.17157287525380990239662255158,),
    3: (-0.26794919243112270647255365849,),
    4: (-0.36134122590022017709221284132, -0.01372542929733912136033122694),
    5: (-0.43057534709997379185143478349, -0.04309628820326465382271237682),
    6: (-0.48829458930304475513011803888, -0.08167927107623751259793776574,
        -0.00141415180832581765183631288),
    7: (-0.53528043079643887072821797559, -0.12255461519232669051527226436,
        -0.00914869480960827692853533247),
}


def _check_order(order: int) -> None:
    if order not in POLES:
        raise ValueError(f"B-spline order must be 2-7, got {order}")


# --------------------------------------------------------------------
# prefilter
# --------------------------------------------------------------------


def pole_constants(order: int, n: int):
    """Host constants of one axis of ``n`` samples, in float64:
    ``(lam, [(z, horizon, inv_denom, anti), ...])`` with the gain
    ``lam``, and per pole the truncated-sum length, the periodic sum's
    factor ``1 / (1 - z^(2n-2))`` and the anticausal start's gain
    ``z / (z^2 - 1)``."""
    _check_order(order)
    poles = POLES[order]
    lam = 1.0
    for z in poles:
        lam *= (1.0 - z) * (1.0 - 1.0 / z)
    constants = []
    period = 2 * n - 2  # 0 for a size-1 axis, which is left as it is
    for z in poles:
        horizon = int(np.ceil(np.log(1e-10) / np.log(abs(z)))) + 1
        inv_denom = 1.0 / (1.0 - z**period) if period else 0.0
        constants.append((z, horizon, inv_denom, z / (z * z - 1.0)))
    return lam, constants


def _powers(z: float, count: int, device) -> torch.Tensor:
    return torch.tensor(z, dtype=torch.float32, device=device) ** torch.arange(
        count, dtype=torch.float32, device=device
    )


def _prefilter_axis(x: torch.Tensor, dim: int, order: int) -> torch.Tensor:
    """Causal + anticausal passes of every pole along ``dim``."""
    n = x.shape[dim]
    if n == 1:
        return x
    lam, constants = pole_constants(order, n)
    x = torch.movedim(x, dim, 0) * lam
    for z, horizon, inv_denom, anti in constants:
        if horizon < n:
            c0 = torch.tensordot(_powers(z, horizon, x.device), x[:horizon], dims=1)
        else:
            mirror = torch.cat([x, x.flip(0)[1:-1]])  # length 2n - 2
            c0 = torch.tensordot(_powers(z, 2 * n - 2, x.device), mirror, dims=1) * inv_denom
        x[0] = c0
        for i in range(1, n):
            x[i] = x[i] + z * x[i - 1]
        x[n - 1] = anti * (z * x[n - 2] + x[n - 1])
        for i in range(n - 2, -1, -1):
            x[i] = z * (x[i + 1] - x[i])
    return torch.movedim(x, 0, dim)


def prefilter_plain(volume: torch.Tensor, order: int) -> torch.Tensor:
    """Plain PyTorch prefilter of a (..., I, J, K) volume (a new float32
    tensor), the plain version of :func:`.bspline_kernel.prefilter_cuda`."""
    _check_order(order)
    out = volume.to(torch.float32)
    for rel in range(3):
        out = _prefilter_axis(out, out.ndim - 3 + rel, order)
    return out.contiguous()


def prefilter(volume: torch.Tensor, order: int) -> torch.Tensor:
    """B-spline coefficients of a (..., I, J, K) volume, on its device."""
    _check_order(order)
    if volume.device.type == "cuda":
        from .bspline_kernel import prefilter_cuda

        return prefilter_cuda(volume.to(torch.float32).contiguous(), order)
    if volume.device.type != "cpu":
        raise ValueError(f"prefilter runs on cuda or cpu, got {volume.device}")
    return prefilter_plain(volume, order)


# --------------------------------------------------------------------
# taps
# --------------------------------------------------------------------


def _bspline_kernel(t: torch.Tensor, order: int) -> torch.Tensor:
    """Cox-de Boor evaluation of the centered cardinal B-spline B_order."""
    if order == 0:
        return ((t >= -0.5) & (t < 0.5)).to(torch.float32)
    lower = _bspline_kernel(t + 0.5, order - 1)
    upper = _bspline_kernel(t - 0.5, order - 1)
    half = (order + 1) / 2
    return ((t + half) * lower + (half - t) * upper) * (1.0 / order)


def _fold_coord(x: torch.Tensor, size: int) -> torch.Tensor:
    """Fold a coordinate into [0, size-1] under mirror (dct1) symmetry."""
    if size == 1:
        return torch.zeros_like(x)
    period = 2.0 * (size - 1)
    y = torch.fmod(x.abs(), period)
    return torch.where(y > size - 1, period - y, y)


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Mirror (dct1) reflection of integer tap indices into [0, size-1]."""
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * size - 2
    idx = torch.remainder(idx.abs(), period)
    return torch.where(idx >= size, period - idx, idx)


def _spline_taps(c: torch.Tensor, n: int, order: int):
    """The order+1 reflected tap indices and basis weights of the
    coordinates ``c`` on an axis of ``n`` samples: even orders center on
    floor(x + 0.5), odd orders on floor(x); the taps start order // 2
    below."""
    cf = _fold_coord(c, n)
    base = torch.floor(cf + 0.5) if order % 2 == 0 else torch.floor(cf)
    start_f = base - float(order // 2)
    t = cf - start_f
    start = start_f.long()
    if order == 2:
        d0, u1, d2 = t - 1.5, t - 1.0, t - 0.5
        weights = [d0 * d0 * 0.5, 0.75 - u1 * u1, d2 * d2 * 0.5]
    elif order == 3:
        r = t - 1.0
        a0, u2, a3 = 2.0 - (r + 1.0), 1.0 - r, 2.0 - (2.0 - r)
        sixth = 1.0 / 6.0
        weights = [
            a0 * a0 * a0 * sixth,
            (4.0 - 6.0 * r * r + 3.0 * r * r * r) * sixth,
            (4.0 - 6.0 * u2 * u2 + 3.0 * u2 * u2 * u2) * sixth,
            a3 * a3 * a3 * sixth,
        ]
    else:
        weights = [_bspline_kernel(t - float(o), order) for o in range(order + 1)]
    return [_reflect_index(start + d, n) for d in range(order + 1)], weights


def bspline_sample_plain(
    coeffs: torch.Tensor, ci: torch.Tensor, cj: torch.Tensor, ck: torch.Tensor,
    order: int,
) -> torch.Tensor:
    """Spline of one element's (C, I, J, K) coefficients at coordinate
    arrays of one shape; returns (C, *ci.shape), unmasked."""
    c, si, sj, sk = coeffs.shape
    flat = coeffs.reshape(c, -1)
    ti, wi = _spline_taps(ci, si, order)
    tj, wj = _spline_taps(cj, sj, order)
    tk, wk = _spline_taps(ck, sk, order)
    acc = torch.zeros((c, *ci.shape), dtype=torch.float32, device=coeffs.device)
    for a in range(order + 1):
        for b in range(order + 1):
            row = (ti[a] * sj + tj[b]) * sk
            kv = wk[0] * flat[:, row + tk[0]]
            for d in range(1, order + 1):
                kv = kv + wk[d] * flat[:, row + tk[d]]
            acc = acc + (wi[a] * wj[b]) * kv
    return acc


def _inbounds_mask(coords, sizes) -> torch.Tensor:
    """Product over axes of the raw coordinate's two in-bounds linear
    weights (``bspline_resample``'s fill mask; size-1 axes included)."""
    mask = None
    for c, size in zip(coords, sizes):
        f0 = torch.floor(c)
        frac = c - f0
        w0 = torch.where((f0 >= 0) & (f0 < size), 1.0 - frac, 0.0)
        w1 = torch.where((f0 + 1 >= 0) & (f0 + 1 < size), frac, 0.0)
        mask = w0 + w1 if mask is None else mask * (w0 + w1)
    return mask


def bspline_resample_plain(
    coeffs: torch.Tensor,
    maps: torch.Tensor,
    fields: torch.Tensor | None,
    fill: torch.Tensor,
    out_shape: tuple[int, int, int],
    order: int,
) -> torch.Tensor:
    """Plain PyTorch version of the spline kernel, same arguments as
    :func:`.bspline_kernel.bspline_resample_cuda`: coeffs (B, C, I, J, K)
    prefiltered float32, maps (B, 3, 4), fields (B, ni, nj, nk, 3) or
    None, fill (B, C). Returns (B, C, Io, Jo, Ko) float32."""
    _check_order(order)
    return torch.stack([
        _spline_element(coeffs[b], _element_coords(maps, fields, b, out_shape), fill[b], order)
        for b in range(coeffs.shape[0])
    ])


def _spline_element(coeffs, coords, fill, order: int) -> torch.Tensor:
    """One element: the masked spline of (C, I, J, K) coefficients at
    three (Io, Jo, Ko) coordinate arrays, fill (C,)."""
    mask = _inbounds_mask(coords, coeffs.shape[-3:])
    vals = bspline_sample_plain(coeffs, *coords, order)
    return torch.where(mask > 0.5, vals, fill.reshape(-1, 1, 1, 1))


def bspline_coords_plain(
    coeffs: torch.Tensor, coords: torch.Tensor, fill: torch.Tensor, order: int
) -> torch.Tensor:
    """Plain PyTorch version of the dense-coordinate spline kernel, same
    arguments as :func:`.bspline_kernel.bspline_coords_cuda`: coeffs (B,
    C, I, J, K) prefiltered float32, coords (1 or B, Io, Jo, Ko, 3), fill
    (B, C). Returns (B, C, Io, Jo, Ko) float32."""
    _check_order(order)
    outs = []
    for b in range(coeffs.shape[0]):
        grid = coords[b if coords.shape[0] > 1 else 0]
        outs.append(
            _spline_element(coeffs[b], (grid[..., 0], grid[..., 1], grid[..., 2]), fill[b], order)
        )
    return torch.stack(outs)


def bspline_resample_fused(
    data: torch.Tensor,
    matrices,
    control_points,
    *,
    order: int,
    out_shape=None,
    fill=0.0,
) -> torch.Tensor:
    """B-spline resample of a (B, C, I, J, K) batch from per-element grid
    specs (the arguments of :func:`.resample.resample_fused`); the fill
    always applies. Returns (B, C, Io, Jo, Ko) float32 on ``data``'s
    device: a CUDA batch runs the prefilter and spline kernels, a CPU
    batch their plain versions."""
    _check_order(order)
    b, c = data.shape[:2]
    if len(matrices) != b or len(control_points) != b:
        raise ValueError(f"Expected {b} maps and {b} control-point entries")
    out_spatial = tuple(
        int(s) for s in (out_shape if out_shape is not None else data.shape[-3:])
    )
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bspline_resample_fused runs on cuda or cpu, got {data.device}")
    maps, fields = _marshal_maps(matrices, control_points, data.device)
    fill_bc, _ = _fill_bc(fill, b, c, data.device)
    coeffs = prefilter(data, order)
    if data.device.type == "cuda":
        from .bspline_kernel import bspline_resample_cuda

        return bspline_resample_cuda(coeffs, maps, fields, fill_bc, out_spatial, order)
    return bspline_resample_plain(coeffs, maps, fields, fill_bc, out_spatial, order)


def bspline_resample(data: torch.Tensor, coords, *, order: int, fill=0.0) -> torch.Tensor:
    """B-spline resample of a (B, C, I, J, K) batch at dense input-voxel
    coordinates: a shared (Io, Jo, Ko, 3) grid or (B, Io, Jo, Ko, 3)
    per-element grids. The fill (scalar, (C,) or (B, C), host or tensor)
    always applies. Returns (B, C, Io, Jo, Ko) float32 on ``data``'s
    device: a CUDA batch runs the prefilter and dense spline kernels, a
    CPU batch their plain versions."""
    _check_order(order)
    if data.ndim != 5:
        raise ValueError(f"data must be (B, C, I, J, K), got {tuple(data.shape)}")
    if data.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bspline_resample runs on cuda or cpu, got {data.device}")
    b, c = data.shape[:2]
    grid = dense_coords(coords, b, data.device)
    fill_bc, _ = _fill_bc(fill, b, c, data.device)
    coeffs = prefilter(data, order)
    if data.device.type == "cuda":
        from .bspline_kernel import bspline_coords_cuda

        return bspline_coords_cuda(coeffs, grid, fill_bc, order)
    return bspline_coords_plain(coeffs, grid, fill_bc, order)
