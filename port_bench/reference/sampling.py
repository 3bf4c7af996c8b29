"""Plain PyTorch sampling of one element's volume: the trilinear and
nearest resample with the in-bounds fill, the partial-volume label vote,
the B-spline prefilter and spline, and the separable trilinear upsample
of a coarse field.

Frozen copies of the plain versions of ``torchio_tpu_torch/ops/resample.py``
(``_axis_coords``, ``lerp_at``, ``upsample_field``, ``upsample_volume``,
``coord_planes``, ``_axis_weights``, ``_sample``, ``_vote``) and
``torchio_tpu_torch/ops/bspline.py`` (``pole_constants``,
``_prefilter_axis``, ``_fold_coord``, ``_reflect_index``, ``_spline_taps``
at orders 2 and 3, ``bspline_sample_plain``, ``_inbounds_mask``) at
commit fe6a028, with
nothing of the program imported. The sample point of output voxel
``(i, j, k)`` is ``M [i, j, k, 1]`` summed as ``((i m0 + j m1) + k m2) +
m3`` plus the trilinearly upsampled coarse displacement."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.yardstick import POLES


def _axis_coords(n_in: int, n_out: int, device) -> torch.Tensor:
    if n_out == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    ratio = torch.tensor((n_in - 1) / (n_out - 1), dtype=torch.float32, device=device)
    return torch.arange(n_out, dtype=torch.float32, device=device) * ratio


def _lerp_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    g = _axis_coords(x.shape[dim], n_out, x.device)
    n_in = x.shape[dim]
    i0 = torch.floor(g).long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(0, n_in - 1)
    shape = [1] * x.ndim
    shape[dim] = -1
    f = (g - i0.to(torch.float32)).reshape(shape)
    return x.index_select(dim, i0) * (1.0 - f) + x.index_select(dim, i1) * f


def upsample_field(field: torch.Tensor, out_shape) -> torch.Tensor:
    """A coarse (n_i, n_j, n_k, 3) field upsampled to ``(*out_shape, 3)``
    (align_corners): lerps over i, then j, then k."""
    out = field.to(torch.float32)
    for dim, n_out in enumerate(out_shape):
        out = _lerp_axis(out, int(n_out), dim)
    return out


def upsample_volume(x: torch.Tensor, out_shape) -> torch.Tensor:
    """Trilinear align_corners upsample over the last three axes."""
    out = x.to(torch.float32)
    for rel, n_out in enumerate(out_shape):
        out = _lerp_axis(out, int(n_out), out.ndim - 3 + rel)
    return out


def coord_planes(map34: torch.Tensor, out_shape):
    io, jo, ko = out_shape
    dev = map34.device
    ri = torch.arange(io, dtype=torch.float32, device=dev)[:, None, None]
    rj = torch.arange(jo, dtype=torch.float32, device=dev)[None, :, None]
    rk = torch.arange(ko, dtype=torch.float32, device=dev)[None, None, :]
    return tuple(
        ri * map34[a, 0] + rj * map34[a, 1] + rk * map34[a, 2] + map34[a, 3]
        for a in range(3)
    )


def points(matrix: np.ndarray, field, out_shape, device):
    """Three (Io, Jo, Ko) float32 coordinate arrays of a 4x4 float64 map
    (rounded to float32) plus an optional coarse float32 field."""
    m = torch.as_tensor(np.asarray(matrix, np.float64)[:3].astype(np.float32), device=device)
    ci, cj, ck = coord_planes(m, out_shape)
    if field is not None:
        disp = upsample_field(torch.as_tensor(np.asarray(field, np.float32), device=device),
                              out_shape)
        ci, cj, ck = ci + disp[..., 0], cj + disp[..., 1], ck + disp[..., 2]
    return ci, cj, ck


def _inb(index, size: int):
    return (index >= 0) & (index < size)


def _axis_weights(c, size: int):
    i0 = torch.floor(c).long()
    f = c - i0.to(torch.float32)
    return i0, ((1.0 - f) * _inb(i0, size), f * _inb(i0 + 1, size))


def sample(vol, ci, cj, ck, fill, mode: str, apply_fill: bool):
    """vol (C, I, J, K) float32 at three (Io, Jo, Ko) coordinate arrays,
    linear or nearest; where the trilinear in-bounds weight is <= 0.5 the
    voxel takes ``fill`` (C,) if ``apply_fill``. Returns (C, Io, Jo, Ko)."""
    c, si, sj, sk = vol.shape
    flat = vol.reshape(c, -1)
    if si == 1:
        ci = torch.zeros_like(ci)
    if sj == 1:
        cj = torch.zeros_like(cj)
    if sk == 1:
        ck = torch.zeros_like(ck)
    i0, wi = _axis_weights(ci, si)
    j0, wj = _axis_weights(cj, sj)
    k0, wk = _axis_weights(ck, sk)
    mask = torch.zeros_like(ci)
    acc = None if mode == "nearest" else torch.zeros((c, *ci.shape), device=vol.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = wi[di] * wj[dj] * wk[dk]
                mask = mask + w
                if acc is None:
                    continue
                idx = (
                    (i0 + di).clamp(0, si - 1) * (sj * sk)
                    + (j0 + dj).clamp(0, sj - 1) * sk
                    + (k0 + dk).clamp(0, sk - 1)
                )
                acc = acc + flat[:, idx] * w
    if acc is None:
        ri, rj, rk = torch.round(ci).long(), torch.round(cj).long(), torch.round(ck).long()
        valid = _inb(ri, si) & _inb(rj, sj) & _inb(rk, sk)
        idx = ri.clamp(0, si - 1) * (sj * sk) + rj.clamp(0, sj - 1) * sk + rk.clamp(0, sk - 1)
        acc = flat[:, idx] * valid
    if not apply_fill:
        return acc
    return torch.where(mask > 0.5, acc, fill.reshape(-1, 1, 1, 1))


def vote(labels, ci, cj, ck, pad):
    """Partial-volume vote of (I, J, K) labels: each corner's label scores
    the summed weight of the corners that carry it, the top score wins
    (ties to the smallest label), ``pad`` where the in-bounds weight is
    <= 0.5."""
    si, sj, sk = labels.shape
    flat = labels.reshape(-1)
    if si == 1:
        ci = torch.zeros_like(ci)
    if sj == 1:
        cj = torch.zeros_like(cj)
    if sk == 1:
        ck = torch.zeros_like(ck)
    i0, wi = _axis_weights(ci, si)
    j0, wj = _axis_weights(cj, sj)
    k0, wk = _axis_weights(ck, sk)
    weights, labs = [], []
    wsum = torch.zeros_like(ci)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = wi[di] * wj[dj] * wk[dk]
                weights.append(w)
                wsum = wsum + w
                idx = (
                    (i0 + di).clamp(0, si - 1) * (sj * sk)
                    + (j0 + dj).clamp(0, sj - 1) * sk
                    + (k0 + dk).clamp(0, sk - 1)
                )
                labs.append(flat[idx])
    scores = []
    for lab in labs:
        score = torch.zeros_like(ci)
        for other, w in zip(labs, weights):
            score = score + torch.where(other == lab, w, 0.0)
        scores.append(score)
    top = scores[0]
    for score in scores[1:]:
        top = torch.maximum(top, score)
    big = float("inf") if labels.dtype.is_floating_point else torch.iinfo(labels.dtype).max
    winner = torch.full_like(labs[0], big)
    for score, lab in zip(scores, labs):
        winner = torch.minimum(winner, torch.where(score == top, lab, big))
    return torch.where(wsum > 0.5, winner, pad)


# ----------------------------------------------------------------------
# B-splines: the prefilter (orders 2-7) and the spline (orders 2 and 3)
# ----------------------------------------------------------------------


def pole_constants(order: int, n: int):
    poles = POLES[order]
    lam = 1.0
    for z in poles:
        lam *= (1.0 - z) * (1.0 - 1.0 / z)
    constants = []
    period = 2 * n - 2
    for z in poles:
        horizon = int(np.ceil(np.log(1e-10) / np.log(abs(z)))) + 1
        inv_denom = 1.0 / (1.0 - z**period) if period else 0.0
        constants.append((z, horizon, inv_denom, z / (z * z - 1.0)))
    return lam, constants


def _powers(z: float, count: int, device):
    return torch.tensor(z, dtype=torch.float32, device=device) ** torch.arange(
        count, dtype=torch.float32, device=device
    )


def _prefilter_axis(x, dim: int, order: int):
    n = x.shape[dim]
    if n == 1:
        return x
    lam, constants = pole_constants(order, n)
    x = torch.movedim(x, dim, 0) * lam
    for z, horizon, inv_denom, anti in constants:
        if horizon < n:
            c0 = torch.tensordot(_powers(z, horizon, x.device), x[:horizon], dims=1)
        else:
            mirror = torch.cat([x, x.flip(0)[1:-1]])
            c0 = torch.tensordot(_powers(z, 2 * n - 2, x.device), mirror, dims=1) * inv_denom
        x[0] = c0
        for i in range(1, n):
            x[i] = x[i] + z * x[i - 1]
        x[n - 1] = anti * (z * x[n - 2] + x[n - 1])
        for i in range(n - 2, -1, -1):
            x[i] = z * (x[i + 1] - x[i])
    return torch.movedim(x, 0, dim)


def prefilter(volume, order: int):
    """B-spline coefficients of a (..., I, J, K) volume (Unser's direct
    transform under mirror boundaries)."""
    out = volume.to(torch.float32)
    for rel in range(3):
        out = _prefilter_axis(out, out.ndim - 3 + rel, order)
    return out.contiguous()


def _fold_coord(x, size: int):
    if size == 1:
        return torch.zeros_like(x)
    period = 2.0 * (size - 1)
    y = torch.fmod(x.abs(), period)
    return torch.where(y > size - 1, period - y, y)


def _reflect_index(idx, size: int):
    if size == 1:
        return torch.zeros_like(idx)
    period = 2 * size - 2
    idx = torch.remainder(idx.abs(), period)
    return torch.where(idx >= size, period - idx, idx)


def _spline_taps(c, n: int, order: int):
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
        raise NotImplementedError(f"the spline reference has orders 2 and 3, not {order}")
    return [_reflect_index(start + d, n) for d in range(order + 1)], weights


def spline(coeffs, ci, cj, ck, fill, order: int):
    """The spline of (C, I, J, K) coefficients at three (Io, Jo, Ko)
    coordinate arrays; ``fill`` (C,) where the raw coordinate's bilinear
    in-bounds weight is <= 0.5 (always applied)."""
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
    mask = None
    for coord, size in zip((ci, cj, ck), (si, sj, sk)):
        f0 = torch.floor(coord)
        frac = coord - f0
        w0 = torch.where((f0 >= 0) & (f0 < size), 1.0 - frac, 0.0)
        w1 = torch.where((f0 + 1 >= 0) & (f0 + 1 < size), frac, 0.0)
        mask = w0 + w1 if mask is None else mask * (w0 + w1)
    return torch.where(mask > 0.5, acc, fill.reshape(-1, 1, 1, 1))
