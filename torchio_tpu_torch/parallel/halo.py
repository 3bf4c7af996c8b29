"""Halo-exchange stencils on J-sharded DTensors.

Counterpart of ``torchio_tpu/parallel/halo.py``. The blur and resample
stencils have a support that the host can bound, so a volume split into
J slabs over the mesh's ``space`` axis needs only a halo of that width
from each neighbour: each rank sends its edge slabs to the ranks beside
it (``batch_isend_irecv`` on the ``space`` sub-group: NCCL between GPUs,
gloo on the CPU), computes its own slab from its halo-extended slab, and
no rank ever holds the whole volume.

Each stencil is two parts, as the JAX package's ``shard_map`` closures
are: the exchange (:func:`_exchange_halo`, :func:`_exchange_halo_zero`),
and a local function of the halo-extended slab alone
(:func:`blur_taps`, :func:`halo_resample_local`), which a single card can
run on the slabs its neighbours would send.

The local resample is the port's dense-coordinate kernel
(:func:`..ops.resample.resample`, ``csrc/resample.cu``'s
``tio_resample_coords`` on a card): the slab's input-voxel coordinates
in the JAX package's operation order, shifted into the extended slab by
``halo - j0`` along J, sampled with no fill; the fill mask then comes from
the coordinates in the global frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import gaussian_kernel_1d, radius_for_sigma
from ..ops.resample import _axis_coords, _axis_weights, lerp_at, resample
from .mesh import (
    NamedSharding,
    axis_index,
    axis_size,
    from_local,
    is_dtensor,
    mesh_device,
    place,
    shard_range,
    sharding_of,
)


class HaloUnsupported(ValueError):
    """This grid/sharding combination cannot run the halo program (halo
    wider than the shard, indivisible axis, ...); callers fall back to
    the ordinary (all-gather) resample path."""


# --------------------------------------------------------------------------
# The exchange
# --------------------------------------------------------------------------

#: P2P tags: a rank's right edge travels right, its left edge left; with two
#: space shards both neighbours are one rank, and the tag keeps them apart
_TAG_RIGHTWARD, _TAG_LEFTWARD = 0, 1


def _neighbour_slabs(x: torch.Tensor, width: int, group, dim: int = 3):
    """The ``width``-wide slabs along ``dim`` that this rank's left and
    right neighbours in ``group`` send (their right and left edges), or
    None past the group's ends (a group of one sends nothing)."""
    import torch.distributed as dist

    n, s = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = width
    ops, from_left, from_right = [], None, None
    if s > 0:
        peer = dist.get_global_rank(group, s - 1)
        from_left = torch.empty(shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.isend, x.narrow(dim, 0, width).contiguous(), peer, group,
                              _TAG_LEFTWARD))
        ops.append(dist.P2POp(dist.irecv, from_left, peer, group, _TAG_RIGHTWARD))
    if s < n - 1:
        peer = dist.get_global_rank(group, s + 1)
        from_right = torch.empty(shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.isend, x.narrow(dim, size - width, width).contiguous(), peer,
                              group, _TAG_RIGHTWARD))
        ops.append(dist.P2POp(dist.irecv, from_right, peer, group, _TAG_LEFTWARD))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_left, from_right


def extend(x: torch.Tensor, from_left, from_right, width: int, *, edge: bool, dim: int = 3):
    """``x`` with ``width`` slabs on each side along ``dim``: the
    neighbours' where given, else the edge slab repeated (``edge``) or
    zeros."""
    shape = list(x.shape)
    shape[dim] = width

    def end(slab, index):
        if slab is not None:
            return slab
        if edge:
            return x.narrow(dim, index, 1).expand(shape)
        return x.new_zeros(shape)

    return torch.cat([end(from_left, 0), x, end(from_right, x.shape[dim] - 1)], dim=dim)


def _exchange_halo(x: torch.Tensor, radius: int, group, dim: int = 3):
    """``radius`` slabs along ``dim`` (J) from both neighbours; the edge
    repeated at the global ends (``np.pad(mode="edge")``)."""
    slabs = _neighbour_slabs(x, radius, group, dim)
    return extend(x, *slabs, radius, edge=True, dim=dim)


def _exchange_halo_zero(x: torch.Tensor, width: int, group):
    """``width`` J-slabs from both neighbours; ZEROS at the global ends
    (grid_sample's zero padding, unlike the blur's edge replication)."""
    return extend(x, *_neighbour_slabs(x, width, group), width, edge=False)


#: P2P tag of the mirror exchange (apart from the halos' two)
_TAG_MIRROR = 2


def mirror_columns(x: torch.Tensor, size: int, group, dim: int = 3) -> torch.Tensor:
    """The columns along ``dim`` that mirror this rank's: where ``x`` holds
    columns ``[start, stop)`` of a global extent ``size`` split over
    ``group`` (``torch.chunk``'s split), the global columns ``[size -
    stop, size - start)``, in increasing order, from the ranks that hold
    them: one ``batch_isend_irecv`` on ``group`` (the collective-permute
    of a flip along a split axis). A rank that is its own mirror sends
    nothing."""
    import torch.distributed as dist

    n, s = dist.get_world_size(group), dist.get_rank(group)
    ranges = [shard_range(size, n, p) for p in range(n)]
    start, stop = ranges[s]
    ops, pieces = [], []
    for p, (p0, p1) in enumerate(ranges):
        peer = dist.get_global_rank(group, p)
        # the part of mine that rank p mirrors
        lo, hi = max(size - p1, start), min(size - p0, stop)
        if hi > lo and p != s:
            ops.append(dist.P2POp(dist.isend, x.narrow(dim, lo - start, hi - lo).contiguous(),
                                  peer, group, _TAG_MIRROR))
        # the part of rank p's that mine mirrors
        lo, hi = max(size - stop, p0), min(size - start, p1)
        if hi <= lo:
            continue
        if p == s:
            pieces.append(x.narrow(dim, lo - start, hi - lo))
            continue
        shape = list(x.shape)
        shape[dim] = hi - lo
        piece = torch.empty(shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.irecv, piece, peer, group, _TAG_MIRROR))
        pieces.append(piece)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not pieces:
        return x.narrow(dim, 0, 0)
    return torch.cat(pieces, dim=dim)


#: P2P tag of the column move (apart from the halos' and the mirror's)
_TAG_MOVE = 3


def column_routes(size: int, needs, parts: int, shard: int):
    """Where shard ``shard`` of ``parts`` (``torch.chunk``'s split of a
    global extent ``size``) gets the columns ``needs[shard]`` and where it
    sends its own (``needs[p]``: the global columns shard ``p`` reads):
    ``(start, want, sends, takes)``: its first column, the distinct
    columns it needs, for each other shard the distinct columns of its own
    that shard needs, and for each shard (itself too) the positions in
    ``want`` of the columns that shard holds."""
    ranges = [shard_range(size, parts, p) for p in range(parts)]
    start, stop = ranges[shard]
    want = np.unique(np.asarray(needs[shard], np.int64))
    sends, takes = {}, {}
    for p, (p0, p1) in enumerate(ranges):
        held = np.flatnonzero((want >= p0) & (want < p1))
        if held.size:
            takes[p] = held
        if p != shard:
            theirs = np.unique(np.asarray(needs[p], np.int64))
            mine = theirs[(theirs >= start) & (theirs < stop)]
            if mine.size:
                sends[p] = mine
    return start, want, sends, takes


def assemble_columns(x: torch.Tensor, want, pieces: dict, order, dim: int = 3):
    """The columns ``order`` (global indices, repeats allowed) along
    ``dim``, from ``pieces`` (shard -> (positions in ``want``, those
    columns: the shard's own, or what another shard sent)) placed at their
    positions of ``want`` (the distinct needed columns, sorted; ``x``, the
    shard's block, gives the type and device): a shard's local program
    after the exchange."""
    columns = None
    for at, piece in pieces.values():
        if len(at) == len(want):
            columns = piece
    if columns is None:
        shape = list(x.shape)
        shape[dim] = len(want)
        columns = x.new_empty(shape)
        for at, piece in pieces.values():
            columns.index_copy_(dim, torch.as_tensor(at, device=x.device), piece)
    order = np.searchsorted(want, np.asarray(order, np.int64))
    if len(order) == len(want) and (order == np.arange(len(want))).all():
        return columns
    return columns.index_select(dim, torch.as_tensor(order, device=x.device))


def move_columns(x: torch.Tensor, size: int, needs, group, dim: int = 3) -> torch.Tensor:
    """The columns along ``dim`` that this rank needs, from the ranks that
    hold them: ``x`` holds columns ``[start, stop)`` of a global extent
    ``size`` split over ``group`` (``torch.chunk``'s split), and
    ``needs[p]`` lists the global columns rank ``p`` of ``group`` needs, in
    the order it reads them (repeats allowed). Returns this rank's
    ``needs`` columns in that order. Each pair of ranks exchanges the
    distinct columns one holds and the other needs, once: one
    ``batch_isend_irecv`` on ``group`` (a crop, a pad or an index resample
    along a split axis); none where every rank holds what it needs."""
    import torch.distributed as dist

    n, s = dist.get_world_size(group), dist.get_rank(group)
    start, want, sends, takes = column_routes(size, needs, n, s)
    pieces, ops = {}, []
    for p in range(n):
        peer = dist.get_global_rank(group, p)
        if p in sends:
            index = torch.as_tensor(sends[p] - start, device=x.device)
            ops.append(dist.P2POp(dist.isend, x.index_select(dim, index).contiguous(), peer,
                                  group, _TAG_MOVE))
        if p not in takes:
            continue
        at = takes[p]
        if p == s:
            pieces[p] = (at, x.index_select(dim, torch.as_tensor(want[at] - start,
                                                                 device=x.device)))
            continue
        shape = list(x.shape)
        shape[dim] = len(at)
        piece = torch.empty(shape, dtype=x.dtype, device=x.device)
        ops.append(dist.P2POp(dist.irecv, piece, peer, group, _TAG_MOVE))
        pieces[p] = (at, piece)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return assemble_columns(x, want, pieces, needs[s], dim)


#: P2P tag of the split-axis move
_TAG_SWAP = 4


def move_split(x: torch.Tensor, size: int, src: int, dst: int, group) -> torch.Tensor:
    """The block of a tensor split along ``dst`` and whole along ``src``,
    from ``x``, this rank's block of it split along ``src`` (columns
    ``torch.chunk``'s split of a global extent ``size`` over ``group``)
    and whole along ``dst``: each rank sends every other rank the part of
    its block that falls in that rank's ``dst`` range (``torch.chunk``'s
    split of ``x.shape[dst]``) and receives the other ranks' parts of its
    own range, which it lays along ``src`` in rank order. An all-to-all:
    one ``batch_isend_irecv`` on ``group`` (a Reorient that moves a split
    J); an empty part is neither sent nor received."""
    import torch.distributed as dist

    n, s = dist.get_world_size(group), dist.get_rank(group)
    srcs = [shard_range(int(size), n, p) for p in range(n)]
    dsts = [shard_range(int(x.shape[dst]), n, p) for p in range(n)]
    lo, hi = dsts[s]
    pieces, ops = [], []
    for p in range(n):
        if p == s:
            pieces.append(x.narrow(dst, lo, hi - lo))
            continue
        peer = dist.get_global_rank(group, p)
        part = x.narrow(dst, dsts[p][0], dsts[p][1] - dsts[p][0])
        if part.numel():
            ops.append(dist.P2POp(dist.isend, part.contiguous(), peer, group, _TAG_SWAP))
        shape = list(x.shape)
        shape[src], shape[dst] = srcs[p][1] - srcs[p][0], hi - lo
        piece = torch.empty(shape, dtype=x.dtype, device=x.device)
        if piece.numel():
            ops.append(dist.P2POp(dist.irecv, piece, peer, group, _TAG_SWAP))
        pieces.append(piece)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return torch.cat(pieces, dim=src)


def _local_of(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's region of ``x`` (a DTensor or a whole tensor) placed by
    ``sharding``."""
    return place(x if is_dtensor(x) else torch.as_tensor(x), sharding).to_local()


# --------------------------------------------------------------------------
# Blur
# --------------------------------------------------------------------------


def blur_taps(padded: torch.Tensor, kernel: torch.Tensor, size: int, dim: int = 3):
    """Correlate a halo-extended slab with ``kernel`` along ``dim``:
    ``sum_t kernel[t] * padded[t : t + size]``, summed from zero in tap
    order. ``kernel`` is (2r+1,), or (B, 2r+1) for one kernel a batch row
    of a 5-D slab."""
    out = torch.zeros_like(padded.narrow(dim, 0, size), dtype=torch.float32)
    for tap in range(kernel.shape[-1]):
        weight = kernel[..., tap]
        if weight.ndim:
            weight = weight.reshape((-1,) + (1,) * (padded.ndim - 1))
        out = out + weight * padded.narrow(dim, tap, size)
    return out


def halo_blur(x, sigma: float, mesh, *, truncate: float = 3.0):
    """Gaussian blur along the spatially sharded J axis with a halo
    exchange.

    ``x`` is (B, C, I, J, K) sharded (B -> data, J -> space). Only the J
    pass needs communication; the I and K passes are shard-local (compose
    with :func:`torchio_tpu_torch.ops.gaussian.gaussian_blur` for them).
    Equals ``np.pad(mode="edge")`` correlation along J.
    """
    radius = radius_for_sigma(sigma, truncate)
    data_ax, space_ax = mesh.mesh_dim_names
    sharding = sharding_of(x)
    if sharding is None or sharding.padded()[3] != space_ax:
        sharding = NamedSharding(mesh, (data_ax, None, None, space_ax, None))
    xs = _local_of(x, sharding).to(torch.float32)
    if radius > xs.shape[3]:
        raise HaloUnsupported(
            f"blur radius {radius} exceeds the local shard width {xs.shape[3]}"
        )
    kernel = torch.as_tensor(gaussian_kernel_1d(sigma, radius), device=xs.device)
    padded = _exchange_halo(xs, radius, mesh.get_group(space_ax))
    return from_local(blur_taps(padded, kernel, xs.shape[3]), sharding, x.shape)


# --------------------------------------------------------------------------
# Resample
# --------------------------------------------------------------------------


def _box_corners(si: int, sj: int, sk: int) -> np.ndarray:
    return np.array(
        [[i, j, k] for i in (0.0, si - 1.0) for j in (0.0, sj - 1.0) for k in (0.0, sk - 1.0)]
    )


def _slab_planes(map44: torch.Tensor, si: int, jl: int, sk: int, j0: int):
    """Three (I, jl, K) float32 input-voxel coordinate arrays of the output
    rows ``[j0, j0 + jl)`` in the GLOBAL frame, summed as the JAX package
    sums them: ``((i*m0 + j*m1) + k*m2) + m3``."""
    dev = map44.device
    ri = torch.arange(si, dtype=torch.float32, device=dev)[:, None, None]
    rj = (torch.arange(jl, dtype=torch.float32, device=dev) + float(j0))[None, :, None]
    rk = torch.arange(sk, dtype=torch.float32, device=dev)[None, None, :]
    return tuple(
        ri * map44[a, 0] + rj * map44[a, 1] + rk * map44[a, 2] + map44[a, 3] for a in range(3)
    )


def _upsample_field_slab(cp, out_shape, j_start: int, j_len: int, *, first: int = 0
                         ) -> torch.Tensor:
    """Rows ``[j_start, j_start + j_len)`` of the trilinearly upsampled
    coarse field whose (ni, nj, nk) axes are dims ``first`` to ``first +
    2`` (a (ni, nj, nk, 3) displacement field, or, at ``first = 2``, a
    (B, C, ni, nj, nk) bias field), bit for bit the same rows of
    :func:`..ops.resample.upsample_field` (and ``upsample_volume``) over
    the GLOBAL ``out_shape`` (align_corners: coordinates scale with the
    global extent)."""
    field = torch.as_tensor(cp).to(torch.float32)
    io, jo, ko = (int(s) for s in out_shape)
    dev = field.device
    out = lerp_at(field, _axis_coords(field.shape[first], io, dev), first)
    rows = _axis_coords(field.shape[first + 1], jo, dev)[j_start:j_start + j_len]
    if jo == 1:
        rows = torch.zeros(j_len, dtype=torch.float32, device=dev)
    out = lerp_at(out, rows, first + 1)
    return lerp_at(out, _axis_coords(field.shape[first + 2], ko, dev), first + 2)


def _inbounds_weight(ci, cj, ck, spatial) -> torch.Tensor:
    """The in-bounds weight (the trilinear grid-sample of a ones-volume)
    of the coordinates in the GLOBAL frame of a ``spatial`` volume;
    size-1 axes never leave it."""
    si, sj, sk = spatial
    weights = []
    for c, n in ((ci, si), (cj, sj), (ck, sk)):
        weights.append(_axis_weights(torch.zeros_like(c) if n == 1 else c, n)[1])
    wi, wj, wk = weights
    mask = torch.zeros_like(ci)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                mask = mask + wi[di] * wj[dj] * wk[dk]
    return mask


def spec_planes(maps: torch.Tensor, fields, *, j0: int, jl: int, spatial) -> list:
    """Each element's three (I, jl, K) GLOBAL-frame coordinate arrays of
    the output rows ``[j0, j0 + jl)``: ``maps`` (b, 4, 4) float32, plus
    the rows of its upsampled coarse field (``fields`` (b, ni, nj, nk, 3)
    or None), in the JAX package's order."""
    si, _sj, sk = spatial
    planes = []
    for e in range(maps.shape[0]):
        ci, cj, ck = _slab_planes(maps[e], si, jl, sk, j0)
        if fields is not None:
            disp = _upsample_field_slab(fields[e], spatial, j0, jl)
            ci, cj, ck = ci + disp[..., 0], cj + disp[..., 1], ck + disp[..., 2]
        planes.append((ci, cj, ck))
    return planes


def halo_resample_local(
    ext: torch.Tensor,
    planes: list,
    fill_rows: torch.Tensor,
    *,
    j0: int,
    halo: int,
    spatial: tuple[int, int, int],
    mode: str,
    apply_fill: bool,
) -> torch.Tensor:
    """One rank's output slab from its halo-extended input slab.

    Args:
        ext: (b, C, I, jl + 2 halo, K) slab: the rank's rows with ``halo``
            rows from each neighbour (zeros past the global ends).
        planes: per element, the three (I, jl, K) float32 input-voxel
            coordinates of its output rows in the GLOBAL frame
            (:func:`spec_planes`).
        fill_rows: (b, C) float32 out-of-bounds fill.
        j0: the slab's first global J row; ``spatial`` the global
            (I, J, K).

    Returns (b, C, I, jl, K) float32: one launch of the dense-coordinate
    kernel for the slab's batch rows on a card.
    """
    # the J shift into the extended slab: every globally in-bounds point
    # lies inside it (the host bounds the halo), and a globally
    # out-of-bounds corner reads the zero halo or leaves the slab
    shift = float(halo - j0)
    coords = torch.stack([torch.stack((ci, cj + shift, ck), dim=-1) for ci, cj, ck in planes])
    out = resample(ext, coords, mode=mode, fill=0.0)
    if apply_fill:
        w = torch.stack([_inbounds_weight(*p, spatial) for p in planes])
        out = torch.where(w[:, None] > 0.5, out, fill_rows[:, :, None, None, None])
    return out


def _halo_width(maps: np.ndarray, stacked_cps, si: int, sj: int, sk: int) -> int:
    """The largest |j_in - j_out| over the output box (an affine map's
    extremes are at its corners) plus the elastic J displacement bound,
    plus 2 voxels of interpolation slack."""
    corners = _box_corners(si, sj, sk)
    reach = 0.0
    for m in maps:
        j_in = corners @ m[1, :3] + m[1, 3]
        reach = max(reach, float(np.abs(j_in - corners[:, 1]).max()))
    if stacked_cps is not None:
        reach += float(np.abs(stacked_cps[..., 1]).max())
    return int(np.ceil(reach)) + 2


def _fill_rows(fill, b: int, c: int, rows: slice, device) -> tuple[torch.Tensor, bool]:
    """This rank's (b, C) float32 fill rows and whether a fill applies: a
    DTensor fill holds each rank's rows already; any other tensor applies
    and is broadcast to (B, C); a host scalar 0 applies none."""
    if is_dtensor(fill):
        local = fill.to_local().to(device=device, dtype=torch.float32)
        return local.reshape(local.shape[0], -1).expand(-1, c).contiguous(), True
    if isinstance(fill, torch.Tensor):
        f = fill.to(device=device, dtype=torch.float32)
        f = f if f.ndim == 2 else f.reshape(1, -1)
        return f.expand(b, c)[rows].contiguous(), True
    arr = np.asarray(fill, np.float32)
    apply_fill = not (arr.size == 1 and float(arr.reshape(-1)[0]) == 0.0)
    arr = arr if arr.ndim == 2 else arr.reshape(1, -1)
    full = np.broadcast_to(arr, (b, c)).astype(np.float32)
    return torch.as_tensor(full[rows], device=device), apply_fill


def _resample_on_mesh(x, ms, cps, fill, sharding, data_ax, space_ax, halo, mode):
    mesh = sharding.mesh
    b, c, si, sj, sk = x.shape
    jl = sj // axis_size(mesh, space_ax)
    bl = b // axis_size(mesh, data_ax) if data_ax is not None else b
    b0 = axis_index(mesh, data_ax) * bl if data_ax is not None else 0
    j0 = axis_index(mesh, space_ax) * jl
    rows = slice(b0, b0 + bl)
    device = mesh_device(mesh)
    xs = _local_of(x, sharding).to(torch.float32)
    fill_rows, apply_fill = _fill_rows(fill, b, c, rows, device)
    planes = spec_planes(
        torch.as_tensor(ms[rows].astype(np.float32), device=device),
        None if cps is None else torch.as_tensor(cps[rows], device=device),
        j0=j0,
        jl=jl,
        spatial=(si, sj, sk),
    )
    ext = _exchange_halo_zero(xs, halo, mesh.get_group(space_ax))
    out = halo_resample_local(
        ext, planes, fill_rows, j0=j0, halo=halo, spatial=(si, sj, sk), mode=mode,
        apply_fill=apply_fill,
    )
    return from_local(out, sharding, x.shape)


def halo_resample_affine(x, matrix, mesh, *, mode: str = "linear"):
    """Affine-resample a volume SHARDED along J without gathering it.

    Each rank computes its slab of the output from its own input slab
    plus a ``halo``-wide neighbour exchange, the halo being the map's
    largest J displacement over the volume's box (host-computed). Zero
    halos at the global ends reproduce ``grid_sample(padding_mode=
    "zeros")``, so the result equals the unsharded
    :func:`torchio_tpu_torch.ops.resample.resample` at a zero fill.

    Args:
        x: (B, C, I, J, K) sharded (B -> data axis, J -> space axis).
        matrix: 4x4 output-voxel -> input-voxel map; output space equals
            input space (augmentation-style affine; fill = 0).
        mesh: the (data, space) mesh.
        mode: "linear" or "nearest".

    Returns:
        (B, C, I, J, K) DTensor with the same sharding.
    """
    m = np.asarray(matrix, np.float64)
    b, c, si, sj, sk = x.shape
    data_ax, space_ax = mesh.mesh_dim_names
    n_space = axis_size(mesh, space_ax)
    if sj % n_space:
        raise ValueError(f"J={sj} not divisible by space={n_space}")
    jl = sj // n_space
    halo = _halo_width(m[None], None, si, sj, sk)
    if halo >= jl:
        raise HaloUnsupported(
            f"Halo {halo} exceeds the local shard width {jl}; use fewer"
            " space shards or an unsharded resample for this transform."
        )
    sharding = NamedSharding(mesh, (data_ax, None, None, space_ax, None))
    ms = np.broadcast_to(m, (b, 4, 4))
    return _resample_on_mesh(x, ms, None, 0.0, sharding, data_ax, space_ax, halo, mode)


def halo_resample_spec(
    x,
    matrices,
    control_points,
    *,
    sharding,
    mode: str = "linear",
    fill=0.0,
):
    """Resample a J-sharded (B, C, I, J, K) batch from per-element grid
    specs WITHOUT ever gathering the whole volume onto one rank.

    Per-element 4x4 maps and pre-folded elastic control points (the specs
    :func:`torchio_tpu_torch.ops.resample.resample_fused` takes); each rank
    computes its output slab from its own input slab plus a halo-wide
    neighbour exchange. Output space must equal input space
    (augmentation-style maps). ``fill`` is a host scalar, (C,) or (B, C),
    a tensor (always applied), or a (B, C) DTensor of each rank's rows.

    Raises:
        HaloUnsupported: the J displacement exceeds the shard width, J or
            B does not divide over the mesh, or the control-point fields
            are not stackable -- callers fall back to the gather path.
    """
    if not isinstance(sharding, NamedSharding):
        raise HaloUnsupported(f"need a NamedSharding, got {type(sharding)}")
    mesh = sharding.mesh
    spec = sharding.spec
    padded = sharding.padded()
    data_ax, space_ax = padded[0], padded[3]
    if space_ax is None:
        raise HaloUnsupported("batch is not spatially sharded")
    if padded[1] is not None or padded[2] is not None or padded[4] is not None:
        raise HaloUnsupported(f"unsupported partition spec {spec}")
    b, c, si, sj, sk = x.shape
    n_space = axis_size(mesh, space_ax)
    if sj % n_space:
        raise HaloUnsupported(f"J={sj} not divisible by space={n_space}")
    jl = sj // n_space
    if data_ax is not None and b % axis_size(mesh, data_ax):
        raise HaloUnsupported(f"B={b} not divisible by data={axis_size(mesh, data_ax)}")

    ms = np.stack([np.asarray(m, np.float64) for m in matrices])
    if ms.shape != (b, 4, 4):
        raise HaloUnsupported(f"need {b} 4x4 matrices, got {ms.shape}")
    cps = None
    if any(cp is not None for cp in control_points):
        shapes = {tuple(np.asarray(cp).shape) for cp in control_points if cp is not None}
        if len(shapes) != 1:
            raise HaloUnsupported(f"control-point fields differ: {shapes}")
        cps = np.zeros((b, *shapes.pop()), np.float32)
        for e, cp in enumerate(control_points):
            if cp is not None:
                cps[e] = np.asarray(cp, np.float32)
    halo = _halo_width(ms, cps, si, sj, sk)
    if halo >= jl:
        raise HaloUnsupported(
            f"halo {halo} >= local shard width {jl}; fall back to the unsharded resample"
        )
    return _resample_on_mesh(x, ms, cps, fill, sharding, data_ax, space_ax, halo, mode)
