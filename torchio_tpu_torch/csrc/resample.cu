// Trilinear / nearest resample of a (B, C, I, J, K) float32 batch, for
// NVIDIA Hopper (sm_90a), at sample points from per-element grid specs
// (tio_resample) or from a dense coordinate tensor (tio_resample_coords).
//
// Replaces the TPU kernels of the JAX package's resample path, in their
// linear and nearest modes:
//   - torchio_tpu/ops/shear_resample.py  _kernel2       (the resample)
//   - torchio_tpu/ops/shear_resample.py  _shear_kernel  (its integer
//     row pre-shear; folded in: this kernel reads source voxels directly)
//   - torchio_tpu/ops/window_resample.py _kernel        (bounded-offset
//     elastic maps with K <= 128)
//   - torchio_tpu/ops/pallas_resample.py _kernel_body   (dense
//     coordinates, through resample_tiles / pallas_resample; the dense
//     mode below)
// The TPU needs the pre-shear, the 128-lane gathers, the candidate loops,
// the per-tile bounds and the host tile plans (plan_tiles: an input box
// per (8, 8, 128) output tile, DMA'd to VMEM and contracted with triangle
// weights on the MXU) because it has no fast gather. Hopper has one, so
// the whole family is one gather kernel.
//
// What each output voxel (b, io, jo, ko) computes:
//   1. the sample point: from the grid spec (the affine map summed
//      ((i m0 + j m1) + k m2) + m3, plus the coarse elastic field upsampled
//      by lerps over i, then j, then k: the JAX package's operation
//      order), or read from the coordinate tensor (batch stride 0 for a
//      grid shared by the batch);
//   2. the 8 trilinear corner weights (zero for corners outside the
//      volume), or the rounded corner in nearest mode (rintf: half to
//      even, like jnp.round);
//   3. per channel, acc = acc + v * w over the 8 corners in order, at
//      clamped indices (a zero weight adds 0, as in the plain version);
//      where the summed in-bounds weight is <= 0.5 the voxel takes
//      fill[b, c] (also in nearest mode), unless apply_fill is 0 (a zero
//      scalar fill keeps the boundary's partial sums).
// The file is built with -fmad=false (see sample_point.cuh), so every
// coordinate and sum rounds as in the plain version: the outputs are
// bit-identical to it.
//
// What bounded the first form of this kernel on an H100 (one thread per
// output voxel, a 1-D grid-stride loop over the flat (B, Io, Jo, Ko)
// index) was not device-memory bytes: at B=4 x 256^3, linear with an
// elastic field, it moved 537 MB in 1.835 ms, 8.7 % of its bytes bound,
// slower than the dense mode moving 1.34 GB. Per voxel it split the flat
// index with four 64-bit divisions (software routines on the GPU),
// recomputed the whole field upsample (24 field loads, 21 lerps) and the
// 3x4 map, and branched on each corner: about 450 instructions a voxel.
//
// The design now (each step measured by probes/resample_layout.py; its
// numbers are in PERF.md):
//   - row tiles (row_tiles.cuh, shared with label_resample.cu): a warp
//     owns one output row, from a 3-D launch grid with 32-bit arithmetic,
//     and what the row shares (the map's i m0 + j m1, the field's row
//     lerps in shared memory) is computed once a row, so a voxel keeps
//     only its k-lerp;
//   - offsets inside one (b, c) volume are 32-bit where I*J*K < 2^31 (a
//     template parameter; 64-bit otherwise), each corner load one 32-bit
//     offset scaled onto the (b, c) base;
//   - a lane takes its voxels one at a time, so the kernel fits 64
//     registers and 32 warps an SM: holding a lane's four voxels at once
//     (with 16-byte stores and coordinate loads) needed 128-188 registers
//     and lost, from 8 or 16 warps an SM. From grid specs a warp's lanes
//     sit on consecutive ko (each corner load of the warp spans the
//     fewest rows); on dense coordinates a lane's voxels are consecutive
//     (its 48 bytes of coordinates one run).
// What bounds it now is the latency of the corner gathers: each lane has
// one voxel's 8 loads in flight, and 32 warps an SM hide their L1/L2
// round trips only in part (0.77 ms against 0.16 ms of bytes at B=4 x
// 256^3 from grid specs; the dense mode on the same points takes as
// long, so the sample points no longer cost time of their own).
//
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "row_tiles.cuh"

namespace {

using tio::clamp_index;
using tio::Grid;
using tio::kLanes;
using tio::kVec;
using tio::ko_of;
using tio::Launch;
using tio::opaque;
using tio::Row;
using tio::Source;

// One voxel's corners: weights, clamped offsets, and whether it takes
// the fill.
template <typename Index>
struct Corners {
  float w[8];     // trilinear weights, zero outside the volume
  Index row[4];   // (i, j) row offsets of corner pairs di * 2 + dj
  Index k[2];     // k of corners dk = 0, 1
  Index nearest;  // the rounded corner, clamped into the volume
  bool valid;     // the rounded corner lies inside the volume
  bool fill;      // the voxel takes the fill (and loads nothing)
};

template <bool kNearest, typename Index>
__device__ __forceinline__ void corners_of(float c[3], const Grid& s, int apply_fill,
                                           Corners<Index>& q) {
  // size-1 axes: every coordinate maps to index 0 with full weight
  if (s.I == 1) c[0] = 0.0f;
  if (s.J == 1) c[1] = 0.0f;
  if (s.K == 1) c[2] = 0.0f;
  float wi[2], wj[2], wk[2];
  const int i0 = tio::axis_weights(c[0], s.I, wi[0], wi[1]);
  const int j0 = tio::axis_weights(c[1], s.J, wj[0], wj[1]);
  const int k0 = tio::axis_weights(c[2], s.K, wk[0], wk[1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) q.w[n] = wi[n >> 2] * wj[(n >> 1) & 1] * wk[n & 1];
  q.fill = false;
  if (apply_fill) {
    float inbounds = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) inbounds = inbounds + q.w[n];
    q.fill = !(inbounds > 0.5f);
  }
  const Index jk = (Index)s.J * s.K;
  const Index ii[2] = {clamp_index(i0, s.I), clamp_index(i0 + 1, s.I)};
  const Index jj[2] = {clamp_index(j0, s.J), clamp_index(j0 + 1, s.J)};
#pragma unroll
  for (int n = 0; n < 4; ++n) q.row[n] = ii[n >> 1] * jk + jj[n & 1] * (Index)s.K;
  q.k[0] = clamp_index(k0, s.K);
  q.k[1] = clamp_index(k0 + 1, s.K);
  if (kNearest) {
    const int ri = (int)rintf(c[0]), rj = (int)rintf(c[1]), rk = (int)rintf(c[2]);
    q.valid = ri >= 0 && ri < s.I && rj >= 0 && rj < s.J && rk >= 0 && rk < s.K;
    q.nearest = (Index)clamp_index(ri, s.I) * jk + (Index)clamp_index(rj, s.J) * s.K +
                clamp_index(rk, s.K);
  }
}

template <bool kNearest, typename Index>
__device__ __forceinline__ float corner_sum(const float* __restrict__ src,
                                            const Corners<Index>& q, float fill) {
  if (q.fill) return fill;
  if (kNearest) {
    const float x = __ldg(src + q.nearest);
    return q.valid ? x : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc = acc + __ldg(src + (q.row[n >> 1] + q.k[n & 1])) * q.w[n];
  return acc;
}

// A lane's kVec voxels of the k tile from k_first, one at a time: its
// point, its corners, and per channel its sum and store.
template <bool kNearest, Source kSource, bool kStaged, typename Index, class L>
__device__ __forceinline__ void tile_voxels(const float* __restrict__ vol,
                                            const tio::Points& pts,
                                            const float* __restrict__ fill,
                                            float* __restrict__ out, const Grid& s,
                                            const Row<kSource, kStaged>& row,
                                            unsigned k_first, unsigned lane, int apply_fill) {
  const int64_t in_spatial = tio::in_spatial(s), out_spatial = tio::out_spatial(s);
  const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
#pragma unroll 1
  for (int v = 0; v < kVec; ++v) {
    const unsigned ko = ko_of<L>(k_first, lane, v);
    if (ko >= (unsigned)s.Ko) break;  // the later voxels lie further on
    float c[3];
    row.point(pts, s, ko, c);
    Corners<Index> q;
    corners_of<kNearest>(c, s, apply_fill, q);
    for (int ch = 0; ch < s.C; ++ch) {
      const int64_t bc = (int64_t)row.b * s.C + ch;
      const float* src = opaque(vol + bc * in_spatial);
      opaque(out + bc * out_spatial + row_out)[ko] =
          corner_sum<kNearest>(src, q, __ldg(fill + bc));
    }
  }
}

// How a lane takes its kVec voxels of a k tile: one at a time
// (tile_voxels), on kVec consecutive ko (kConsecutive) or one every
// kLanes (a warp's lanes on consecutive ko); kMinBlocks blocks an SM for
// __launch_bounds__ (at 4, 64 registers a thread). The kernel calls
// L::tile, so a layout may bring another way to take them
// (probes/resample_layout.cu does).
template <bool kConsecutive_, int kMinBlocks_>
struct Layout {
  static constexpr bool kConsecutive = kConsecutive_;
  static constexpr int kMinBlocks = kMinBlocks_;

  template <bool kNearest, Source kSource, bool kStaged, typename Index>
  __device__ __forceinline__ static void tile(const float* __restrict__ vol,
                                              const tio::Points& pts,
                                              const float* __restrict__ fill,
                                              float* __restrict__ out, const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane,
                                              int apply_fill) {
    tile_voxels<kNearest, kSource, kStaged, Index, Layout>(vol, pts, fill, out, s, row,
                                                           k_first, lane, apply_fill);
  }
};

// The resample as row_tiles.cuh's Body: a lane's voxels of a k tile are
// the layout L's tile.
struct ResampleArgs {
  const float* __restrict__ vol;
  const float* __restrict__ fill;
  float* __restrict__ out;
  int apply_fill;
};

template <bool kNearest, typename Index, class L>
struct Resample {
  using Args = ResampleArgs;
  static constexpr int kMinBlocks = L::kMinBlocks;

  template <Source kSource, bool kStaged>
  __device__ __forceinline__ static void tile(const Args& a, const tio::Points& pts,
                                              const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane) {
    L::template tile<kNearest, kSource, kStaged, Index>(a.vol, pts, a.fill, a.out, s, row,
                                                        k_first, lane, a.apply_fill);
  }
};

template <bool kNearest, Source kSource, typename Index, class L>
void launch_as(const float* vol, const tio::Points& pts, const float* fill, float* out,
               const Grid& s, const Launch& l, int apply_fill, cudaStream_t stream) {
  tio::launch_rows<Resample<kNearest, Index, L>, kSource>({vol, fill, out, apply_fill}, pts,
                                                          s, l, stream);
}

template <Source kSource, class L>
void launch(const float* vol, const tio::Points& pts, const float* fill, float* out,
            const Grid& s, const Launch& l, int nearest, int apply_fill,
            cudaStream_t stream) {
  if (nearest) {
    if (l.wide) {
      launch_as<true, kSource, int64_t, L>(vol, pts, fill, out, s, l, apply_fill, stream);
    } else {
      launch_as<true, kSource, int, L>(vol, pts, fill, out, s, l, apply_fill, stream);
    }
  } else if (l.wide) {
    launch_as<false, kSource, int64_t, L>(vol, pts, fill, out, s, l, apply_fill, stream);
  } else {
    launch_as<false, kSource, int, L>(vol, pts, fill, out, s, l, apply_fill, stream);
  }
}

// The layout of each mode (see Layout).
using GridLayout = Layout<false, 4>;
using DenseLayout = Layout<true, 4>;

}  // namespace

extern "C" int tio_resample(const float* vol, const float* maps,
                            const float* fields, const float* fill, float* out,
                            int B, int C, int I, int J, int K, int Io, int Jo,
                            int Ko, int ni, int nj, int nk, float ri, float rj,
                            float rk, int nearest, int apply_fill, int gx, int gy,
                            int gz, int z_rows, int wide, int field_smem,
                            void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide,
                 field_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    launch<Source::kMapField, GridLayout>(vol, pts, fill, out, s, l, nearest, apply_fill, st);
  } else {
    launch<Source::kMap, GridLayout>(vol, pts, fill, out, s, l, nearest, apply_fill, st);
  }
  return (int)cudaGetLastError();
}

// coords: (B or 1, Io, Jo, Ko, 3) float32; coord_batch_stride is
// Io*Jo*Ko*3 for per-element grids and 0 for one shared grid.
extern "C" int tio_resample_coords(const float* vol, const float* coords,
                                   const float* fill, float* out, int B, int C,
                                   int I, int J, int K, int Io, int Jo, int Ko,
                                   long long coord_batch_stride, int nearest,
                                   int apply_fill, int gx, int gy, int gz,
                                   int z_rows, int wide, void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide, 0};
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  launch<Source::kDense, DenseLayout>(vol, pts, fill, out, s, l, nearest, apply_fill,
                                      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
