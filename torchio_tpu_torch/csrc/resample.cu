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
// One thread per output voxel (b, io, jo, ko), ko fastest:
//   1. the sample point: from the grid spec (sample_point.cuh: affine map
//      plus upsampled elastic field, in the JAX package's operation
//      order), or read from the coordinate tensor (batch stride 0 for a
//      grid shared by the batch);
//   2. the 8 trilinear corner weights (zero for corners outside the
//      volume), or the rounded corner in nearest mode (rintf: half to
//      even, like jnp.round);
//   3. the same weights for every channel; where the summed in-bounds
//      weight is <= 0.5 the voxel takes fill[b, c] (also in nearest
//      mode), unless apply_fill is 0 (a zero scalar fill keeps the
//      boundary's partial sums).
// The file is built with -fmad=false (see sample_point.cuh).
//
// What bounds it on an H100: device-memory bytes. Per output voxel and
// channel it writes one float and reads the source neighbourhood once
// from device memory; the other corner reads of neighbouring threads hit
// L1/L2, since neighbouring output voxels sample neighbouring input
// voxels under the near-identity maps of augmentation. The dense mode
// also reads 12 bytes of coordinates per voxel (a warp reads 384
// contiguous bytes), as much again as a one-channel output. No
// tensor-core work applies. One thread per voxel with cached corner
// reads is the simple, correct first form; tiling the source into shared
// memory with TMA and vectorising along k are later work.
//
// Offsets are 64-bit: B*C*I*J*K and B*Io*Jo*Ko*3 pass 2^31 at realistic
// sizes. Launches go on the caller's stream, allocate nothing, and
// return cudaGetLastError().

#include "sample_point.cuh"

namespace {

using tio::Grid;
using tio::kThreads;
using tio::Source;

template <bool kNearest, Source kSource>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ vol, tio::Points pts,
                    const float* __restrict__ fill, float* __restrict__ out,
                    Grid s, int apply_fill) {
  const int64_t out_spatial = tio::out_spatial(s);
  const int64_t in_spatial = tio::in_spatial(s);
  const int64_t total = (int64_t)s.B * out_spatial;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const tio::Voxel p = tio::voxel_of(v, s);
    const int b = p.b;
    float c[3];
    tio::point_of<kSource>(pts, s, p, c);
    // size-1 axes: every coordinate maps to index 0 with full weight
    if (s.I == 1) c[0] = 0.0f;
    if (s.J == 1) c[1] = 0.0f;
    if (s.K == 1) c[2] = 0.0f;

    float wi[2], wj[2], wk[2];
    const int i0 = tio::axis_weights(c[0], s.I, wi[0], wi[1]);
    const int j0 = tio::axis_weights(c[1], s.J, wj[0], wj[1]);
    const int k0 = tio::axis_weights(c[2], s.K, wk[0], wk[1]);
    float w[8];
    int64_t offset[8];
    float inbounds = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int di = q >> 2, dj = (q >> 1) & 1, dk = q & 1;
      w[q] = wi[di] * wj[dj] * wk[dk];
      inbounds = inbounds + w[q];
      offset[q] = ((int64_t)(i0 + di) * s.J + (j0 + dj)) * s.K + (k0 + dk);
    }
    int64_t nearest = -1;
    if (kNearest) {
      const int ri = (int)rintf(c[0]), rj = (int)rintf(c[1]), rk = (int)rintf(c[2]);
      if (ri >= 0 && ri < s.I && rj >= 0 && rj < s.J && rk >= 0 && rk < s.K) {
        nearest = ((int64_t)ri * s.J + rj) * s.K + rk;
      }
    }
    const bool use_fill = apply_fill && !(inbounds > 0.5f);
    const int64_t out_base = (int64_t)b * s.C * out_spatial + (v - (int64_t)b * out_spatial);
    for (int ch = 0; ch < s.C; ++ch) {
      const float* src = vol + ((int64_t)b * s.C + ch) * in_spatial;
      float acc = 0.0f;
      if (use_fill) {
        acc = __ldg(fill + (int64_t)b * s.C + ch);
      } else if (kNearest) {
        acc = nearest >= 0 ? __ldg(src + nearest) : 0.0f;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (w[q] != 0.0f) acc = acc + __ldg(src + offset[q]) * w[q];
        }
      }
      out[out_base + (int64_t)ch * out_spatial] = acc;
    }
  }
}

template <Source kSource>
void launch(const float* vol, const tio::Points& pts, const float* fill, float* out,
            const Grid& s, int nearest, int apply_fill, cudaStream_t stream) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  if (nearest) {
    resample_kernel<true, kSource><<<grid, kThreads, 0, stream>>>(vol, pts, fill, out, s,
                                                                  apply_fill);
  } else {
    resample_kernel<false, kSource><<<grid, kThreads, 0, stream>>>(vol, pts, fill, out, s,
                                                                   apply_fill);
  }
}

}  // namespace

extern "C" int tio_resample(const float* vol, const float* maps,
                            const float* fields, const float* fill, float* out,
                            int B, int C, int I, int J, int K, int Io, int Jo,
                            int Ko, int ni, int nj, int nk, float ri, float rj,
                            float rk, int nearest, int apply_fill,
                            void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    launch<Source::kMapField>(vol, pts, fill, out, s, nearest, apply_fill, st);
  } else {
    launch<Source::kMap>(vol, pts, fill, out, s, nearest, apply_fill, st);
  }
  return (int)cudaGetLastError();
}

// coords: (B or 1, Io, Jo, Ko, 3) float32; coord_batch_stride is
// Io*Jo*Ko*3 for per-element grids and 0 for one shared grid.
extern "C" int tio_resample_coords(const float* vol, const float* coords,
                                   const float* fill, float* out, int B, int C,
                                   int I, int J, int K, int Io, int Jo, int Ko,
                                   long long coord_batch_stride, int nearest,
                                   int apply_fill, void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  launch<Source::kDense>(vol, pts, fill, out, s, nearest, apply_fill,
                         static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
