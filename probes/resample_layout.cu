// Probe: the row-tiled trilinear resample kernels of
// torchio_tpu_torch/csrc/resample.cu beside the kernel they replaced (one
// thread per output voxel over the flat (B, Io, Jo, Ko) index, 64-bit
// index division, the whole sample point a voxel, a branch per corner;
// its body kept here as it was), and the row-tiled kernel in other
// layouts: a lane's voxels on consecutive or warp-strided ko, taken one
// at a time (resample.cu's Layout), held at once with 16-byte stores and
// coordinate loads (Held), unrolled (Unrolled) or with shuffled corner
// pairs (Shuffled), at 1-4 blocks an SM. Built and timed by
// probes/resample_layout.py.

#include "../torchio_tpu_torch/csrc/resample.cu"

namespace {

template <bool kNearest, Source kSource>
__global__ void __launch_bounds__(tio::kThreads)
    flat_resample_kernel(const float* __restrict__ vol, tio::Points pts,
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
void flat_launch(const float* vol, const tio::Points& pts, const float* fill, float* out,
                 const Grid& s, int nearest, int apply_fill, cudaStream_t stream) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  if (nearest) {
    flat_resample_kernel<true, kSource>
        <<<grid, tio::kThreads, 0, stream>>>(vol, pts, fill, out, s, apply_fill);
  } else {
    flat_resample_kernel<false, kSource>
        <<<grid, tio::kThreads, 0, stream>>>(vol, pts, fill, out, s, apply_fill);
  }
}

}  // namespace

// The replaced kernel: grid specs (fields may be null) or, with coords
// non-null, dense coordinates.
extern "C" int probe_resample_flat(const float* vol, const float* maps, const float* fields,
                                   const float* coords, long long coord_batch_stride,
                                   const float* fill, float* out, int B, int C, int I, int J,
                                   int K, int Io, int Jo, int Ko, int ni, int nj, int nk,
                                   float ri, float rj, float rk, int nearest, int apply_fill,
                                   void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, coords, (int64_t)coord_batch_stride};
  if (coords != nullptr) {
    flat_launch<Source::kDense>(vol, pts, fill, out, s, nearest, apply_fill, st);
  } else if (fields != nullptr) {
    flat_launch<Source::kMapField>(vol, pts, fill, out, s, nearest, apply_fill, st);
  } else {
    flat_launch<Source::kMap>(vol, pts, fill, out, s, nearest, apply_fill, st);
  }
  return (int)cudaGetLastError();
}

// Other ways for a lane to take its kVec voxels of a k tile, as layouts
// of resample.cu's kernel (each brings its tile function).

// Every voxel of the lane held at once: the points (the dense mode's
// twelve coordinates as three 16-byte loads where aligned), the corners,
// then per channel the kVec sums and, kConsecutive and aligned, one
// 16-byte store.
template <bool kConsecutive_, int kMinBlocks_>
struct Held {
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
    const unsigned ko0 = ko_of<Held>(k_first, lane, 0);
    const bool whole = kConsecutive && ko0 + kVec <= (unsigned)s.Ko;
    float c[kVec][3];
    if (kSource == Source::kDense && whole &&
        (reinterpret_cast<uintptr_t>(row.coords + (size_t)ko0 * 3) & 15) == 0) {
      const float4* q4 = reinterpret_cast<const float4*>(row.coords + (size_t)ko0 * 3);
      const float4 x = __ldg(q4), y = __ldg(q4 + 1), z = __ldg(q4 + 2);
      c[0][0] = x.x, c[0][1] = x.y, c[0][2] = x.z;
      c[1][0] = x.w, c[1][1] = y.x, c[1][2] = y.y;
      c[2][0] = y.z, c[2][1] = y.w, c[2][2] = z.x;
      c[3][0] = z.y, c[3][1] = z.z, c[3][2] = z.w;
    } else {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const unsigned ko = ko_of<Held>(k_first, lane, v);
        if (kSource != Source::kDense || ko < (unsigned)s.Ko) {
          row.point(pts, s, ko, c[v]);
        } else {
          c[v][0] = c[v][1] = c[v][2] = 0.0f;
        }
      }
    }
    Corners<Index> q[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      corners_of<kNearest>(c[v], s, apply_fill, q[v]);
      q[v].fill = q[v].fill || ko_of<Held>(k_first, lane, v) >= (unsigned)s.Ko;
    }
    const int64_t in_spatial = tio::in_spatial(s), out_spatial = tio::out_spatial(s);
    const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
    for (int ch = 0; ch < s.C; ++ch) {
      const int64_t bc = (int64_t)row.b * s.C + ch;
      const float* src = opaque(vol + bc * in_spatial);
      const float fv = __ldg(fill + bc);
      float acc[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = corner_sum<kNearest>(src, q[v], fv);
      float* dst = opaque(out + bc * out_spatial + row_out);
      if (whole && (reinterpret_cast<uintptr_t>(dst + ko0) & 15) == 0) {
        *reinterpret_cast<float4*>(dst + ko0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const unsigned ko = ko_of<Held>(k_first, lane, v);
          if (ko < (unsigned)s.Ko) dst[ko] = acc[v];
        }
      }
    }
  }
};

// One voxel at a time, the loop unrolled kUnroll times.
template <bool kConsecutive_, int kMinBlocks_, int kUnroll>
struct Unrolled {
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
    const int64_t in_spatial = tio::in_spatial(s), out_spatial = tio::out_spatial(s);
    const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
#pragma unroll(kUnroll)
    for (int v = 0; v < kVec; ++v) {
      const unsigned ko = ko_of<Unrolled>(k_first, lane, v);
      if (ko >= (unsigned)s.Ko) break;
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
};

// One voxel at a time, a warp's lanes on consecutive ko: the dk = 1
// corner of a lane is, more often than not, the dk = 0 corner of the
// next lane (the same (i, j) row, k one further on), so the lane takes
// that value by a shuffle and loads only where it is not (the same values
// in the same order). Every lane of the warp takes part in every voxel.
template <int kMinBlocks_>
struct Shuffled {
  static constexpr bool kConsecutive = false;
  static constexpr int kMinBlocks = kMinBlocks_;

  template <typename Index>
  __device__ __forceinline__ static float sum(const float* __restrict__ src,
                                              const Corners<Index>& q, float fill,
                                              unsigned lane) {
    float acc = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const Index a0 = q.row[n] + q.k[0], a1 = q.row[n] + q.k[1];
      const float v0 = __ldg(src + a0);
      const Index next_a0 = __shfl_down_sync(0xffffffffu, a0, 1);
      const float next_v0 = __shfl_down_sync(0xffffffffu, v0, 1);
      const float v1 = (lane + 1 < kLanes && next_a0 == a1) ? next_v0 : __ldg(src + a1);
      acc = acc + v0 * q.w[2 * n];
      acc = acc + v1 * q.w[2 * n + 1];
    }
    return q.fill ? fill : acc;
  }

  template <bool kNearest, Source kSource, bool kStaged, typename Index>
  __device__ __forceinline__ static void tile(const float* __restrict__ vol,
                                              const tio::Points& pts,
                                              const float* __restrict__ fill,
                                              float* __restrict__ out, const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane,
                                              int apply_fill) {
    static_assert(!kNearest, "the probe times the linear mode");
    const int64_t in_spatial = tio::in_spatial(s), out_spatial = tio::out_spatial(s);
    const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
#pragma unroll 1
    for (int v = 0; v < kVec; ++v) {
      const unsigned ko = ko_of<Shuffled>(k_first, lane, v);
      const bool live = ko < (unsigned)s.Ko;
      if (__all_sync(0xffffffffu, !live)) break;
      float c[3];
      if (kSource != Source::kDense || live) {
        row.point(pts, s, ko, c);
      } else {
        c[0] = c[1] = c[2] = 0.0f;
      }
      Corners<Index> q;
      corners_of<false>(c, s, apply_fill, q);
      q.fill = q.fill || !live;
      for (int ch = 0; ch < s.C; ++ch) {
        const int64_t bc = (int64_t)row.b * s.C + ch;
        const float* src = opaque(vol + bc * in_spatial);
        const float acc = sum(src, q, __ldg(fill + bc), lane);
        if (live) opaque(out + bc * out_spatial + row_out)[ko] = acc;
      }
    }
  }
};

// The row-tiled kernel, linear, on dense coordinates or grid specs with
// a field, in one of the layouts below (variant 0-10), or (variant -1) as
// the package launches it; the same arguments and launch plan as
// tio_resample / tio_resample_coords (any grid x from 1 to the k tiles
// serves every voxel: a block loops over its k tiles).
template <class L>
void rows_as(const float* vol, const tio::Points& pts, const float* fill, float* out,
             const Grid& s, const Launch& l, int apply_fill, cudaStream_t st) {
  if (pts.coords != nullptr) {
    launch_as<false, Source::kDense, int, L>(vol, pts, fill, out, s, l, apply_fill, st);
  } else {
    launch_as<false, Source::kMapField, int, L>(vol, pts, fill, out, s, l, apply_fill, st);
  }
}

extern "C" int probe_resample_rows(const float* vol, const float* maps, const float* fields,
                                   const float* coords, long long coord_batch_stride,
                                   const float* fill, float* out, int B, int C, int I, int J,
                                   int K, int Io, int Jo, int Ko, int ni, int nj, int nk,
                                   float ri, float rj, float rk, int nearest, int apply_fill,
                                   int gx, int gy, int gz, int z_rows, int wide,
                                   int field_smem, int variant, void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide,
                 field_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, coords, (int64_t)coord_batch_stride};
  switch (variant) {
    case -1:
      if (coords != nullptr) {
        launch<Source::kDense, DenseLayout>(vol, pts, fill, out, s, l, nearest, apply_fill, st);
      } else if (fields != nullptr) {
        launch<Source::kMapField, GridLayout>(vol, pts, fill, out, s, l, nearest, apply_fill, st);
      } else {
        launch<Source::kMap, GridLayout>(vol, pts, fill, out, s, l, nearest, apply_fill, st);
      }
      break;
    case 0: rows_as<Held<true, 1>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 1: rows_as<Held<true, 2>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 2: rows_as<Held<false, 2>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 3: rows_as<Layout<false, 4>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 4: rows_as<Layout<true, 4>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 5: rows_as<Layout<false, 3>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 6: rows_as<Layout<true, 3>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 7: rows_as<Layout<false, 2>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 8: rows_as<Unrolled<false, 4, 2>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 9: rows_as<Unrolled<true, 4, 2>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    case 10: rows_as<Shuffled<4>>(vol, pts, fill, out, s, l, apply_fill, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
