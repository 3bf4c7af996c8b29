// Probe: the dense-coordinate spline kernel of
// torchio_tpu_torch/csrc/bspline.cu (SplineCoords on row_tiles.cuh's row
// tiles) beside the kernel it replaced and the forms it was chosen from,
// at order 3 on one channel. Built and timed by
// probes/spline_coords_layout.py.
//
// - old: the dense kernel before the row form, which is the grid-spec
//   kernel's body (spline_kernel, unchanged in bspline.cu) on dense
//   points: one thread per output voxel over the flat (B, Io, Jo, Ko)
//   index, four 64-bit divisions a voxel, 64-bit tap addresses, each k
//   tap one scalar load;
// - rows: SplineCoords in a CoordsLayout: a lane's voxels on consecutive
//   or warp-strided ko, 2-4 blocks an SM, each k tap one scalar load;
//   32-bit offsets, or 64-bit ones (an ablation);
// - interior: the same with spline_taps' fast path for coordinates and
//   taps inside the volume (the package's form);
// - windows (WindowsLayout): the k taps of a row that reflect at neither
//   edge read as the aligned float4s that cover them and picked in
//   registers (window_sum); runs (RunsLayout): the same taps as scalar
//   loads at constant offsets from one address;
// - pairs: a lane's consecutive voxels taken two at a time; where the
//   two voxels' (i, j) rows match and their k windows start at most two
//   floats apart, one window of three float4s serves both (a lane's
//   previous k window reused by its next voxel), else each reads its own;
// - box (box_kernel): the strided row form with each block's taps staged
//   in shared memory: for each 32-ko step of its 8 rows, the block
//   reduces its voxels' tap indices to a bounding box, loads the box
//   (row by row, a warp a row) and sums from it; a box past kBoxFloats
//   falls back to the direct loads.

#include <climits>

#include "../torchio_tpu_torch/csrc/bspline.cu"

namespace {

using tio::kLanes;
using tio::kRows;
using tio::kTileK;

// The k-tap sum wk[0] x[0] + ... + wk[T-1] x[T-1] of T consecutive floats
// x from `first`, in that order: the aligned float4s that cover them (two
// at T <= 5, three at T <= 8; a float4 that holds one of the taps never
// crosses a 16-byte boundary, so it never reads an unmapped page), each
// tap picked in registers by the shift of `first` in its float4, in two
// steps of select (odd shifts, then shifts of two).
template <int T>
__device__ __forceinline__ float window_sum(const float* first, const float wk[T]) {
  constexpr int kLoads = (T + 6) / 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(first);
  const float4* q = reinterpret_cast<const float4*>(addr & ~(uintptr_t)15);
  const int shift = (int)(addr >> 2) & 3;
  const int used = (shift + T + 3) >> 2;
  float w[4 * kLoads];
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (l == 0 || l < used) v = __ldg(q + l);
    w[4 * l] = v.x;
    w[4 * l + 1] = v.y;
    w[4 * l + 2] = v.z;
    w[4 * l + 3] = v.w;
  }
  float m[T + 2];
#pragma unroll
  for (int e = 0; e < T + 2; ++e) m[e] = (shift & 1) ? w[e + 1] : w[e];
  float kv = wk[0] * ((shift & 2) ? m[2] : m[0]);
#pragma unroll
  for (int d = 1; d < T; ++d) kv = kv + wk[d] * ((shift & 2) ? m[d + 2] : m[d]);
  return kv;
}

// The k taps of a row are consecutive exactly when none reflects: a
// reflected run turns back, so its ends lie closer than the order (C = 1:
// the probe's forms take one channel).
template <int kOrder, typename Index>
__device__ __forceinline__ bool k_run(const Taps<kOrder + 1, Index>& t) {
  return t.k[kOrder] - t.k[0] == kOrder;
}

// CoordsLayout whose row sums read a voxel's unreflected k taps by
// window_sum, else one scalar load a tap.
template <bool kConsecutive, int kMinBlocks>
struct WindowsLayout : CoordsLayout<kConsecutive, kMinBlocks, false> {
  template <int kOrder, int V, typename Index>
  __device__ __forceinline__ static void sum(const float* src,
                                             const Taps<kOrder + 1, Index>& t, int c0,
                                             float acc[V]) {
    static_assert(V == 1, "windows take one channel");
    if (!k_run<kOrder>(t)) {
      sum_rows<kOrder, V>(src, t, c0, acc);
      return;
    }
#pragma unroll
    for (int a = 0; a <= kOrder; ++a) {
#pragma unroll
      for (int b = 0; b <= kOrder; ++b) {
        const float kv = window_sum<kOrder + 1>(src + (t.i[a] + t.j[b] + t.k[0]), t.wk);
        acc[0] = acc[0] + (t.wi[a] * t.wj[b]) * kv;
      }
    }
  }
};

// CoordsLayout whose row sums read a voxel's unreflected k taps at
// constant offsets from the row's first tap (one address a row), else
// one address a tap.
template <bool kConsecutive, int kMinBlocks, bool kInterior>
struct RunsLayout : CoordsLayout<kConsecutive, kMinBlocks, kInterior> {
  template <int kOrder, int V, typename Index>
  __device__ __forceinline__ static void sum(const float* src,
                                             const Taps<kOrder + 1, Index>& t, int c0,
                                             float acc[V]) {
    static_assert(V == 1, "runs take one channel");
    if (!k_run<kOrder>(t)) {
      sum_rows<kOrder, V>(src, t, c0, acc);
      return;
    }
#pragma unroll
    for (int a = 0; a <= kOrder; ++a) {
#pragma unroll
      for (int b = 0; b <= kOrder; ++b) {
        const float* first = src + (t.i[a] + t.j[b] + t.k[0]);
        float kv = t.wk[0] * __ldg(first);
#pragma unroll
        for (int d = 1; d <= kOrder; ++d) kv = kv + t.wk[d] * __ldg(first + d);
        acc[0] = acc[0] + (t.wi[a] * t.wj[b]) * kv;
      }
    }
  }
};

// wk[0] x[0] + ... + wk[3] x[3] in that order, x[d] = w[shift + d] for a
// shift of 0-7, picked in three steps of select.
__device__ __forceinline__ float pick_sum(const float w[12], int shift, const float wk[4]) {
  float m1[11], m2[9];
#pragma unroll
  for (int e = 0; e < 11; ++e) m1[e] = (shift & 1) ? w[e + 1] : w[e];
#pragma unroll
  for (int e = 0; e < 9; ++e) m2[e] = (shift & 2) ? m1[e + 2] : m1[e];
  float kv = wk[0] * ((shift & 4) ? m2[4] : m2[0]);
#pragma unroll
  for (int d = 1; d < 4; ++d) kv = kv + wk[d] * ((shift & 4) ? m2[d + 4] : m2[d]);
  return kv;
}

template <int kMinBlocks_>
struct PairLayout {
  static constexpr bool kConsecutive = true;
  static constexpr int kMinBlocks = kMinBlocks_;
};

// Cubic, one channel, 32-bit offsets: a lane's voxels two at a time.
template <class L>
struct SplinePairs {
  using Args = CoordsArgs;
  static constexpr int kMinBlocks = L::kMinBlocks;

  template <Source kSource, bool kStaged>
  __device__ __forceinline__ static void tile(const Args& args, const tio::Points& pts,
                                              const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane) {
    constexpr int kOrder = 3, T = 4;
    const int64_t out_spatial = tio::out_spatial(s);
    const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
    const int row_floats = s.K;
    const int plane_floats = s.J * row_floats;
    const float* src = opaque(args.coeffs + (int64_t)row.b * s.I * s.J * s.K);
    const float fill = __ldg(args.fill + row.b);
    float* dst = opaque(args.out + (int64_t)row.b * out_spatial + row_out);
#pragma unroll 1
    for (int v = 0; v < kVec; v += 2) {
      const unsigned ko0 = ko_of<L>(k_first, lane, v);
      if (ko0 >= (unsigned)s.Ko) break;
      const bool live1 = ko0 + 1 < (unsigned)s.Ko;
      Taps<T, int> t[2];
      bool use_fill[2], window[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float c[3] = {0.0f, 0.0f, 0.0f};
        if (p == 0 || live1) row.point(pts, s, ko0 + p, c);
        const float mask = inbounds(c[0], s.I) * inbounds(c[1], s.J) * inbounds(c[2], s.K);
        use_fill[p] = !(mask > 0.5f) || (p == 1 && !live1);
        window[p] = false;
        if (!use_fill[p]) {
          int ti[T];
          spline_taps<kOrder>(c[0], s.I, ti, t[p].wi);
          spline_taps<kOrder>(c[1], s.J, t[p].j, t[p].wj);
          spline_taps<kOrder>(c[2], s.K, t[p].k, t[p].wk);
          window[p] = s.C == 1 && t[p].k[T - 1] - t[p].k[0] == kOrder;
#pragma unroll
          for (int d = 0; d < T; ++d) {
            t[p].i[d] = ti[d] * plane_floats;
            t[p].j[d] *= row_floats;
          }
        }
      }
      float acc[2] = {0.0f, 0.0f};
      if (!use_fill[0] && !use_fill[1] && window[0] && window[1]) {
#pragma unroll
        for (int a = 0; a < T; ++a) {
#pragma unroll
          for (int b = 0; b < T; ++b) {
            const int first0 = t[0].i[a] + t[0].j[b] + t[0].k[0];
            const int first1 = t[1].i[a] + t[1].j[b] + t[1].k[0];
            const int gap = first1 - first0;
            float kv0, kv1;
            if (gap >= 0 && gap <= 2 && t[0].i[a] + t[0].j[b] == t[1].i[a] + t[1].j[b]) {
              const uintptr_t addr = reinterpret_cast<uintptr_t>(src + first0);
              const float4* q = reinterpret_cast<const float4*>(addr & ~(uintptr_t)15);
              const int shift = (int)(addr >> 2) & 3;
              const int used = (shift + gap + T + 3) >> 2;
              float w[12];
#pragma unroll
              for (int l = 0; l < 3; ++l) {
                float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (l == 0 || l < used) x = __ldg(q + l);
                w[4 * l] = x.x;
                w[4 * l + 1] = x.y;
                w[4 * l + 2] = x.z;
                w[4 * l + 3] = x.w;
              }
              kv0 = pick_sum(w, shift, t[0].wk);
              kv1 = pick_sum(w, shift + gap, t[1].wk);
            } else {
              kv0 = window_sum<T>(src + first0, t[0].wk);
              kv1 = window_sum<T>(src + first1, t[1].wk);
            }
            acc[0] = acc[0] + (t[0].wi[a] * t[0].wj[b]) * kv0;
            acc[1] = acc[1] + (t[1].wi[a] * t[1].wj[b]) * kv1;
          }
        }
      } else {
#pragma unroll 1
        for (int p = 0; p < 2; ++p) {
          if (use_fill[p]) continue;
          float one[1] = {0.0f};
          if (window[p]) {
#pragma unroll
            for (int a = 0; a < T; ++a) {
#pragma unroll
              for (int b = 0; b < T; ++b) {
                const float kv =
                    window_sum<T>(src + (t[p].i[a] + t[p].j[b] + t[p].k[0]), t[p].wk);
                one[0] = one[0] + (t[p].wi[a] * t[p].wj[b]) * kv;
              }
            }
          } else {
            sum_rows<kOrder, 1>(src, t[p], 0, one);
          }
          acc[p] = one[0];
        }
      }
      dst[ko0] = use_fill[0] ? fill : acc[0];
      if (live1) dst[ko0 + 1] = use_fill[1] ? fill : acc[1];
    }
  }
};

// The box form's shared memory a block: 24 KB of coefficients.
constexpr int kBoxFloats = 6144;

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The cubic sum over taps (ti, tj, tk) minus origin, from the box in
// shared memory (kShared: plain loads) or from device memory (__ldg), in
// the plain version's order.
template <bool kShared>
__device__ __forceinline__ float tap_sum(const float* base, const int ti[4], const int tj[4],
                                         const int tk[4], const int origin[3], int pi, int pj,
                                         const float wi[4], const float wj[4],
                                         const float wk[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int row = (ti[a] - origin[0]) * pi + (tj[b] - origin[1]) * pj - origin[2];
      float x[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) x[d] = kShared ? base[row + tk[d]] : __ldg(base + (row + tk[d]));
      float kv = wk[0] * x[0];
#pragma unroll
      for (int d = 1; d < 4; ++d) kv = kv + wk[d] * x[d];
      acc = acc + (wi[a] * wj[b]) * kv;
    }
  }
  return acc;
}

// Cubic on one channel, row_tiles.cuh's loops and strided lanes (a warp's
// lanes on consecutive ko): for each 32-ko step of the block's 8 rows, the
// voxels' taps, the block's bounding box of their (reflected) indices,
// the box staged in shared memory and every voxel's sum read from it
// (plain loads, the same order); a box past kBoxFloats reads device
// memory. Every warp of the block takes part in every step (a row past Jo
// or a voxel past Ko takes the fill and spans no box).
template <int kMinBlocks>
__global__ void __launch_bounds__(kLanes * kRows, kMinBlocks)
    box_kernel(const CoordsArgs args, tio::Points pts, Grid s, unsigned z_rows) {
  constexpr int kOrder = 3, T = 4;
  __shared__ float box[kBoxFloats];
  __shared__ int bounds[kRows][6];
  const unsigned lane = threadIdx.x, warp = threadIdx.y;
  const unsigned b_step = gridDim.z / z_rows;
  const unsigned j_tiles = ((unsigned)s.Jo + kRows - 1) / kRows;
  const unsigned k_tiles = ((unsigned)s.Ko + kTileK - 1) / kTileK;
  const int64_t out_spatial = tio::out_spatial(s);
  const int plane = s.J * s.K;
  for (unsigned b = blockIdx.z / z_rows; b < (unsigned)s.B; b += b_step) {
    const float* src = opaque(args.coeffs + (int64_t)b * s.I * plane);
    const float fill = __ldg(args.fill + b);
    for (unsigned io = blockIdx.z % z_rows; io < (unsigned)s.Io; io += z_rows) {
      for (unsigned jt = blockIdx.y; jt < j_tiles; jt += gridDim.y) {
        const unsigned jo = jt * kRows + warp;
        const bool row_live = jo < (unsigned)s.Jo;
        const int64_t row = ((int64_t)io * s.Jo + (row_live ? jo : 0)) * s.Ko;
        const float* coords = pts.coords + (int64_t)b * pts.batch_stride + row * 3;
        float* dst = opaque(args.out + (int64_t)b * out_spatial + row);
        for (unsigned kt = blockIdx.x; kt < k_tiles; kt += gridDim.x) {
          for (int v = 0; v < kVec; ++v) {
            if (kt * kTileK + v * kLanes >= (unsigned)s.Ko) break;  // the whole block
            const unsigned ko = kt * kTileK + lane + v * kLanes;
            const bool live = row_live && ko < (unsigned)s.Ko;
            float c[3] = {0.0f, 0.0f, 0.0f};
            if (live) {
#pragma unroll
              for (int a = 0; a < 3; ++a) c[a] = __ldg(coords + (size_t)ko * 3 + a);
            }
            const float mask =
                inbounds(c[0], s.I) * inbounds(c[1], s.J) * inbounds(c[2], s.K);
            const bool use_fill = !live || !(mask > 0.5f);
            int ti[T], tj[T], tk[T];
            float wi[T], wj[T], wk[T];
            int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
            if (!use_fill) {
              spline_taps<kOrder>(c[0], s.I, ti, wi);
              spline_taps<kOrder>(c[1], s.J, tj, wj);
              spline_taps<kOrder>(c[2], s.K, tk, wk);
#pragma unroll
              for (int d = 0; d < T; ++d) {
                lo[0] = min(lo[0], ti[d]), hi[0] = max(hi[0], ti[d]);
                lo[1] = min(lo[1], tj[d]), hi[1] = max(hi[1], tj[d]);
                lo[2] = min(lo[2], tk[d]), hi[2] = max(hi[2], tk[d]);
              }
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              lo[a] = warp_min(lo[a]);
              hi[a] = warp_max(hi[a]);
            }
            if (lane < 3) {
              bounds[warp][lane] = lo[lane];
              bounds[warp][3 + lane] = hi[lane];
            }
            __syncthreads();
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              for (int w = 0; w < kRows; ++w) {
                lo[a] = min(lo[a], bounds[w][a]);
                hi[a] = max(hi[a], bounds[w][3 + a]);
              }
            }
            const int ni = hi[0] - lo[0] + 1, nj = hi[1] - lo[1] + 1, nk = hi[2] - lo[2] + 1;
            const bool staged = lo[0] <= hi[0] && (int64_t)ni * nj * nk <= kBoxFloats;
            if (staged) {
              for (int r = warp; r < ni * nj; r += kRows) {
                const int bi = r / nj, bj = r - bi * nj;
                const float* from = src + ((lo[0] + bi) * plane + (lo[1] + bj) * s.K + lo[2]);
                for (int kk = lane; kk < nk; kk += kLanes) box[r * nk + kk] = __ldg(from + kk);
              }
            }
            __syncthreads();
            float acc = fill;
            if (!use_fill && staged) {
              acc = tap_sum<true>(box, ti, tj, tk, lo, nj * nk, nk, wi, wj, wk);
            } else if (!use_fill) {
              const int origin[3] = {0, 0, 0};
              acc = tap_sum<false>(src, ti, tj, tk, origin, plane, s.K, wi, wj, wk);
            }
            if (live) dst[ko] = acc;
            __syncthreads();  // the box and the bounds serve the next step
          }
        }
      }
    }
  }
}

template <int kMinBlocks>
void box_launch(const CoordsArgs& args, const tio::Points& pts, const Grid& s, const Launch& l,
                cudaStream_t st) {
  box_kernel<kMinBlocks>
      <<<dim3(l.gx, l.gy, l.gz), dim3(kLanes, kRows), 0, st>>>(args, pts, s, l.z_rows);
}

template <class Body>
void rows_as(const CoordsArgs& args, const tio::Points& pts, const Grid& s, const Launch& l,
             cudaStream_t st) {
  tio::launch_rows<Body, Source::kDense>(args, pts, s, l, st);
}

template <bool kConsecutive, int kMinBlocks, bool kInterior = false>
using Cubic = SplineCoords<3, 1, int, CoordsLayout<kConsecutive, kMinBlocks, kInterior>>;
template <bool kConsecutive, int kMinBlocks>
using Windows = SplineCoords<3, 1, int, WindowsLayout<kConsecutive, kMinBlocks>>;
template <bool kConsecutive, bool kInterior, typename Index = int>
using Runs = SplineCoords<3, 1, Index, RunsLayout<kConsecutive, 4, kInterior>>;
template <bool kConsecutive, bool kInterior>
using Wide = SplineCoords<3, 1, int64_t, CoordsLayout<kConsecutive, 4, kInterior>>;

}  // namespace

// The replaced kernel on dense coordinates (coeffs channels-last; vec as
// tio_bspline_coords).
extern "C" int probe_coords_old(const float* coeffs, const float* coords, const float* fill,
                                float* out, int B, int C, int I, int J, int K, int Io, int Jo,
                                int Ko, long long coord_batch_stride, int order, int vec,
                                void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  return launch_spline<Source::kDense>(coeffs, pts, fill, out, s, order, vec,
                                       static_cast<cudaStream_t>(stream));
}

// A row-tiled form at order 3 on one channel, by variant number (see
// VARIANTS in probes/spline_coords_layout.py); the launch plan of
// tio_bspline_coords.
extern "C" int probe_coords_rows(const float* coeffs, const float* coords, const float* fill,
                                 float* out, int B, int C, int I, int J, int K, int Io, int Jo,
                                 int Ko, long long coord_batch_stride, int gx, int gy, int gz,
                                 int z_rows, int variant, void* stream) {
  if (C != 1) return (int)cudaErrorInvalidValue;
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, 0, 0};
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  const CoordsArgs args{coeffs, fill, out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: rows_as<Cubic<true, 4>>(args, pts, s, l, st); break;
    case 1: rows_as<Windows<true, 4>>(args, pts, s, l, st); break;
    case 2: rows_as<Cubic<false, 4>>(args, pts, s, l, st); break;
    case 3: rows_as<Windows<false, 4>>(args, pts, s, l, st); break;
    case 4: rows_as<Windows<true, 3>>(args, pts, s, l, st); break;
    case 5: rows_as<Windows<false, 3>>(args, pts, s, l, st); break;
    case 6: rows_as<Windows<true, 2>>(args, pts, s, l, st); break;
    case 7: rows_as<Windows<false, 2>>(args, pts, s, l, st); break;
    case 8: rows_as<SplinePairs<PairLayout<3>>>(args, pts, s, l, st); break;
    case 9: rows_as<SplinePairs<PairLayout<2>>>(args, pts, s, l, st); break;
    case 10: rows_as<Wide<true, false>>(args, pts, s, l, st); break;
    case 11: rows_as<Wide<false, false>>(args, pts, s, l, st); break;
    case 12: rows_as<Cubic<false, 3>>(args, pts, s, l, st); break;
    case 13: rows_as<Cubic<false, 2>>(args, pts, s, l, st); break;
    case 14: box_launch<4>(args, pts, s, l, st); break;
    case 15: box_launch<3>(args, pts, s, l, st); break;
    case 16: rows_as<Cubic<false, 4, true>>(args, pts, s, l, st); break;
    case 17: rows_as<Runs<false, false>>(args, pts, s, l, st); break;
    case 18: rows_as<Runs<false, true>>(args, pts, s, l, st); break;
    case 19: rows_as<Runs<true, true>>(args, pts, s, l, st); break;
    case 20: rows_as<Runs<false, true, int64_t>>(args, pts, s, l, st); break;
    case 21: rows_as<Wide<false, true>>(args, pts, s, l, st); break;
    case 22: rows_as<Cubic<true, 4, true>>(args, pts, s, l, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
