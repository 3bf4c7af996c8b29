// B-spline resampling of orders 2-7 for NVIDIA Hopper (sm_90a): the
// direct B-spline transform (prefilter) and the (order+1)^3-tap
// evaluation at per-element grid specs or at dense coordinates.
//
// tio_prefilter_axis: the prefilter along one axis of a float32 volume.
//   It has no Pallas counterpart: the JAX package runs it in XLA
//   (torchio_tpu/ops/bspline.py prefilter/_prefilter_axis, two lax.scan
//   per pole and axis), before its windowed spline kernel.
//   One thread per 1-D line: the gain lam, then for each pole the
//   causal recursion from its mirror-boundary start (the truncated
//   geometric sum when the horizon is shorter than the line, else the
//   exact sum over the mirrored period) and the anticausal recursion
//   from its closed-form start. The wrapper calls it once per axis; the
//   first call reads the input and writes the coefficients, the others
//   work in place.
//   What bounds it: device-memory bytes. Each pole reads and writes the
//   volume twice (the recursions are sequential along a line). Along i
//   and j, neighbouring threads hold neighbouring k and their accesses
//   coalesce; along k each thread walks its own contiguous line and the
//   accesses of a warp land on 32 cache lines (L1 absorbs part of it).
//   Staging k-lines through shared memory is later work.
//
// tio_bspline_resample: replaces the spline modes of
//   torchio_tpu/ops/window_resample.py _kernel (cubic_resample_fused;
//   taps from _spline_taps, mirror fold _fold_mirror, reflection
//   _reflect_idx) and their XLA reference
//   torchio_tpu/ops/bspline.py bspline_resample. The TPU kernel loops
//   over candidate (i, j) offsets and lane-gathers along k; here each
//   thread reads its taps directly.
// tio_bspline_coords: the same evaluation at the points of a dense
//   (B or 1, Io, Jo, Ko, 3) coordinate tensor: the JAX package's
//   bspline_resample on dense grids (an XLA gather there, no Pallas).
//   The coordinate is read from memory; everything after it is shared.
// Both: one thread per output voxel (b, io, jo, ko), ko fastest:
//     1. the sample point (sample_point.cuh: built from the grid spec,
//        or read from the coordinate tensor);
//     2. the fill mask from the raw coordinate: the product over axes of
//        the two in-bounds linear weights, as bspline_resample computes
//        it (size-1 axes are not forced to 0 here);
//     3. per axis, the coordinate folded into [0, n-1] under mirror
//        (dct1) symmetry, the order+1 tap indices reflected into the
//        volume and their basis weights: closed forms for orders 2 and
//        3, the Cox-de Boor recursion for orders 4-7;
//     4. for each channel, sum over i and j taps of (wi wj) times the
//        k-tap sum; the fill replaces the value wherever the mask is
//        <= 0.5 (always applied: the mirror-folded spline would leak
//        past the volume otherwise).
//   What bounds it: at order 3, 64 taps per voxel and channel, read
//   through L1/L2 (neighbouring threads share most taps), plus one
//   4-byte write; the tap weights are computed once per voxel and
//   reused over the channels. At orders 4-7 the recursion's arithmetic
//   (2^order leaves per weight, inlined) adds to it.
//
// Built with -fmad=false (see sample_point.cuh). A division by a
// constant is a product with its float32 reciprocal, as in the plain
// versions (torchio_tpu_torch/ops/bspline.py). Offsets are 64-bit.
// Launches go on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include "sample_point.cuh"

namespace {

using tio::Grid;
using tio::kThreads;
using tio::Source;

constexpr int kMaxPoles = 3;

struct Poles {
  int count;
  float lam;                 // gain: prod (1 - z)(1 - 1/z)
  float z[kMaxPoles];
  int horizon[kMaxPoles];    // truncated-sum length; >= n: periodic sum
  float inv_denom[kMaxPoles];  // 1 / (1 - z^(2n - 2)), for the periodic sum
  float anti[kMaxPoles];     // z / (z^2 - 1), the anticausal start's gain
};

__global__ void __launch_bounds__(kThreads)
    prefilter_axis_kernel(const float* src, float* dst, int64_t lines, int n,
                          int64_t stride, Poles p) {
  // src and dst are the same buffer on every pass but the first
  for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < lines;
       l += (int64_t)gridDim.x * blockDim.x) {
    const int64_t base = (l / stride) * n * stride + l % stride;
    const float* in = src + base;
    float* x = dst + base;
    if (n == 1) {
      x[0] = in[0];
      continue;
    }
    for (int i = 0; i < n; ++i) x[i * stride] = in[i * stride] * p.lam;
    for (int q = 0; q < p.count; ++q) {
      const float z = p.z[q];
      float c0 = 0.0f, zm = 1.0f;
      if (p.horizon[q] < n) {
        for (int m = 0; m < p.horizon[q]; ++m) {
          c0 = c0 + zm * x[m * stride];
          zm = zm * z;
        }
      } else {
        for (int m = 0; m < n; ++m) {
          c0 = c0 + zm * x[m * stride];
          zm = zm * z;
        }
        for (int m = n; m < 2 * n - 2; ++m) {
          c0 = c0 + zm * x[(2 * n - 2 - m) * stride];
          zm = zm * z;
        }
        c0 = c0 * p.inv_denom[q];
      }
      float prev = c0;
      x[0] = c0;
      for (int i = 1; i < n; ++i) {
        prev = x[i * stride] + z * prev;
        x[i * stride] = prev;
      }
      float next = p.anti[q] * (z * x[(n - 2) * stride] + prev);
      x[(n - 1) * stride] = next;
      for (int i = n - 2; i >= 0; --i) {
        next = z * (next - x[i * stride]);
        x[i * stride] = next;
      }
    }
  }
}

// Centered cardinal B-spline B_N by the Cox-de Boor recursion, the
// expression tree of torchio_tpu/ops/bspline.py _bspline_kernel.
template <int N>
struct Basis {
  __device__ __forceinline__ static float at(float u) {
    const float lower = Basis<N - 1>::at(u + 0.5f);
    const float upper = Basis<N - 1>::at(u - 0.5f);
    constexpr float half = (N + 1) / 2.0f;
    constexpr float inv_n = 1.0f / N;
    return ((u + half) * lower + (half - u) * upper) * inv_n;
  }
};
template <>
struct Basis<0> {
  __device__ __forceinline__ static float at(float u) {
    return (u >= -0.5f && u < 0.5f) ? 1.0f : 0.0f;
  }
};

// Fold a coordinate into [0, n-1] under mirror (dct1) symmetry.
__device__ __forceinline__ float fold_mirror(float x, int n) {
  if (n == 1) return 0.0f;
  const float period = 2.0f * (float)(n - 1);
  const float y = fmodf(fabsf(x), period);
  return y > (float)(n - 1) ? period - y : y;
}

// Mirror (dct1) reflection of an integer tap index into [0, n-1].
__device__ __forceinline__ int reflect_index(int idx, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  idx = abs(idx) % period;
  return idx >= n ? period - idx : idx;
}

// The order+1 reflected tap indices and basis weights of coordinate c
// on an axis of n samples (torchio_tpu/ops/window_resample.py
// _spline_taps): even orders center on floor(x + 0.5), odd orders on
// floor(x); the taps start order/2 below.
template <int kOrder>
__device__ __forceinline__ void spline_taps(float c, int n, int idx[kOrder + 1],
                                            float w[kOrder + 1]) {
  const float cf = fold_mirror(c, n);
  const float base = (kOrder % 2 == 0) ? floorf(cf + 0.5f) : floorf(cf);
  const float start_f = base - (float)(kOrder / 2);
  const float t = cf - start_f;
  const int start = (int)start_f;
  if constexpr (kOrder == 2) {
    const float d0 = t - 1.5f, u1 = t - 1.0f, d2 = t - 0.5f;
    w[0] = d0 * d0 * 0.5f;
    w[1] = 0.75f - u1 * u1;
    w[2] = d2 * d2 * 0.5f;
  } else if constexpr (kOrder == 3) {
    const float r = t - 1.0f;
    const float a0 = 2.0f - (r + 1.0f);
    const float u2 = 1.0f - r;
    const float a3 = 2.0f - (2.0f - r);
    constexpr float sixth = 1.0f / 6.0f;
    w[0] = a0 * a0 * a0 * sixth;
    w[1] = (4.0f - 6.0f * r * r + 3.0f * r * r * r) * sixth;
    w[2] = (4.0f - 6.0f * u2 * u2 + 3.0f * u2 * u2 * u2) * sixth;
    w[3] = a3 * a3 * a3 * sixth;
  } else {
#pragma unroll
    for (int o = 0; o <= kOrder; ++o) w[o] = Basis<kOrder>::at(t - (float)o);
  }
#pragma unroll
  for (int d = 0; d <= kOrder; ++d) idx[d] = reflect_index(start + d, n);
}

// One axis's contribution to the fill mask: the two in-bounds linear
// weights of the raw coordinate.
__device__ __forceinline__ float inbounds(float c, int size) {
  const float f0 = floorf(c);
  const float frac = c - f0;
  const float w0 = (f0 >= 0.0f && f0 < (float)size) ? 1.0f - frac : 0.0f;
  const float w1 = (f0 + 1.0f >= 0.0f && f0 + 1.0f < (float)size) ? frac : 0.0f;
  return w0 + w1;
}

template <int kOrder, Source kSource>
__global__ void __launch_bounds__(kThreads)
    spline_kernel(const float* __restrict__ coeffs, tio::Points pts,
                  const float* __restrict__ fill, float* __restrict__ out, Grid s) {
  constexpr int T = kOrder + 1;
  const int64_t out_spatial = tio::out_spatial(s);
  const int64_t in_spatial = tio::in_spatial(s);
  const int64_t total = (int64_t)s.B * out_spatial;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const tio::Voxel p = tio::voxel_of(v, s);
    float c[3];
    tio::point_of<kSource>(pts, s, p, c);
    const float mask = inbounds(c[0], s.I) * inbounds(c[1], s.J) * inbounds(c[2], s.K);
    const bool use_fill = !(mask > 0.5f);
    int ti[T], tj[T], tk[T];
    float wi[T], wj[T], wk[T];
    if (!use_fill) {
      spline_taps<kOrder>(c[0], s.I, ti, wi);
      spline_taps<kOrder>(c[1], s.J, tj, wj);
      spline_taps<kOrder>(c[2], s.K, tk, wk);
    }
    const int64_t out_base =
        (int64_t)p.b * s.C * out_spatial + (v - (int64_t)p.b * out_spatial);
    for (int ch = 0; ch < s.C; ++ch) {
      float acc;
      if (use_fill) {
        acc = __ldg(fill + (int64_t)p.b * s.C + ch);
      } else {
        const float* src = coeffs + ((int64_t)p.b * s.C + ch) * in_spatial;
        acc = 0.0f;
#pragma unroll
        for (int a = 0; a < T; ++a) {
#pragma unroll
          for (int b = 0; b < T; ++b) {
            const float* row = src + ((int64_t)ti[a] * s.J + tj[b]) * s.K;
            float kv = wk[0] * __ldg(row + tk[0]);
#pragma unroll
            for (int d = 1; d < T; ++d) kv = kv + wk[d] * __ldg(row + tk[d]);
            acc = acc + (wi[a] * wj[b]) * kv;
          }
        }
      }
      out[out_base + (int64_t)ch * out_spatial] = acc;
    }
  }
}

template <Source kSource>
void launch_spline(const float* coeffs, const tio::Points& pts, const float* fill,
                   float* out, const Grid& s, int order, cudaStream_t st) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  switch (order) {
    case 2: spline_kernel<2, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 3: spline_kernel<3, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 4: spline_kernel<4, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 5: spline_kernel<5, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 6: spline_kernel<6, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 7: spline_kernel<7, kSource><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
  }
}

}  // namespace

// One axis pass of the prefilter over a volume viewed as (outer, n,
// stride): lines = outer * stride. The pole constants come from the
// host (torchio_tpu_torch/ops/bspline.py pole_constants).
extern "C" int tio_prefilter_axis(const float* src, float* dst, long long lines,
                                  int n, long long stride, int count,
                                  const float* z, const int* horizon,
                                  const float* inv_denom, const float* anti,
                                  float lam, void* stream) {
  if (count < 0 || count > kMaxPoles) return (int)cudaErrorInvalidValue;
  if (lines == 0) return 0;
  Poles p{};
  p.count = count;
  p.lam = lam;
  for (int q = 0; q < count; ++q) {
    p.z[q] = z[q];
    p.horizon[q] = horizon[q];
    p.inv_denom[q] = inv_denom[q];
    p.anti[q] = anti[q];
  }
  prefilter_axis_kernel<<<tio::blocks_for(lines), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(src, dst, lines, n,
                                                               stride, p);
  return (int)cudaGetLastError();
}

extern "C" int tio_bspline_resample(const float* coeffs, const float* maps,
                                    const float* fields, const float* fill,
                                    float* out, int B, int C, int I, int J, int K,
                                    int Io, int Jo, int Ko, int ni, int nj, int nk,
                                    float ri, float rj, float rk, int order,
                                    void* stream) {
  if (order < 2 || order > 7) return (int)cudaErrorInvalidValue;
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    launch_spline<Source::kMapField>(coeffs, pts, fill, out, s, order, st);
  } else {
    launch_spline<Source::kMap>(coeffs, pts, fill, out, s, order, st);
  }
  return (int)cudaGetLastError();
}

// coords: (B or 1, Io, Jo, Ko, 3) float32; coord_batch_stride is
// Io*Jo*Ko*3 for per-element grids and 0 for one shared grid.
extern "C" int tio_bspline_coords(const float* coeffs, const float* coords,
                                  const float* fill, float* out, int B, int C,
                                  int I, int J, int K, int Io, int Jo, int Ko,
                                  long long coord_batch_stride, int order,
                                  void* stream) {
  if (order < 2 || order > 7) return (int)cudaErrorInvalidValue;
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  launch_spline<Source::kDense>(coeffs, pts, fill, out, s, order,
                                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
