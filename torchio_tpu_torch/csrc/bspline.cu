// B-spline resampling of orders 2-7 for NVIDIA Hopper (sm_90a): the
// direct B-spline transform (prefilter) and the (order+1)^3-tap
// evaluation at per-element grid specs or at dense coordinates.
//
// tio_prefilter_axis: the prefilter along one axis of a float32 volume
//   viewed as (outer, n, stride). It has no Pallas counterpart: the JAX
//   package runs it in XLA (torchio_tpu/ops/bspline.py
//   prefilter/_prefilter_axis, two lax.scan per pole and axis), before
//   its windowed spline kernel. Each line gets the gain lam, then for
//   each pole the causal recursion from its mirror-boundary start (the
//   truncated geometric sum when the horizon is shorter than the line,
//   else the exact sum over the mirrored period) and the anticausal
//   recursion from its closed-form start. The wrapper calls it once per
//   axis; the first call reads the input and writes the coefficients,
//   the others work in place.
//   What bounds it: device-memory bytes. The recursions are sequential
//   along a line and walk it about six times (gain, start sum, two
//   sweeps per pole), so the design keeps every walk out of device
//   memory: a block stages whole lines in shared memory with cp.async
//   (coalesced: consecutive threads on consecutive addresses), runs
//   every walk there with one thread per line, and writes the lines back
//   once, so each pass reads and writes the volume once. A (B, C, I, J,
//   K) batch of C > 1 channels comes out channels-last, (B, I, J, K, C)
//   in memory, the layout the spline kernels read: the i pass moves the
//   channels innermost as it writes, the j and k passes work in place.
//   - kLines (stride below 32: the k axis, stride 1 planar or C
//     channels-last): a block takes whole rows of `stride` interleaved
//     lines, one contiguous chunk of memory, each line stored at an odd
//     pitch so that threads at the same index hit different banks.
//   - kColumns (stride >= 32, the i and j axes): a block takes an n x W
//     slab of consecutive positions across the lines, of every channel
//     when the pass moves channels; row m of the slab is one contiguous
//     run of the output, and thread t walks column t (bank t).
//   - kGlobal: lines too long for shared memory (the plan in
//     torchio_tpu_torch/ops/bspline_kernel.py prefilter_plan picks the
//     path and the block's size by shape) walk device memory with one
//     thread per line, as the first version of this kernel did.
//   Every path runs each line's arithmetic in the same order.
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
// Both read channels-last (B, I, J, K, C) coefficients (the wrappers
// copy other layouts) and compute, for each output voxel (b, io, jo, ko):
//     1. the sample point (built from the grid spec, or read from the
//        coordinate tensor);
//     2. the fill mask from the raw coordinate: the product over axes of
//        the two in-bounds linear weights, as bspline_resample computes
//        it (size-1 axes are not forced to 0 here);
//     3. per axis, the coordinate folded into [0, n-1] under mirror
//        (dct1) symmetry, the order+1 tap indices reflected into the
//        volume and their basis weights: closed forms for orders 2 and
//        3, the Cox-de Boor recursion for orders 4-7;
//     4. for each group of V channels (V = 4 when C is a multiple of 4,
//        else 1), sum over i and j taps of (wi wj) times the k-tap sum;
//        the fill replaces the value wherever the mask is <= 0.5 (always
//        applied: the mirror-folded spline would leak past the volume
//        otherwise). Each channel's sums run in the plain version's
//        order, so the result is the same bits.
// The grid-spec kernel (spline_kernel) takes one thread per output
// voxel over the flat (B, Io, Jo, Ko) index, each tap one V-wide load.
//   What bounds it: not device bytes but the taps' loads: at order 3,
//   64 taps per voxel and channel, read through L1/L2; a warp's taps of
//   one (a, b, d) fall on the several rows its rotated voxels straddle,
//   so each load costs several L1 wavefronts. Channels-last coefficients
//   let one load (and one wavefront's row) serve four channels, which
//   cuts the load instructions and wavefronts by four at C = 4. The tap
//   weights are computed once per voxel and reused over the channels. A
//   tiled version that staged each tile's coefficient box in shared
//   memory lost to the planar direct kernel at the brats shape: its
//   setup, box loads and barriers cost more than the wavefronts it saved
//   (PERF.md, PR 4).
// The dense kernel (SplineCoords) first ran that body on dense points:
// 1.05 ms for a cubic B=1 x 256^3 resample on a Motion grid against
// 0.100 ms of bytes (NVIDIA H100 80GB HBM3, 700 W), with four 64-bit
// divisions a voxel to split the flat index and 64-bit arithmetic in
// each of the 64 tap addresses. It now runs on the row tiles of
// row_tiles.cuh, as resample.cu's dense mode does (each step measured by
// probes/spline_coords_layout.py at B=1, the steps before the last
// without its interior path; the numbers are in PERF.md):
//   - a warp on one output row (b, io, jo) from a 3-D launch grid with
//     32-bit arithmetic (ops/bspline_kernel.py::coords_launch_plan), the
//     row's coordinates read through Row; a warp's lanes on consecutive
//     ko (a lane's voxels a warp-width apart), so each tap load of the
//     warp reads about one run of 32 floats (0.61 ms; a lane's voxels on
//     consecutive ko, 0.96 ms);
//   - offsets inside one element's I J K C coefficients 32-bit below 2^31
//     (a template parameter, 64-bit otherwise: 0.78 ms), each load one
//     offset scaled onto the element's base;
//   - a lane's voxels one at a time at 4 blocks an SM (64 registers; 3
//     and 2 blocks 0.64 and 0.70 ms);
//   - spline_taps (shared with the grid-spec kernel, whose instance
//     keeps its general path) with its interior path: a coordinate inside
//     the volume is not folded (fmodf) and a run of taps inside it not
//     reflected (an integer modulo a tap), which leaves 0.48 ms; orders
//     4-7 call it out of line (dense_taps), which keeps the build short.
//   What bounds it now is not the L1 lines its taps touch: on a shifted
//   grid without rotation, whose warp loads touch the fewest lines, it
//   takes about as long. Reading a row's k taps as float4 windows (two
//   loads at order 3), reusing a lane's window for its next voxel, and
//   staging a block's tap box in shared memory all lost, the box by
//   2.6 times.

// Built with -fmad=false (see sample_point.cuh). A division by a
// constant is a product with its float32 reciprocal, as in the plain
// versions (torchio_tpu_torch/ops/bspline.py). Launches go on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_pipeline.h>

#include "row_tiles.cuh"

namespace {

using tio::Grid;
using tio::kThreads;
using tio::kVec;
using tio::ko_of;
using tio::Launch;
using tio::opaque;
using tio::Row;
using tio::Source;

constexpr int kMaxPoles = 3;
// dynamic shared memory a block may use on Hopper (227 KB)
constexpr int kMaxSharedBytes = 232448;

struct Poles {
  int count;
  float lam;                 // gain: prod (1 - z)(1 - 1/z)
  float z[kMaxPoles];
  int horizon[kMaxPoles];    // truncated-sum length; >= n: periodic sum
  float inv_denom[kMaxPoles];  // 1 / (1 - z^(2n - 2)), for the periodic sum
  float anti[kMaxPoles];     // z / (z^2 - 1), the anticausal start's gain
};

// Every pole's recursions over one line x[0], x[step], ... x[(n-1) step]
// that already holds the gained samples (a 32-bit step in shared memory,
// a 64-bit one in device memory).
template <typename Index>
__device__ __forceinline__ void prefilter_line(float* x, int n, Index step,
                                               const Poles& p) {
  for (int q = 0; q < p.count; ++q) {
    const float z = p.z[q];
    float c0 = 0.0f, zm = 1.0f;
    if (p.horizon[q] < n) {
      for (int m = 0; m < p.horizon[q]; ++m) {
        c0 = c0 + zm * x[m * step];
        zm = zm * z;
      }
    } else {
      for (int m = 0; m < n; ++m) {
        c0 = c0 + zm * x[m * step];
        zm = zm * z;
      }
      for (int m = n; m < 2 * n - 2; ++m) {
        c0 = c0 + zm * x[(2 * n - 2 - m) * step];
        zm = zm * z;
      }
      c0 = c0 * p.inv_denom[q];
    }
    float prev = c0;
    x[0] = c0;
    for (int i = 1; i < n; ++i) {
      prev = x[i * step] + z * prev;
      x[i * step] = prev;
    }
    float next = p.anti[q] * (z * x[(n - 2) * step] + prev);
    x[(n - 1) * step] = next;
    for (int i = n - 2; i >= 0; --i) {
      next = z * (next - x[i * step]);
      x[i * step] = next;
    }
  }
}

// kGlobal: one thread per line, in device memory.
__global__ void __launch_bounds__(kThreads)
    prefilter_global_kernel(const float* src, float* dst, int64_t lines, int n,
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
    prefilter_line(x, n, stride, p);
  }
}

__device__ __forceinline__ void copy4_async(float* shared, const float* global) {
  __pipeline_memcpy_async(shared, global, sizeof(float));
}

// kLines: lines of a small stride s (1 for planar k lines; C for the k
// lines of channels-last coefficients, C lines interleaved in each row).
// The volume is viewed as (rows, n, s); block b takes rows [b R, b R + R),
// one contiguous chunk of memory holding R s lines, R s = blockDim.x. Line
// (r, l) is stored at line pitch `pitch` (odd), thread r s + l walks it.
__global__ void prefilter_lines_kernel(const float* src, float* dst, int64_t rows,
                                       int n, int s, int pitch, Poles p) {
  extern __shared__ float sh[];
  const int per_block = blockDim.x;
  const int rows_per_block = per_block / s;
  const int64_t first = (int64_t)blockIdx.x * rows_per_block;
  const int count = (int)min((int64_t)rows_per_block, rows - first);
  const int64_t row_floats = (int64_t)n * s;
  const float* in = src + first * row_floats;
  float* out = dst + first * row_floats;
  // consecutive threads on consecutive addresses of the chunk: thread t
  // keeps lane l = t % s and steps R samples down its lines
  const int lane = threadIdx.x % s;
  {
    int row = 0, m = threadIdx.x / s;
    while (m >= n) { m -= n; ++row; }
    for (; row < count;) {
      copy4_async(sh + (row * s + lane) * pitch + m, in + row * row_floats + m * s + lane);
      m += rows_per_block;
      while (m >= n) { m -= n; ++row; }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if ((int)threadIdx.x < count * s && n > 1) {
    float* x = sh + threadIdx.x * pitch;
    for (int i = 0; i < n; ++i) x[i] = x[i] * p.lam;
    prefilter_line(x, n, 1, p);
  }
  __syncthreads();
  {
    int row = 0, m = threadIdx.x / s;
    while (m >= n) { m -= n; ++row; }
    for (; row < count;) {
      out[row * row_floats + m * s + lane] = sh[(row * s + lane) * pitch + m];
      m += rows_per_block;
      while (m >= n) { m -= n; ++row; }
    }
  }
}

// kColumns: lines of stride > 1, read from a volume viewed as (outer, C,
// n, stride) and written to one viewed as (outer, n, stride, C): C = 1
// filters in place; C > 1 also moves the channels innermost (the i pass of
// channels-last coefficients). Block b takes, in outer slice b / slabs,
// the W consecutive positions [s0, s0 + W) of every row and every channel:
// an (n, W C) slab, W C = blockDim.x, thread w C + c walking column w of
// channel c. Each row of the slab is W runs of C channels, so the write
// is one contiguous run.
__global__ void prefilter_columns_kernel(const float* src, float* dst, int n,
                                         int64_t stride, int channels, int64_t slabs,
                                         Poles p) {
  extern __shared__ float sh[];
  const int width = blockDim.x;
  const int t = threadIdx.x;
  const int w = t / channels, c = t % channels;
  const int64_t o = blockIdx.x / slabs;
  const int64_t s0 = (blockIdx.x % slabs) * (width / channels);
  const bool live = s0 + w < stride;
  const int64_t in_base = ((o * channels + c) * n) * stride + s0 + w;
  const int64_t out_base = (o * n * stride + s0) * channels + t;
  const int64_t out_step = stride * channels;
  if (live) {
    for (int m = 0; m < n; ++m) copy4_async(sh + m * width + t, src + in_base + m * stride);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  // each thread reads back only what it loaded itself: no barrier needed
  if (!live) return;
  float* x = sh + t;
  if (n > 1) {
    for (int i = 0; i < n; ++i) x[i * width] = x[i * width] * p.lam;
    prefilter_line(x, n, width, p);
  }
  for (int m = 0; m < n; ++m) dst[out_base + m * out_step] = x[m * width];
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
// floor(x); the taps start order/2 below. kInterior: a coordinate in
// [0, n-1] skips the fold (fmodf: it would return the coordinate, or +0
// for -0, which floors and subtracts alike) and a run of taps inside the
// volume skips the reflection (an integer modulo a tap: each would
// return its index), with the same results.
template <int kOrder, bool kInterior = false>
__device__ __forceinline__ void spline_taps(float c, int n, int idx[kOrder + 1],
                                            float w[kOrder + 1]) {
  const float cf =
      kInterior && c >= 0.0f && c <= (float)(n - 1) ? c : fold_mirror(c, n);
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
  if (kInterior && start >= 0 && start + kOrder <= n - 1) {
#pragma unroll
    for (int d = 0; d <= kOrder; ++d) idx[d] = start + d;
  } else {
#pragma unroll
    for (int d = 0; d <= kOrder; ++d) idx[d] = reflect_index(start + d, n);
  }
}

// spline_taps for the dense kernel: orders 4-7 evaluate the Cox-de Boor
// recursion (2^order leaves a weight), so they run out of line, compiled
// once an order instead of inlined into each of the kernel's four
// instances and three axes; that keeps the library's build short (they
// are on no timed path). The arithmetic is spline_taps' own.
template <int kOrder, bool kInterior>
__device__ __noinline__ void spline_taps_call(float c, int n, int idx[kOrder + 1],
                                              float w[kOrder + 1]) {
  spline_taps<kOrder, kInterior>(c, n, idx, w);
}

template <int kOrder, bool kInterior>
__device__ __forceinline__ void dense_taps(float c, int n, int idx[kOrder + 1],
                                           float w[kOrder + 1]) {
  if constexpr (kOrder <= 3) {
    spline_taps<kOrder, kInterior>(c, n, idx, w);
  } else {
    spline_taps_call<kOrder, kInterior>(c, n, idx, w);
  }
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

// V consecutive floats in one load (V = 4: a 16-byte-aligned float4).
template <int V>
__device__ __forceinline__ void load_vec(const float* ptr, float x[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(ptr));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(ptr);
  }
}

// One i-plane of the tap sum: acc[u] += (wi wj[b]) times the k-tap sum
// of row b, for V channels. tj and tk are offsets in floats within the
// plane (tap index times the row's and the sample's floats).
template <int T, int V>
__device__ __forceinline__ void sum_plane(const float* plane, float wi, const int tj[T],
                                          const float wj[T], const int tk[T],
                                          const float wk[T], float acc[V]) {
#pragma unroll
  for (int b = 0; b < T; ++b) {
    const float* row = plane + tj[b];
    float x[V], kv[V];
    load_vec<V>(row + tk[0], x);
#pragma unroll
    for (int u = 0; u < V; ++u) kv[u] = wk[0] * x[u];
#pragma unroll
    for (int d = 1; d < T; ++d) {
      load_vec<V>(row + tk[d], x);
#pragma unroll
      for (int u = 0; u < V; ++u) kv[u] = kv[u] + wk[d] * x[u];
    }
    const float wij = wi * wj[b];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = acc[u] + wij * kv[u];
  }
}

// coeffs: channels-last (B, I, J, K, C), J K C < 2^31; out: (B, C, Io,
// Jo, Ko). Each tap is read for V channels at once.
template <int kOrder, Source kSource, int V>
__global__ void __launch_bounds__(kThreads)
    spline_kernel(const float* __restrict__ coeffs, tio::Points pts,
                  const float* __restrict__ fill, float* __restrict__ out, Grid s) {
  constexpr int T = kOrder + 1;
  const int64_t out_spatial = tio::out_spatial(s);
  const int row_floats = s.K * s.C;
  const int64_t plane_floats = (int64_t)s.J * row_floats;
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
    int64_t ti_off[T];
    if (!use_fill) {
      spline_taps<kOrder>(c[0], s.I, ti, wi);
      spline_taps<kOrder>(c[1], s.J, tj, wj);
      spline_taps<kOrder>(c[2], s.K, tk, wk);
#pragma unroll
      for (int d = 0; d < T; ++d) {
        ti_off[d] = ti[d] * plane_floats;
        tj[d] *= row_floats;
        tk[d] *= s.C;
      }
    }
    const int64_t out_base =
        (int64_t)p.b * s.C * out_spatial + (v - (int64_t)p.b * out_spatial);
    const float* src = coeffs + (int64_t)p.b * s.I * plane_floats;
    for (int c0 = 0; c0 < s.C; c0 += V) {
      float acc[V];
      if (use_fill) {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = __ldg(fill + (int64_t)p.b * s.C + c0 + u);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.0f;
        if constexpr (kOrder <= 5) {
#pragma unroll
          for (int a = 0; a < T; ++a) {
            sum_plane<T, V>(src + c0 + ti_off[a], wi[a], tj, wj, tk, wk, acc);
          }
        } else {
          // orders 6-7: one plane's code in a loop, which keeps the
          // library's build short (these orders are on no timed path)
#pragma unroll 1
          for (int a = 0; a < T; ++a) {
            sum_plane<T, V>(src + c0 + ti_off[a], wi[a], tj, wj, tk, wk, acc);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u) out[out_base + (int64_t)(c0 + u) * out_spatial] = acc[u];
    }
  }
}

template <Source kSource, int V>
void launch_spline_vec(const float* coeffs, const tio::Points& pts, const float* fill,
                       float* out, const Grid& s, int order, cudaStream_t st) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  switch (order) {
    case 2: spline_kernel<2, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 3: spline_kernel<3, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 4: spline_kernel<4, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 5: spline_kernel<5, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 6: spline_kernel<6, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
    case 7: spline_kernel<7, kSource, V><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s); break;
  }
}

// vec: 4 when C is a multiple of 4 and coeffs is 16-byte aligned, else 1
template <Source kSource>
int launch_spline(const float* coeffs, const tio::Points& pts, const float* fill, float* out,
                  const Grid& s, int order, int vec, cudaStream_t st) {
  if (order < 2 || order > 7) return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    if (s.C % 4 != 0 || reinterpret_cast<uintptr_t>(coeffs) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    launch_spline_vec<kSource, 4>(coeffs, pts, fill, out, s, order, st);
  } else if (vec == 1) {
    launch_spline_vec<kSource, 1>(coeffs, pts, fill, out, s, order, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Dense coordinates: the spline on row_tiles.cuh's row tiles.

// One voxel's taps: per axis the order+1 basis weights, and the offsets
// in floats inside one element's coefficients: i taps times the plane's
// floats, j taps times the row's, k taps times C.
template <int T, typename Index>
struct Taps {
  float wi[T], wj[T], wk[T];
  Index i[T];
  int j[T], k[T];
};

// acc[u] += (wi wj) times the k-tap sum of each (i, j) row, for V channels
// from c0, each tap one V-wide load, in the plain version's order. Orders
// 4-7 run one i plane's code in a loop (no timed path takes them).
template <int kOrder, int V, typename Index>
__device__ __forceinline__ void sum_rows(const float* src, const Taps<kOrder + 1, Index>& t,
                                         int c0, float acc[V]) {
  constexpr int T = kOrder + 1;
#pragma unroll(kOrder <= 3 ? T : 1)
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const Index row = t.i[a] + (Index)(t.j[b] + c0);
      float x[V], kv[V];
      load_vec<V>(src + (row + t.k[0]), x);
#pragma unroll
      for (int u = 0; u < V; ++u) kv[u] = t.wk[0] * x[u];
#pragma unroll
      for (int d = 1; d < T; ++d) {
        load_vec<V>(src + (row + t.k[d]), x);
#pragma unroll
        for (int u = 0; u < V; ++u) kv[u] = kv[u] + t.wk[d] * x[u];
      }
      const float wij = t.wi[a] * t.wj[b];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = acc[u] + wij * kv[u];
    }
  }
}

// How a lane takes its kVec voxels of a k tile, one at a time: on kVec
// consecutive ko or a warp-width apart (kConsecutive, see tio::ko_of);
// kMinBlocks blocks an SM for __launch_bounds__ (at 4, 64 registers a
// thread); kInterior: spline_taps' fast path for coordinates and taps
// inside the volume. SplineCoords takes a voxel's row sums from L::sum,
// so a layout may bring another way to read the taps
// (probes/spline_coords_layout.cu does).
template <bool kConsecutive_, int kMinBlocks_, bool kInterior_>
struct CoordsLayout {
  static constexpr bool kConsecutive = kConsecutive_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr bool kInterior = kInterior_;

  template <int kOrder, int V, typename Index>
  __device__ __forceinline__ static void sum(const float* src,
                                             const Taps<kOrder + 1, Index>& t, int c0,
                                             float acc[V]) {
    sum_rows<kOrder, V>(src, t, c0, acc);
  }
};

struct CoordsArgs {
  const float* __restrict__ coeffs;  // channels-last (B, I, J, K, C)
  const float* __restrict__ fill;    // (B, C)
  float* __restrict__ out;           // (B, C, Io, Jo, Ko)
};

// The dense spline as row_tiles.cuh's Body: a lane's voxels of a k tile,
// one at a time: its point from the row's coordinates, its mask and taps,
// and per group of V channels its sum and store. Index: the offsets'
// type inside one element's coefficients. Orders 4-7 keep their weights
// in more registers: at most 2 blocks an SM (128 registers a thread).
template <int kOrder, int V, typename Index, class L>
struct SplineCoords {
  using Args = CoordsArgs;
  static constexpr int kMinBlocks =
      kOrder <= 3 || L::kMinBlocks < 2 ? L::kMinBlocks : 2;

  template <Source kSource, bool kStaged>
  __device__ __forceinline__ static void tile(const Args& args, const tio::Points& pts,
                                              const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane) {
    constexpr int T = kOrder + 1;
    const int64_t out_spatial = tio::out_spatial(s);
    const int64_t row_out = ((int64_t)row.io * s.Jo + row.jo) * s.Ko;
    const int row_floats = s.K * s.C;  // J K C < 2^31 (the wrapper checks)
    const Index plane_floats = (Index)s.J * row_floats;
    const float* src = opaque(args.coeffs + (int64_t)row.b * s.I * s.J * s.K * s.C);
#pragma unroll 1
    for (int v = 0; v < kVec; ++v) {
      const unsigned ko = ko_of<L>(k_first, lane, v);
      if (ko >= (unsigned)s.Ko) break;  // the later voxels lie further on
      float c[3];
      row.point(pts, s, ko, c);
      const float mask = inbounds(c[0], s.I) * inbounds(c[1], s.J) * inbounds(c[2], s.K);
      const bool use_fill = !(mask > 0.5f);
      Taps<T, Index> t;
      if (!use_fill) {
        int ti[T];
        dense_taps<kOrder, L::kInterior>(c[0], s.I, ti, t.wi);
        dense_taps<kOrder, L::kInterior>(c[1], s.J, t.j, t.wj);
        dense_taps<kOrder, L::kInterior>(c[2], s.K, t.k, t.wk);
#pragma unroll
        for (int d = 0; d < T; ++d) {
          t.i[d] = ti[d] * plane_floats;
          t.j[d] *= row_floats;
          t.k[d] *= s.C;
        }
      }
      for (int c0 = 0; c0 < s.C; c0 += V) {
        float acc[V];
        if (use_fill) {
#pragma unroll
          for (int u = 0; u < V; ++u) acc[u] = __ldg(args.fill + (int64_t)row.b * s.C + c0 + u);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) acc[u] = 0.0f;
          L::template sum<kOrder, V>(src, t, c0, acc);
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          opaque(args.out + ((int64_t)row.b * s.C + c0 + u) * out_spatial + row_out)[ko] = acc[u];
        }
      }
    }
  }
};

// The package's layout of the dense spline (see CoordsLayout).
using DenseSplineLayout = CoordsLayout<false, 4, true>;

template <int kOrder, int V, class L>
void launch_coords_as(const CoordsArgs& args, const tio::Points& pts, const Grid& s,
                      const Launch& l, cudaStream_t st) {
  if (l.wide) {
    tio::launch_rows<SplineCoords<kOrder, V, int64_t, L>, Source::kDense>(args, pts, s, l, st);
  } else {
    tio::launch_rows<SplineCoords<kOrder, V, int, L>, Source::kDense>(args, pts, s, l, st);
  }
}

template <int V, class L>
void launch_coords_vec(const CoordsArgs& args, const tio::Points& pts, const Grid& s,
                       const Launch& l, int order, cudaStream_t st) {
  switch (order) {
    case 2: launch_coords_as<2, V, L>(args, pts, s, l, st); break;
    case 3: launch_coords_as<3, V, L>(args, pts, s, l, st); break;
    case 4: launch_coords_as<4, V, L>(args, pts, s, l, st); break;
    case 5: launch_coords_as<5, V, L>(args, pts, s, l, st); break;
    case 6: launch_coords_as<6, V, L>(args, pts, s, l, st); break;
    case 7: launch_coords_as<7, V, L>(args, pts, s, l, st); break;
  }
}

// vec: 4 when C is a multiple of 4 and coeffs is 16-byte aligned, else 1
template <class L>
int launch_coords(const CoordsArgs& args, const tio::Points& pts, const Grid& s,
                  const Launch& l, int order, int vec, cudaStream_t st) {
  if (order < 2 || order > 7) return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    if (s.C % 4 != 0 || reinterpret_cast<uintptr_t>(args.coeffs) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    launch_coords_vec<4, L>(args, pts, s, l, order, st);
  } else if (vec == 1) {
    launch_coords_vec<1, L>(args, pts, s, l, order, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One axis pass of the prefilter over a volume viewed as (outer, n,
// stride); with channels C > 1 (the kColumns path only) the input is read
// as (outer, C, n, stride) and written as (outer, n, stride, C). kind,
// per_block, pitch and shared_bytes come from the plan
// (torchio_tpu_torch/ops/bspline_kernel.py prefilter_plan): 0 kGlobal, 1
// kLines, 2 kColumns. The pole constants come from the host
// (torchio_tpu_torch/ops/bspline.py pole_constants).
extern "C" int tio_prefilter_axis(const float* src, float* dst, long long outer, int n,
                                  long long stride, int channels, int kind, int per_block,
                                  int pitch, int shared_bytes, int count, const float* z,
                                  const int* horizon, const float* inv_denom,
                                  const float* anti, float lam, void* stream) {
  if (count < 0 || count > kMaxPoles || channels < 1) return (int)cudaErrorInvalidValue;
  if (channels > 1 && (kind != 2 || src == dst)) return (int)cudaErrorInvalidValue;
  const int64_t lines = (int64_t)outer * stride * channels;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    prefilter_global_kernel<<<tio::blocks_for(lines), kThreads, 0, st>>>(src, dst, lines, n,
                                                                         stride, p);
    return (int)cudaGetLastError();
  }
  if (per_block < 1 || per_block > 1024 || shared_bytes < 0 ||
      shared_bytes > kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (kind == 1) {
    // rows of `stride` interleaved lines, per_block / stride rows a block
    if (stride < 1 || stride > per_block || per_block % stride != 0 ||
        (int64_t)per_block * pitch * 4 > shared_bytes || pitch < n) {
      return (int)cudaErrorInvalidValue;
    }
    const int rows_per_block = per_block / (int)stride;
    const int64_t blocks = (outer + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t err = cudaFuncSetAttribute(
        prefilter_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    prefilter_lines_kernel<<<(unsigned)blocks, per_block, shared_bytes, st>>>(
        src, dst, outer, n, (int)stride, pitch, p);
    return (int)cudaGetLastError();
  }
  if (kind == 2) {
    if (per_block % channels != 0 || (int64_t)per_block * n * 4 > shared_bytes) {
      return (int)cudaErrorInvalidValue;
    }
    const int positions = per_block / channels;
    const int64_t slabs = (stride + positions - 1) / positions;
    const int64_t blocks = (int64_t)outer * slabs;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t err = cudaFuncSetAttribute(
        prefilter_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    prefilter_columns_kernel<<<(unsigned)blocks, per_block, shared_bytes, st>>>(
        src, dst, n, stride, channels, slabs, p);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// coeffs: channels-last (B, I, J, K, C) float32; vec: see launch_spline.
extern "C" int tio_bspline_resample(const float* coeffs, const float* maps,
                                    const float* fields, const float* fill,
                                    float* out, int B, int C, int I, int J, int K,
                                    int Io, int Jo, int Ko, int ni, int nj, int nk,
                                    float ri, float rj, float rk, int order, int vec,
                                    void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    return launch_spline<Source::kMapField>(coeffs, pts, fill, out, s, order, vec, st);
  }
  return launch_spline<Source::kMap>(coeffs, pts, fill, out, s, order, vec, st);
}

// coeffs as above; coords: (B or 1, Io, Jo, Ko, 3) float32;
// coord_batch_stride is Io*Jo*Ko*3 for per-element grids and 0 for one
// shared grid; vec: see launch_coords; gx, gy, gz, z_rows and wide: the
// launch plan (ops/bspline_kernel.py::coords_launch_plan, wide for
// I*J*K*C >= 2^31).
extern "C" int tio_bspline_coords(const float* coeffs, const float* coords,
                                  const float* fill, float* out, int B, int C,
                                  int I, int J, int K, int Io, int Jo, int Ko,
                                  long long coord_batch_stride, int order, int vec,
                                  int gx, int gy, int gz, int z_rows, int wide,
                                  void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, 0, 0, 0, 0.0f, 0.0f, 0.0f};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide, 0};
  const tio::Points pts{nullptr, nullptr, coords, (int64_t)coord_batch_stride};
  return launch_coords<DenseSplineLayout>({coeffs, fill, out}, pts, s, l, order, vec,
                                          static_cast<cudaStream_t>(stream));
}
