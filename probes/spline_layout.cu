// Probe: the grid-spec spline kernel of torchio_tpu_torch/csrc/bspline.cu,
// which reads channels-last (B, I, J, K, C) coefficients, V channels a
// tap in one load, beside the kernel it replaced (one channel a load from
// planar (B, C, I, J, K) coefficients, its body kept here as it was) and
// the tiled shared-memory design that was tried and lost to both. Built
// and timed by probes/spline_layout.py.

#include <climits>

#include "../torchio_tpu_torch/csrc/bspline.cu"

namespace {

template <int kOrder, Source kSource>
__global__ void __launch_bounds__(kThreads)
    spline_planar_kernel(const float* __restrict__ coeffs, tio::Points pts,
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

// The tiled design that lost to both kernels above: a block owns a
// V x 16 x 16 output tile (V = 4 at order 3, each thread V voxels along
// i), computes its voxels' points, masks, first taps and weights once,
// reduces the taps' box of unreflected indices, and stages that box of
// each channel's planar coefficients in shared memory (mirrored into the
// volume as it loads), double-buffered across channels with cp.async. A
// box of up to twice box_floats is single-buffered; a larger one reads
// its taps from device memory. mode 1 skips the box loads (the sums read
// whatever shared memory holds) and mode 2 also the sums: the ablations
// that time the setup and the loads.
constexpr int kTileJ = 16, kTileK = 16, kTileThreads = kTileJ * kTileK, kTileV = 4;

// The first (unreflected) tap of coordinate c on an axis of n samples,
// as spline_taps places it.
template <int kOrder>
__device__ __forceinline__ int first_tap(float c, int n) {
  const float cf = fold_mirror(c, n);
  const float base = (kOrder % 2 == 0) ? floorf(cf + 0.5f) : floorf(cf);
  return (int)(base - (float)(kOrder / 2));
}

// Copy the box [lo, lo + dim) of unreflected indices of one channel into
// shared memory (k fastest), each index reflected into the volume: one
// warp per box row.
__device__ __forceinline__ void load_box(float* box, const float* __restrict__ src,
                                         const Grid& s, const int lo[3], const int dim[3]) {
  constexpr int kWarps = kTileThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < dim[0] * dim[1]; row += kWarps) {
    const int bi = row / dim[1], bj = row % dim[1];
    const float* g = src + ((int64_t)reflect_index(lo[0] + bi, s.I) * s.J +
                            reflect_index(lo[1] + bj, s.J)) * s.K;
    for (int k = lane; k < dim[2]; k += 32) {
      copy4_async(box + row * dim[2] + k, g + reflect_index(lo[2] + k, s.K));
    }
  }
}

// One voxel's sum for one channel, in the plain version's order, from the
// box (p at the voxel's first tap) or from device memory.
template <int T>
__device__ __forceinline__ float box_sum(const float* p, int si, int sj, const float* wi,
                                         const float* wj, const float* wk) {
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < T; ++a) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const float* row = p + (a * si + b * sj);
      float kv = wk[0] * row[0];
#pragma unroll
      for (int d = 1; d < T; ++d) kv = kv + wk[d] * row[d];
      acc = acc + (wi[a] * wj[b]) * kv;
    }
  }
  return acc;
}

template <int T>
__device__ __forceinline__ float volume_sum(const float* __restrict__ src, const Grid& s,
                                            const int first[3], const float* wi,
                                            const float* wj, const float* wk) {
  int tk[T];
#pragma unroll
  for (int d = 0; d < T; ++d) tk[d] = reflect_index(first[2] + d, s.K);
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < T; ++a) {
    const int ri = reflect_index(first[0] + a, s.I);
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const float* row = src + ((int64_t)ri * s.J + reflect_index(first[1] + b, s.J)) * s.K;
      float kv = wk[0] * __ldg(row + tk[0]);
#pragma unroll
      for (int d = 1; d < T; ++d) kv = kv + wk[d] * __ldg(row + tk[d]);
      acc = acc + (wi[a] * wj[b]) * kv;
    }
  }
  return acc;
}

template <int kOrder, Source kSource>
__global__ void __launch_bounds__(kTileThreads, 3)
    spline_tile_kernel(const float* __restrict__ coeffs, tio::Points pts,
                       const float* __restrict__ fill, float* __restrict__ out, Grid s,
                       int tiles_i, int box_floats, int mode, int* branch_counts) {
  constexpr int T = kOrder + 1, V = kTileV;
  extern __shared__ float box[];
  __shared__ int bounds[6];  // smallest first tap per axis, then largest last tap
  const int tk0 = (int)blockIdx.x * kTileK, tj0 = (int)blockIdx.y * kTileJ;
  const int ti0 = (int)(blockIdx.z % tiles_i) * V, b = (int)(blockIdx.z / tiles_i);
  if (threadIdx.x < 6) bounds[threadIdx.x] = threadIdx.x < 3 ? INT_MAX : INT_MIN;
  __syncthreads();
  const int jo = tj0 + (int)threadIdx.x / kTileK, ko = tk0 + (int)threadIdx.x % kTileK;
  int first[V][3];
  float wi[V][T], wj[V][T], wk[V][T];
  bool live[V], use_fill[V];
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int io = ti0 + v;
    live[v] = io < s.Io && jo < s.Jo && ko < s.Ko;
    use_fill[v] = true;
    if (!live[v]) continue;
    float c[3];
    tio::point_of<kSource>(pts, s, tio::Voxel{b, io, jo, ko}, c);
    const float mask = inbounds(c[0], s.I) * inbounds(c[1], s.J) * inbounds(c[2], s.K);
    use_fill[v] = !(mask > 0.5f);
    if (use_fill[v]) continue;
    int idx[T];
    spline_taps<kOrder>(c[0], s.I, idx, wi[v]);
    spline_taps<kOrder>(c[1], s.J, idx, wj[v]);
    spline_taps<kOrder>(c[2], s.K, idx, wk[v]);
    first[v][0] = first_tap<kOrder>(c[0], s.I);
    first[v][1] = first_tap<kOrder>(c[1], s.J);
    first[v][2] = first_tap<kOrder>(c[2], s.K);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = min(lo[a], first[v][a]);
      hi[a] = max(hi[a], first[v][a] + kOrder);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      lo[a] = min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      atomicMin(bounds + a, lo[a]);
      atomicMax(bounds + 3 + a, hi[a]);
    }
  }
  __syncthreads();
  int dim[3];
  int64_t size = 1;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = bounds[a];
    dim[a] = bounds[a] <= bounds[3 + a] ? bounds[3 + a] - bounds[a] + 1 : 0;
    size *= dim[a];
  }
  // 2: double-buffered box; 1: single-buffered; 0: taps from device memory
  const int branch = size <= box_floats ? 2 : (size <= 2 * (int64_t)box_floats ? 1 : 0);
  if (branch_counts != nullptr && threadIdx.x == 0) atomicAdd(branch_counts + branch, 1);
  const bool load = mode == 0;
  const int64_t in_spatial = tio::in_spatial(s), out_spatial = tio::out_spatial(s);
  const int64_t out_base =
      (int64_t)b * s.C * out_spatial + ((int64_t)ti0 * s.Jo + jo) * s.Ko + ko;
  const int64_t plane = (int64_t)s.Jo * s.Ko;
  const float* channel0 = coeffs + (int64_t)b * s.C * in_spatial;
  if (branch == 2 && load) {
    load_box(box, channel0, s, lo, dim);
    __pipeline_commit();
  }
  for (int ch = 0; ch < s.C; ++ch) {
    const float* src = channel0 + (int64_t)ch * in_spatial;
    int buffer = 0;  // this channel's box in shared memory
    if (branch == 2) {
      buffer = (ch & 1) * box_floats;
      if (ch + 1 < s.C && load) {
        load_box(box + (box_floats - buffer), src + in_spatial, s, lo, dim);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    } else if (branch == 1) {
      if (load) load_box(box, src, s, lo, dim);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    const float f = __ldg(fill + (int64_t)b * s.C + ch);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!live[v]) continue;
      float acc = 0.0f;
      if (use_fill[v]) {
        acc = f;
      } else if (mode == 2) {
        acc = 0.0f;  // setup only
      } else if (branch) {
        const int at = ((first[v][0] - lo[0]) * dim[1] + (first[v][1] - lo[1])) * dim[2] +
                       (first[v][2] - lo[2]);
        acc = box_sum<T>(box + buffer + at, dim[1] * dim[2], dim[2], wi[v], wj[v], wk[v]);
      } else {
        acc = volume_sum<T>(src, s, first[v], wi[v], wj[v], wk[v]);
      }
      out[out_base + (int64_t)ch * out_spatial + v * plane] = acc;
    }
    // every thread is done with this buffer before it is loaded again
    if (branch) __syncthreads();
  }
}

template <Source kSource>
int launch_tiles(const float* coeffs, const tio::Points& pts, const float* fill, float* out,
                 const Grid& s, int box_floats, int mode, int* branch_counts,
                 cudaStream_t st) {
  const int tiles_i = (s.Io + kTileV - 1) / kTileV;
  const dim3 grid((s.Ko + kTileK - 1) / kTileK, (s.Jo + kTileJ - 1) / kTileJ, s.B * tiles_i);
  const int bytes = 2 * box_floats * (int)sizeof(float);
  auto kernel = spline_tile_kernel<3, kSource>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTileThreads, bytes, st>>>(coeffs, pts, fill, out, s, tiles_i, box_floats,
                                            mode, branch_counts);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiled kernel at order 3 on planar coefficients, grid specs;
// branch_counts (3 ints, may be null) counts the tiles of each branch.
extern "C" int probe_spline_tiled(const float* coeffs, const float* maps, const float* fields,
                                  const float* fill, float* out, int B, int C, int I, int J,
                                  int K, int Io, int Jo, int Ko, int ni, int nj, int nk,
                                  float ri, float rj, float rk, int box_floats, int mode,
                                  int* branch_counts, void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  if (box_floats < 1 || 2 * (int64_t)box_floats * 4 > kMaxSharedBytes ||
      (int64_t)B * ((Io + kTileV - 1) / kTileV) > 65535 || (Jo + kTileJ - 1) / kTileJ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    return launch_tiles<Source::kMapField>(coeffs, pts, fill, out, s, box_floats, mode,
                                           branch_counts, st);
  }
  return launch_tiles<Source::kMap>(coeffs, pts, fill, out, s, box_floats, mode,
                                    branch_counts, st);
}

// The planar kernel at order 3 (the brats path's order), grid specs.
extern "C" int probe_spline_planar(const float* coeffs, const float* maps, const float* fields,
                                   const float* fill, float* out, int B, int C, int I, int J,
                                   int K, int Io, int Jo, int Ko, int ni, int nj, int nk,
                                   float ri, float rj, float rk, void* stream) {
  const Grid s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const unsigned grid = tio::blocks_for((int64_t)B * tio::out_spatial(s));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (fields != nullptr) {
    spline_planar_kernel<3, Source::kMapField><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s);
  } else {
    spline_planar_kernel<3, Source::kMap><<<grid, kThreads, 0, st>>>(coeffs, pts, fill, out, s);
  }
  return (int)cudaGetLastError();
}
