// Device code shared by the port's resample kernels (resample.cu,
// label_resample.cu, bspline.cu): the shape of a resample, the sample
// point of one output voxel (built from a grid spec, or read from a
// dense coordinate tensor), and the in-bounds linear weights.
//
// The sample point of output voxel (io, jo, ko) of element b is
// M_b [io, jo, ko, 1], summed ((i m0 + j m1) + k m2) + m3 in float32,
// plus the displacement upsampled from the coarse (ni, nj, nk, 3) field
// by lerps over i, then j, then k: the JAX package's operation order.
// Every file that includes this header is built with -fmad=false, so
// the coordinate rounds like the CPU and JAX versions and floor/rint
// flip at the same integer and half-integer coordinates.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tio {

constexpr int kThreads = 256;

struct Grid {
  int B, C, I, J, K;  // input
  int Io, Jo, Ko;     // output
  int ni, nj, nk;     // coarse field
  float ri, rj, rk;   // field upsampling ratios (n_in - 1) / (n_out - 1)
};

struct Voxel {
  int b, io, jo, ko;
};

__host__ __device__ __forceinline__ int64_t out_spatial(const Grid& s) {
  return (int64_t)s.Io * s.Jo * s.Ko;
}

__host__ __device__ __forceinline__ int64_t in_spatial(const Grid& s) {
  return (int64_t)s.I * s.J * s.K;
}

// Blocks of kThreads covering `total` items (a grid-stride loop covers
// the rest past the launch limit).
inline unsigned blocks_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < 0x7fffffff ? blocks : 0x7fffffff);
}

// Output voxel v of the flattened (B, Io, Jo, Ko) grid, ko fastest.
__device__ __forceinline__ Voxel voxel_of(int64_t v, const Grid& s) {
  const int64_t plane = (int64_t)s.Jo * s.Ko;
  Voxel p;
  p.ko = (int)(v % s.Ko);
  p.jo = (int)((v / s.Ko) % s.Jo);
  p.io = (int)((v / plane) % s.Io);
  p.b = (int)(v / out_spatial(s));
  return p;
}

__device__ __forceinline__ float lerp(float a0, float a1, float f) {
  return a0 * (1.0f - f) + a1 * f;
}

// Upsampling coordinate of output index `o` on a coarse axis of n points.
__device__ __forceinline__ void coarse_axis(int o, int n, float ratio, int& c0,
                                            int& c1, float& f) {
  const float g = (float)o * ratio;
  c0 = min(max((int)floorf(g), 0), n - 1);
  c1 = min(c0 + 1, n - 1);
  f = g - (float)c0;
}

// The input-voxel coordinate c[0..2] that output voxel p samples.
template <bool kField>
__device__ __forceinline__ void sample_point(const float* __restrict__ maps,
                                             const float* __restrict__ fields,
                                             const Grid& s, const Voxel& p,
                                             float c[3]) {
  const float* m = maps + (int64_t)p.b * 12;
  const float fio = (float)p.io, fjo = (float)p.jo, fko = (float)p.ko;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = fio * __ldg(m + 4 * a) + fjo * __ldg(m + 4 * a + 1) +
           fko * __ldg(m + 4 * a + 2) + __ldg(m + 4 * a + 3);
  }
  if (kField) {
    int i0, i1, j0, j1, k0, k1;
    float fi, fj, fk;
    coarse_axis(p.io, s.ni, s.ri, i0, i1, fi);
    coarse_axis(p.jo, s.nj, s.rj, j0, j1, fj);
    coarse_axis(p.ko, s.nk, s.rk, k0, k1, fk);
    const float* f = fields + (int64_t)p.b * s.ni * s.nj * s.nk * 3;
    const int ii[2] = {i0, i1}, jj[2] = {j0, j1}, kk[2] = {k0, k1};
    const int64_t stride_i = (int64_t)s.nj * s.nk * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float along_j[2];
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        float along_i[2];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          const int64_t row = ((int64_t)jj[dj] * s.nk + kk[dk]) * 3 + a;
          along_i[dj] = lerp(__ldg(f + ii[0] * stride_i + row),
                             __ldg(f + ii[1] * stride_i + row), fi);
        }
        along_j[dk] = lerp(along_i[0], along_i[1], fj);
      }
      c[a] = c[a] + lerp(along_j[0], along_j[1], fk);
    }
  }
}

// The input-voxel coordinate c[0..2] of output voxel p read from a dense
// (B or 1, Io, Jo, Ko, 3) float32 coordinate tensor; batch_stride is 0
// when one grid is shared by the batch.
__device__ __forceinline__ void read_point(const float* __restrict__ coords,
                                           int64_t batch_stride, const Grid& s,
                                           const Voxel& p, float c[3]) {
  const float* q = coords + (int64_t)p.b * batch_stride +
                   (((int64_t)p.io * s.Jo + p.jo) * s.Ko + p.ko) * 3;
  c[0] = __ldg(q);
  c[1] = __ldg(q + 1);
  c[2] = __ldg(q + 2);
}

// Where a kernel's sample points come from: a grid spec (map, with or
// without an elastic field) or a dense coordinate tensor.
enum class Source { kMap, kMapField, kDense };

struct Points {
  const float* maps;     // (B, 3, 4), grid specs
  const float* fields;   // (B, ni, nj, nk, 3) or null, grid specs
  const float* coords;   // (B or 1, Io, Jo, Ko, 3), dense
  int64_t batch_stride;  // of coords: Io*Jo*Ko*3, or 0 for a shared grid
};

template <Source kSource>
__device__ __forceinline__ void point_of(const Points& pts, const Grid& s,
                                         const Voxel& p, float c[3]) {
  if constexpr (kSource == Source::kDense) {
    read_point(pts.coords, pts.batch_stride, s, p, c);
  } else {
    sample_point<kSource == Source::kMapField>(pts.maps, pts.fields, s, p, c);
  }
}

// Floor index and the two in-bounds linear weights along one axis.
__device__ __forceinline__ int axis_weights(float c, int size, float& w0,
                                            float& w1) {
  // clamping keeps the int conversion defined; corners this far out
  // carry zero weight either way
  const int i0 = (int)fminf(fmaxf(floorf(c), -2.0f), (float)size + 1.0f);
  const float f = c - (float)i0;
  w0 = (i0 >= 0 && i0 < size) ? 1.0f - f : 0.0f;
  w1 = (i0 + 1 >= 0 && i0 + 1 < size) ? f : 0.0f;
  return i0;
}

}  // namespace tio

// Each kernel library is one translation unit that includes this header
// once, so each exports its own copy.
extern "C" const char* tio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
