// Trilinear / nearest resample of a (B, C, I, J, K) float32 batch from
// per-element grid specs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's resample path, in their
// linear and nearest modes:
//   - torchio_tpu/ops/shear_resample.py  _kernel2       (the resample)
//   - torchio_tpu/ops/shear_resample.py  _shear_kernel  (its integer
//     row pre-shear; folded in: this kernel reads source voxels directly)
//   - torchio_tpu/ops/window_resample.py _kernel        (bounded-offset
//     elastic maps with K <= 128)
// The TPU needs the pre-shear, the 128-lane gathers, the candidate loops
// and the per-tile bounds because it has no fast gather. Hopper has one,
// so the whole family is one gather kernel.
//
// One thread per output voxel (b, io, jo, ko), ko fastest:
//   1. the sample point M_b [io, jo, ko, 1], summed ((i m0 + j m1) + k m2)
//      + m3 in float32, plus the displacement upsampled from the coarse
//      (ni, nj, nk, 3) field by lerps over i, then j, then k -- the JAX
//      package's operation order;
//   2. the 8 trilinear corner weights (zero for corners outside the
//      volume), or the rounded corner in nearest mode (rintf: half to
//      even, like jnp.round);
//   3. the same weights for every channel; where the summed in-bounds
//      weight is <= 0.5 the voxel takes fill[b, c] (also in nearest
//      mode), unless apply_fill is 0 (a zero scalar fill keeps the
//      boundary's partial sums).
// The file is built with -fmad=false: a fused multiply-add would round
// the coordinate differently from the CPU and JAX versions and flip
// floor/rint at integer and half-integer coordinates.
//
// What bounds it on an H100: device-memory bytes. Per output voxel and
// channel it writes one float and reads the source neighbourhood once
// from device memory; the other corner reads of neighbouring threads hit
// L1/L2, since neighbouring output voxels sample neighbouring input
// voxels under the near-identity maps of augmentation. No tensor-core
// work applies. One thread per voxel with cached corner reads is the
// simple, correct first form; tiling the source into shared memory with
// TMA and vectorising along k are later work.
//
// Offsets are 64-bit: B*C*I*J*K passes 2^31 at realistic sizes. The
// launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Shape {
  int B, C, I, J, K;     // input
  int Io, Jo, Ko;        // output
  int ni, nj, nk;        // coarse field
  float ri, rj, rk;      // field upsampling ratios (n_in - 1) / (n_out - 1)
};

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

template <bool kNearest, bool kField>
__global__ void __launch_bounds__(kThreads)
    resample_kernel(const float* __restrict__ vol, const float* __restrict__ maps,
                    const float* __restrict__ fields,
                    const float* __restrict__ fill, float* __restrict__ out,
                    Shape s, int apply_fill) {
  const int64_t plane = (int64_t)s.Jo * s.Ko;
  const int64_t out_spatial = (int64_t)s.Io * plane;
  const int64_t in_spatial = (int64_t)s.I * s.J * s.K;
  const int64_t total = (int64_t)s.B * out_spatial;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const int ko = (int)(v % s.Ko);
    const int jo = (int)((v / s.Ko) % s.Jo);
    const int io = (int)((v / plane) % s.Io);
    const int b = (int)(v / out_spatial);

    const float* m = maps + (int64_t)b * 12;
    const float fio = (float)io, fjo = (float)jo, fko = (float)ko;
    float c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      c[a] = fio * __ldg(m + 4 * a) + fjo * __ldg(m + 4 * a + 1) +
             fko * __ldg(m + 4 * a + 2) + __ldg(m + 4 * a + 3);
    }
    if (kField) {
      int i0, i1, j0, j1, k0, k1;
      float fi, fj, fk;
      coarse_axis(io, s.ni, s.ri, i0, i1, fi);
      coarse_axis(jo, s.nj, s.rj, j0, j1, fj);
      coarse_axis(ko, s.nk, s.rk, k0, k1, fk);
      const float* f = fields + (int64_t)b * s.ni * s.nj * s.nk * 3;
      const int ii[2] = {i0, i1}, jj[2] = {j0, j1}, kk[2] = {k0, k1};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float along_j[2];
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          float along_i[2];
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const int64_t row = ((int64_t)jj[dj] * s.nk + kk[dk]) * 3 + a;
            const int64_t stride_i = (int64_t)s.nj * s.nk * 3;
            along_i[dj] = lerp(__ldg(f + ii[0] * stride_i + row),
                               __ldg(f + ii[1] * stride_i + row), fi);
          }
          along_j[dk] = lerp(along_i[0], along_i[1], fj);
        }
        c[a] = c[a] + lerp(along_j[0], along_j[1], fk);
      }
    }
    // size-1 axes: every coordinate maps to index 0 with full weight
    if (s.I == 1) c[0] = 0.0f;
    if (s.J == 1) c[1] = 0.0f;
    if (s.K == 1) c[2] = 0.0f;

    float wi[2], wj[2], wk[2];
    const int i0 = axis_weights(c[0], s.I, wi[0], wi[1]);
    const int j0 = axis_weights(c[1], s.J, wj[0], wj[1]);
    const int k0 = axis_weights(c[2], s.K, wk[0], wk[1]);
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

template <bool kNearest, bool kField>
void launch(const float* vol, const float* maps, const float* fields,
            const float* fill, float* out, const Shape& s, int apply_fill,
            cudaStream_t stream) {
  const int64_t total = (int64_t)s.B * s.Io * s.Jo * s.Ko;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 0x7fffffff ? blocks : 0x7fffffff);
  resample_kernel<kNearest, kField>
      <<<grid, kThreads, 0, stream>>>(vol, maps, fields, fill, out, s, apply_fill);
}

}  // namespace

extern "C" int tio_resample(const float* vol, const float* maps,
                            const float* fields, const float* fill, float* out,
                            int B, int C, int I, int J, int K, int Io, int Jo,
                            int Ko, int ni, int nj, int nk, float ri, float rj,
                            float rk, int nearest, int apply_fill,
                            void* stream) {
  const Shape s{B, C, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool field = fields != nullptr;
  if (nearest) {
    if (field) launch<true, true>(vol, maps, fields, fill, out, s, apply_fill, st);
    else launch<true, false>(vol, maps, fields, fill, out, s, apply_fill, st);
  } else {
    if (field) launch<false, true>(vol, maps, fields, fill, out, s, apply_fill, st);
    else launch<false, false>(vol, maps, fields, fill, out, s, apply_fill, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
