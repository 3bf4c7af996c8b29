// Partial-volume label resample of a (B, 1, I, J, K) label batch from
// per-element grid specs, for NVIDIA Hopper (sm_90a).
//
// Replaces the "corners" mode of the JAX package's Pallas resample
// kernels:
//   - torchio_tpu/ops/shear_resample.py  _kernel2 (shear_resample_label_fused)
//   - torchio_tpu/ops/window_resample.py _kernel  (window_resample_label_fused,
//     whose in-VMEM vote is _corner_vote)
// and their XLA reference torchio_tpu/ops/resample.py
// _resample_element_label. The TPU kernels gather the 8 corner-label
// planes through candidate-offset loops because the TPU has no fast
// gather; here each thread reads its 8 corners directly.
//
// One thread per output voxel (b, io, jo, ko), ko fastest:
//   1. the sample point (sample_point.cuh), size-1 axes forced to 0;
//   2. the 8 trilinear corner weights, zero for corners outside the
//      volume; the corner labels are read at clamped indices (a corner
//      with zero weight cannot win: a label's score is the summed weight
//      of the corners carrying it, and the winner's score is positive
//      whenever the in-bounds weight exceeds 0.5);
//   3. the vote, in registers: score each corner's label, summed in
//      corner order (di, dj, dk lexicographic) like the JAX package; the
//      top score wins and ties go to the smallest label;
//   4. pad_label where the summed in-bounds weight is <= 0.5.
// Labels stay in their working type (int32, or float32 for float label
// maps): an int32 label above 2^24 survives, which a float32 round trip
// would not. Built with -fmad=false (see sample_point.cuh).
//
// What bounds it on an H100: device-memory bytes, as for resample.cu:
// one 4-byte write per output voxel and one read of the source
// neighbourhood, the other corner reads hitting L1/L2. The vote is 64
// compare-and-adds in registers, far below the memory time.
//
// The launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <cfloat>
#include <climits>

#include "sample_point.cuh"

namespace {

using tio::Grid;
using tio::kThreads;

template <typename T>
__device__ __forceinline__ T largest();
template <>
__device__ __forceinline__ int largest<int>() {
  return INT_MAX;
}
template <>
__device__ __forceinline__ float largest<float>() {
  return __int_as_float(0x7f800000);  // +inf
}

template <typename T, bool kField>
__global__ void __launch_bounds__(kThreads)
    label_kernel(const T* __restrict__ vol, const float* __restrict__ maps,
                 const float* __restrict__ fields, T* __restrict__ out, Grid s,
                 T pad_label) {
  const int64_t in_spatial = tio::in_spatial(s);
  const int64_t total = (int64_t)s.B * tio::out_spatial(s);
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += (int64_t)gridDim.x * blockDim.x) {
    const tio::Voxel p = tio::voxel_of(v, s);
    float c[3];
    tio::sample_point<kField>(maps, fields, s, p, c);
    if (s.I == 1) c[0] = 0.0f;
    if (s.J == 1) c[1] = 0.0f;
    if (s.K == 1) c[2] = 0.0f;

    float wi[2], wj[2], wk[2];
    const int i0 = tio::axis_weights(c[0], s.I, wi[0], wi[1]);
    const int j0 = tio::axis_weights(c[1], s.J, wj[0], wj[1]);
    const int k0 = tio::axis_weights(c[2], s.K, wk[0], wk[1]);
    const T* src = vol + (int64_t)p.b * in_spatial;
    float w[8];
    T lab[8];
    float wsum = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int di = q >> 2, dj = (q >> 1) & 1, dk = q & 1;
      w[q] = wi[di] * wj[dj] * wk[dk];
      wsum = wsum + w[q];
      const int ii = min(max(i0 + di, 0), s.I - 1);
      const int jj = min(max(j0 + dj, 0), s.J - 1);
      const int kk = min(max(k0 + dk, 0), s.K - 1);
      lab[q] = __ldg(src + ((int64_t)ii * s.J + jj) * s.K + kk);
    }
    float score[8];
    float top = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (lab[r] == lab[q]) sum = sum + w[r];
      }
      score[q] = sum;
      top = q == 0 ? sum : fmaxf(top, sum);
    }
    T winner = largest<T>();
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (score[q] == top && lab[q] < winner) winner = lab[q];
    }
    out[v] = wsum > 0.5f ? winner : pad_label;
  }
}

template <typename T>
void launch(const void* vol, const float* maps, const float* fields, void* out,
            const Grid& s, T pad_label, cudaStream_t stream) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  const T* in = static_cast<const T*>(vol);
  T* o = static_cast<T*>(out);
  if (fields != nullptr) {
    label_kernel<T, true><<<grid, kThreads, 0, stream>>>(in, maps, fields, o, s, pad_label);
  } else {
    label_kernel<T, false><<<grid, kThreads, 0, stream>>>(in, maps, fields, o, s, pad_label);
  }
}

}  // namespace

// vol and out are int32 when is_float is 0, float32 otherwise; pad_int
// or pad_float is the fill of the matching type.
extern "C" int tio_resample_label(const void* vol, const float* maps,
                                  const float* fields, void* out, int B, int I,
                                  int J, int K, int Io, int Jo, int Ko, int ni,
                                  int nj, int nk, float ri, float rj, float rk,
                                  int is_float, int pad_int, float pad_float,
                                  void* stream) {
  const Grid s{B, 1, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) {
    launch<float>(vol, maps, fields, out, s, pad_float, st);
  } else {
    launch<int>(vol, maps, fields, out, s, pad_int, st);
  }
  return (int)cudaGetLastError();
}
