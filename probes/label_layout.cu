// Probe: the row-tiled label vote of torchio_tpu_torch/csrc/label_resample.cu
// beside the kernel it replaced (one thread per output voxel over the flat
// (B, Io, Jo, Ko) index, 64-bit index division, the whole sample point a
// voxel, the corner labels read and the full vote taken for every voxel;
// its body kept here as it was), and the row-tiled vote in other layouts:
// uniform corners without the vote (Uniform), a lane's voxels on
// consecutive ko, and 2, 3 or 5 blocks an SM. Built and timed by
// probes/label_layout.py.

#include "../torchio_tpu_torch/csrc/label_resample.cu"

namespace {

template <typename T, bool kField>
__global__ void __launch_bounds__(tio::kThreads)
    flat_label_kernel(const T* __restrict__ vol, const float* __restrict__ maps,
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
void flat_launch(const void* vol, const float* maps, const float* fields, void* out,
                 const Grid& s, T pad_label, cudaStream_t stream) {
  const unsigned grid = tio::blocks_for((int64_t)s.B * tio::out_spatial(s));
  const T* in = static_cast<const T*>(vol);
  T* o = static_cast<T*>(out);
  if (fields != nullptr) {
    flat_label_kernel<T, true>
        <<<grid, tio::kThreads, 0, stream>>>(in, maps, fields, o, s, pad_label);
  } else {
    flat_label_kernel<T, false>
        <<<grid, tio::kThreads, 0, stream>>>(in, maps, fields, o, s, pad_label);
  }
}

// Where the 8 corners carry one label, that label without the vote: its
// score would be the in-bounds weight summed in the same order, so the
// result is the vote's bit for bit.
struct Uniform : VoteLayout<false, 4> {
  template <typename T, typename Index>
  __device__ __forceinline__ static T label(const T* __restrict__ src, float c[3],
                                            const Grid& s, T pad_label) {
    CornerLabels<T> q;
    if (!corner_labels<T, Index>(src, c, s, q)) return pad_label;
    bool uniform = true;
#pragma unroll
    for (int n = 1; n < 8; ++n) uniform &= q.lab[n] == q.lab[0];
    return uniform ? q.lab[0] : winner(q);
  }
};

template <class L>
void rows_as(const void* vol, const tio::Points& pts, void* out, const Grid& s,
             const Launch& l, int is_float, int pad_int, float pad_float, cudaStream_t st) {
  if (is_float) {
    launch<float, L>(vol, pts, out, s, l, pad_float, st);
  } else {
    launch<int, L>(vol, pts, out, s, l, pad_int, st);
  }
}

}  // namespace

// The replaced kernel; the arguments of tio_resample_label without the
// launch plan.
extern "C" int probe_label_flat(const void* vol, const float* maps, const float* fields,
                                void* out, int B, int I, int J, int K, int Io, int Jo,
                                int Ko, int ni, int nj, int nk, float ri, float rj, float rk,
                                float pad_float, int is_float, int pad_int, void* stream) {
  const Grid s{B, 1, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_float) {
    flat_launch<float>(vol, maps, fields, out, s, pad_float, st);
  } else {
    flat_launch<int>(vol, maps, fields, out, s, pad_int, st);
  }
  return (int)cudaGetLastError();
}

// The row-tiled vote in one of the layouts below (variant 0-5; 0 is the
// package's): the arguments and launch plan of tio_resample_label.
extern "C" int probe_label_rows(const void* vol, const float* maps, const float* fields,
                                void* out, int B, int I, int J, int K, int Io, int Jo,
                                int Ko, int ni, int nj, int nk, float ri, float rj, float rk,
                                float pad_float, int is_float, int pad_int, int gx, int gy,
                                int gz, int z_rows, int wide, int field_smem, int variant,
                                void* stream) {
  const Grid s{B, 1, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide,
                 field_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  const int f = is_float;
  switch (variant) {
    case 0: rows_as<LabelLayout>(vol, pts, out, s, l, f, pad_int, pad_float, st); break;
    case 1: rows_as<Uniform>(vol, pts, out, s, l, f, pad_int, pad_float, st); break;
    case 2:
      rows_as<VoteLayout<true, 4>>(vol, pts, out, s, l, f, pad_int, pad_float, st);
      break;
    case 3:
      rows_as<VoteLayout<false, 3>>(vol, pts, out, s, l, f, pad_int, pad_float, st);
      break;
    case 4:
      rows_as<VoteLayout<false, 2>>(vol, pts, out, s, l, f, pad_int, pad_float, st);
      break;
    case 5:
      rows_as<VoteLayout<false, 5>>(vol, pts, out, s, l, f, pad_int, pad_float, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
