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
// gather; here each lane reads its voxel's 8 corners directly.
//
// What each output voxel (b, io, jo, ko) computes:
//   1. the sample point (row_tiles.cuh's Row: the grid spec's map and
//      upsampled field in the JAX package's operation order), size-1 axes
//      forced to 0;
//   2. the 8 trilinear corner weights, zero for corners outside the
//      volume; pad_label where their sum is <= 0.5 (no label is read);
//   3. the corner labels, read at clamped indices (a corner with zero
//      weight cannot win: a label's score is the summed weight of the
//      corners carrying it, and the winner's score is positive whenever
//      the in-bounds weight exceeds 0.5);
//   4. the vote, in registers: each corner's label scored by the weights
//      of the corners that carry it, summed in corner order (di, dj, dk
//      lexicographic) like the JAX package; the top score wins and ties go
//      to the smallest label.
// Labels stay in their working type (int32, or float32 for float label
// maps): an int32 label above 2^24 survives, which a float32 round trip
// would not. Built with -fmad=false (see sample_point.cuh), so the kernel
// is bit-identical to its plain version (ops/resample.py::
// resample_label_plain).
//
// What bounded the first form of this kernel on an H100 (one thread per
// output voxel over the flat (B, Io, Jo, Ko) index, kept in
// probes/label_layout.cu) was not device-memory bytes: at brats'
// B=4 x 1 x 240x240x155 int32 with an elastic field it took 1.02 ms
// against 0.085 ms of bytes, as long a voxel as resample.cu's first form:
// 64-bit index division and the whole field upsample a voxel. Nor is it
// the vote: taking the full vote for every voxel costs no more than
// skipping it where the 8 corners carry one label (0.504-0.512 against
// 0.504-0.505 ms on brats' block labels, 77 % of whose voxels could skip
// it; 0.506-0.510 against 0.524-0.525 ms on labels drawn per voxel), so
// the package takes it for every voxel, without the branch.
//
// The design now is resample.cu's (row_tiles.cuh; each step measured by
// probes/label_layout.py, its numbers in PERF.md): a warp on one output
// row, the row's map and field lerps set up once (with the field
// upsampled whole a voxel: 0.81-0.84 ms), 32-bit offsets inside a volume
// below 2^31 voxels (a template parameter, 64-bit otherwise: 0.56 ms),
// a block's two k tiles of a row (one: 0.58 ms; a Ko = 155 row is one
// block's), a lane's voxels one at a time with a warp's lanes on
// consecutive ko (a lane's 4 consecutive ko: 0.69-0.75 ms), at 4 blocks
// an SM (64 registers, no spill; 3 or 2 blocks: 0.53-0.67 ms; 5 spill).
// What bounds it now, as resample.cu, is the latency of a lane's 8
// corner loads, which 32 warps an SM hide only in part: 0.51 ms against
// 0.085 ms of bytes.
//
// The launch goes on the caller's stream, allocates nothing, and returns
// cudaGetLastError().

#include <climits>

#include "row_tiles.cuh"

namespace {

using tio::clamp_index;
using tio::Grid;
using tio::kVec;
using tio::ko_of;
using tio::Launch;
using tio::opaque;
using tio::Row;
using tio::Source;

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

// One voxel's corners: the 8 trilinear weights (zero outside the volume)
// and the labels at the clamped corners.
template <typename T>
struct CornerLabels {
  float w[8];
  T lab[8];
};

// The corners of the voxel at point c of the (I, J, K) labels src, or
// false where the voxel takes pad_label (its in-bounds weight is <= 0.5;
// no label is read).
template <typename T, typename Index>
__device__ __forceinline__ bool corner_labels(const T* __restrict__ src, float c[3],
                                              const Grid& s, CornerLabels<T>& q) {
  // size-1 axes: every coordinate maps to index 0 with full weight
  if (s.I == 1) c[0] = 0.0f;
  if (s.J == 1) c[1] = 0.0f;
  if (s.K == 1) c[2] = 0.0f;
  float wi[2], wj[2], wk[2];
  const int i0 = tio::axis_weights(c[0], s.I, wi[0], wi[1]);
  const int j0 = tio::axis_weights(c[1], s.J, wj[0], wj[1]);
  const int k0 = tio::axis_weights(c[2], s.K, wk[0], wk[1]);
  float wsum = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    q.w[n] = wi[n >> 2] * wj[(n >> 1) & 1] * wk[n & 1];
    wsum = wsum + q.w[n];
  }
  if (!(wsum > 0.5f)) return false;
  const Index jk = (Index)s.J * s.K;
  const Index ii[2] = {clamp_index(i0, s.I), clamp_index(i0 + 1, s.I)};
  const Index jj[2] = {clamp_index(j0, s.J), clamp_index(j0 + 1, s.J)};
  const Index kk[2] = {clamp_index(k0, s.K), clamp_index(k0 + 1, s.K)};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    q.lab[n] = __ldg(src + ((ii[n >> 2] * jk + jj[(n >> 1) & 1] * (Index)s.K) + kk[n & 1]));
  }
  return true;
}

// The vote: each corner's label scored by the summed weight of the
// corners carrying it, in corner order; the top score wins, ties to the
// smallest label.
template <typename T>
__device__ __forceinline__ T winner(const CornerLabels<T>& q) {
  float score[8];
  float top = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (q.lab[r] == q.lab[n]) sum = sum + q.w[r];
    }
    score[n] = sum;
    top = n == 0 ? sum : fmaxf(top, sum);
  }
  T best = largest<T>();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (score[n] == top && q.lab[n] < best) best = q.lab[n];
  }
  return best;
}

// How a lane takes its kVec voxels of a k tile (one at a time, on kVec
// consecutive ko or a warp's lanes on consecutive ko), kMinBlocks blocks
// an SM, and a voxel's label. The kernel calls L::label, so a layout may
// bring another way to take it (probes/label_layout.cu does).
template <bool kConsecutive_, int kMinBlocks_>
struct VoteLayout {
  static constexpr bool kConsecutive = kConsecutive_;
  static constexpr int kMinBlocks = kMinBlocks_;

  template <typename T, typename Index>
  __device__ __forceinline__ static T label(const T* __restrict__ src, float c[3],
                                            const Grid& s, T pad_label) {
    CornerLabels<T> q;
    return corner_labels<T, Index>(src, c, s, q) ? winner(q) : pad_label;
  }
};

template <typename T>
struct VoteArgs {
  const T* __restrict__ vol;
  T* __restrict__ out;
  T pad_label;
};

// The vote as row_tiles.cuh's Body: a lane's voxels of a k tile, one at
// a time.
template <typename T, typename Index, class L>
struct Vote {
  using Args = VoteArgs<T>;
  static constexpr int kMinBlocks = L::kMinBlocks;

  template <Source kSource, bool kStaged>
  __device__ __forceinline__ static void tile(const Args& a, const tio::Points& pts,
                                              const Grid& s,
                                              const Row<kSource, kStaged>& row,
                                              unsigned k_first, unsigned lane) {
    const T* src = opaque(a.vol + (int64_t)row.b * tio::in_spatial(s));
    T* dst = opaque(a.out + (int64_t)row.b * tio::out_spatial(s) +
                    ((int64_t)row.io * s.Jo + row.jo) * s.Ko);
#pragma unroll 1
    for (int v = 0; v < kVec; ++v) {
      const unsigned ko = ko_of<L>(k_first, lane, v);
      if (ko >= (unsigned)s.Ko) break;  // the later voxels lie further on
      float c[3];
      row.point(pts, s, ko, c);
      dst[ko] = L::template label<T, Index>(src, c, s, a.pad_label);
    }
  }
};

template <typename T, typename Index, class L>
void launch_as(const void* vol, const tio::Points& pts, void* out, const Grid& s,
               const Launch& l, T pad_label, cudaStream_t stream) {
  const VoteArgs<T> args{static_cast<const T*>(vol), static_cast<T*>(out), pad_label};
  if (pts.fields != nullptr) {
    tio::launch_rows<Vote<T, Index, L>, Source::kMapField>(args, pts, s, l, stream);
  } else {
    tio::launch_rows<Vote<T, Index, L>, Source::kMap>(args, pts, s, l, stream);
  }
}

template <typename T, class L>
void launch(const void* vol, const tio::Points& pts, void* out, const Grid& s,
            const Launch& l, T pad_label, cudaStream_t stream) {
  if (l.wide) {
    launch_as<T, int64_t, L>(vol, pts, out, s, l, pad_label, stream);
  } else {
    launch_as<T, int, L>(vol, pts, out, s, l, pad_label, stream);
  }
}

// The package's layout (see VoteLayout): a warp's lanes on consecutive
// ko, 4 blocks an SM.
using LabelLayout = VoteLayout<false, 4>;

}  // namespace

// vol and out are int32 when is_float is 0, float32 otherwise; pad_int
// or pad_float is the fill of the matching type. gx .. field_smem are the
// launch plan of ops/resample_kernel.py::resample_launch_plan.
extern "C" int tio_resample_label(const void* vol, const float* maps,
                                  const float* fields, void* out, int B, int I,
                                  int J, int K, int Io, int Jo, int Ko, int ni,
                                  int nj, int nk, float ri, float rj, float rk,
                                  float pad_float, int is_float, int pad_int, int gx,
                                  int gy, int gz, int z_rows, int wide, int field_smem,
                                  void* stream) {
  const Grid s{B, 1, I, J, K, Io, Jo, Ko, ni, nj, nk, ri, rj, rk};
  if ((int64_t)B * Io * Jo * Ko == 0) return 0;
  const Launch l{(unsigned)gx, (unsigned)gy, (unsigned)gz, (unsigned)z_rows, wide,
                 field_smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tio::Points pts{maps, fields, nullptr, 0};
  if (is_float) {
    launch<float, LabelLayout>(vol, pts, out, s, l, pad_float, st);
  } else {
    launch<int, LabelLayout>(vol, pts, out, s, l, pad_int, st);
  }
  return (int)cudaGetLastError();
}
