// Probe: the forms of the threefry kernel of
// torchio_tpu_torch/csrc/threefry.cu, timed in one command by
// probes/threefry_layout.py:
//   - replaced: the kernel it replaced (one thread an element over a
//     grid-stride loop, erf_inv selecting each coefficient, every add on
//     the ALU pipe), kept here as it was;
//   - the package's kernel (threefry::segments_kernel);
//   - a copy of its skeleton (probe::segments_kernel) in each Probe form
//     below: elements a thread, which adds are multiply-adds by a runtime
//     1 (IMAD, the FMA pipe), whether x0's injection folds into the next
//     round's add, the rotate as a 64-bit product (IMAD.WIDE) or a funnel
//     shift, how the uniform is formed, and erf_inv's tail by selects, by
//     a branch an element or by one branch for a thread's elements.

#include "../torchio_tpu_torch/csrc/threefry.cu"

namespace replaced {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr uint32_t kKeyParity = 0x1BD11BDAu;
// nextafterf(-1, 0) = -(1 - 2^-24): jax.random.normal's lower bound
constexpr float kNormalLo = -0x1.fffffep-1f;
constexpr float kSqrt2 = 1.41421356237309515f;

struct Schedule {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

__device__ __forceinline__ void rounds_a(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 13);
  mix(x0, x1, 15);
  mix(x0, x1, 26);
  mix(x0, x1, 6);
}

__device__ __forceinline__ void rounds_b(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, 17);
  mix(x0, x1, 29);
  mix(x0, x1, 16);
  mix(x0, x1, 24);
}

// threefry2x32 of the counter pair (hi, lo); returns x0 ^ x1
__device__ __forceinline__ uint32_t threefry_word(const Schedule& ks, uint32_t hi,
                                                  uint32_t lo) {
  uint32_t x0 = hi + ks.k0;
  uint32_t x1 = lo + ks.k1;
  rounds_a(x0, x1);
  x0 += ks.k1;
  x1 += ks.k2 + 1u;
  rounds_b(x0, x1);
  x0 += ks.k2;
  x1 += ks.k0 + 2u;
  rounds_a(x0, x1);
  x0 += ks.k0;
  x1 += ks.k1 + 3u;
  rounds_b(x0, x1);
  x0 += ks.k1;
  x1 += ks.k2 + 4u;
  rounds_a(x0, x1);
  x0 += ks.k2;
  x1 += ks.k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float horner(float p, float w, bool lt, float below,
                                        float above) {
  return __fadd_rn(lt ? below : above, __fmul_rn(p, w));
}

// Giles' single-precision erf_inv, step for step as XLA's ErfInv32
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = horner(p, w, lt, 3.43273939e-07f, 0.000100950558f);
  p = horner(p, w, lt, -3.5233877e-06f, 0.00134934322f);
  p = horner(p, w, lt, -4.39150654e-06f, -0.00367342844f);
  p = horner(p, w, lt, 0.00021858087f, 0.00573950773f);
  p = horner(p, w, lt, -0.00125372503f, -0.0076224613f);
  p = horner(p, w, lt, -0.00417768164f, 0.00943887047f);
  p = horner(p, w, lt, 0.246640727f, 1.00167406f);
  p = horner(p, w, lt, 1.50140941f, 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_of(uint32_t word) {
  const float floats = __fsub_rn(__uint_as_float((word >> 9) | 0x3F800000u), 1.0f);
  const float span = __fsub_rn(1.0f, kNormalLo);
  const float u = fmaxf(kNormalLo, __fadd_rn(__fmul_rn(floats, span), kNormalLo));
  return __fmul_rn(kSqrt2, erf_inv(u));
}

// Index: uint32_t below 2^31 elements (the counter's high word is 0, and
// e + stride never wraps), uint64_t past it
template <typename Index, bool kNormal>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(void* __restrict__ out, Schedule ks, Index n) {
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index e = (Index)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const uint32_t hi = sizeof(Index) > 4 ? (uint32_t)((uint64_t)e >> 32) : 0u;
    const uint32_t word = threefry_word(ks, hi, (uint32_t)e);
    if constexpr (kNormal) {
      static_cast<float*>(out)[e] = normal_of(word);
    } else {
      static_cast<uint32_t*>(out)[e] = word;
    }
  }
}

template <bool kNormal>
void launch(void* out, const Schedule& ks, long long n, int blocks,
            cudaStream_t stream) {
  if (n < (1ll << 31)) {
    threefry_kernel<uint32_t, kNormal><<<blocks, kThreads, 0, stream>>>(out, ks, (uint32_t)n);
  } else {
    threefry_kernel<uint64_t, kNormal><<<blocks, kThreads, 0, stream>>>(out, ks, (uint64_t)n);
  }
}

// the replaced kernel's entry, as it was
int launch_replaced(void* out, unsigned k0, unsigned k1, long long n, int normal,
               cudaStream_t stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long needed = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(needed < (long long)sms * kBlocksPerSm ? needed
                                                                  : (long long)sms * kBlocksPerSm);
  const Schedule ks{k0, k1, k0 ^ k1 ^ kKeyParity};
  if (normal) {
    launch<true>(out, ks, n, blocks, stream);
  } else {
    launch<false>(out, ks, n, blocks, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace replaced

namespace probe {

using threefry::head_of;
using threefry::kMaxSegments;
using threefry::kSqrt2;
using threefry::kThreads;
using threefry::poly_above;
using threefry::poly_below;
using threefry::rotation;
using threefry::Segment;
using threefry::Table;

__device__ __forceinline__ float horner(float p, float w, bool lt, float below, float above) {
  return __fadd_rn(lt ? below : above, __fmul_rn(p, w));
}

// erf_inv's polynomial at w[i] = -log1p(-u[i]^2) for n elements: the
// w < 5 branch for all of them, and the tail's polynomial (w >= 5, 0.34 %
// of draws) only where a thread holds one, behind one branch for the n.
template <int kN>
__device__ __forceinline__ void poly_once(const float (&w)[kN], float (&p)[kN]) {
  bool tail = false;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    p[i] = poly_below(__fsub_rn(w[i], 2.5f));
    tail |= !(w[i] < 5.0f);
  }
  if (tail) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (!(w[i] < 5.0f)) p[i] = poly_above(__fsub_rn(sqrtf(w[i]), 3.0f));
    }
  }
}

// A form of the segmented kernel: the hooks of the skeleton below.
//   kVec: elements a thread; kRoundImad, kInjectImad: a round's x0 += x1,
//   and the key injections, as a * one + b; kFused: x0's injection folded
//   into the next round's add (x0 + x1 + c); kWideRotate: rotl(x1, r) ^ x0
//   as the two halves of x1 * 2^r (a runtime power) xor x0; kUniform: the
//   uniform as (m - 1) * 2 + lo from m in [1, 2) by a shift and an or (0)
//   or by hi(word * 2^23) plus the exponent (1), or as 2m - 2 + lo from 2m
//   in [2, 4) (2, threefry::uniform_of); kTail: erf_inv's tail by selects
//   (0, as the replaced kernel), by a branch an element (1), or by one branch for a
//   thread's elements (2, poly_once).
template <int kVec_, bool kRoundImad, bool kInjectImad, bool kFused, bool kWideRotate,
          int kUniform, int kTail>
struct Probe {
  static constexpr int kVec = kVec_;
  __device__ static __forceinline__ uint32_t round_add(uint32_t a, uint32_t b, uint32_t one) {
    return kRoundImad ? a * one + b : a + b;
  }
  __device__ static __forceinline__ uint32_t inject(uint32_t a, uint32_t b, uint32_t one) {
    return kInjectImad ? a * one + b : a + b;
  }
  __device__ static __forceinline__ uint32_t boundary_add(uint32_t x0, uint32_t x1, uint32_t c,
                                                          uint32_t one) {
    return kFused ? x0 + x1 + c : round_add(inject(x0, c, one), x1, one);
  }
  __device__ static __forceinline__ uint32_t rotate_xor(uint32_t x1, uint32_t x0, int r,
                                                        uint32_t one) {
    if constexpr (kWideRotate) {
      const uint64_t p = (uint64_t)x1 * (one << r);
      return (uint32_t)p ^ (uint32_t)(p >> 32) ^ x0;
    } else {
      return __funnelshift_l(x1, x1, r) ^ x0;
    }
  }
  __device__ static __forceinline__ float uniform(uint32_t word, uint32_t one) {
    if constexpr (kUniform == 2) {
      return threefry::uniform_of(word);
    } else {
      const uint32_t bits = kUniform == 1
                                ? (uint32_t)(((uint64_t)word * (one << 23)) >> 32) + 0x3F800000u
                                : (word >> 9) | 0x3F800000u;
      const float floats = __fsub_rn(__uint_as_float(bits), 1.0f);
      return __fadd_rn(__fmul_rn(floats, 2.0f), threefry::kNormalLo);
    }
  }
  __device__ static __forceinline__ float poly_one(float w) {
    if constexpr (kTail == 1) {
      if (w < 5.0f) return poly_below(__fsub_rn(w, 2.5f));
      return poly_above(__fsub_rn(sqrtf(w), 3.0f));
    } else {
      const bool lt = w < 5.0f;
      w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
      float p = lt ? 2.81022636e-08f : -0.000200214257f;
      p = horner(p, w, lt, 3.43273939e-07f, 0.000100950558f);
      p = horner(p, w, lt, -3.5233877e-06f, 0.00134934322f);
      p = horner(p, w, lt, -4.39150654e-06f, -0.00367342844f);
      p = horner(p, w, lt, 0.00021858087f, 0.00573950773f);
      p = horner(p, w, lt, -0.00125372503f, -0.0076224613f);
      p = horner(p, w, lt, -0.00417768164f, 0.00943887047f);
      p = horner(p, w, lt, 0.246640727f, 1.00167406f);
      return horner(p, w, lt, 1.50140941f, 2.83297682f);
    }
  }
  template <int kN>
  __device__ static __forceinline__ void poly(const float (&w)[kN], float (&p)[kN]) {
    if constexpr (kTail == 2) {
      poly_once(w, p);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) p[i] = poly_one(w[i]);
    }
  }
};

// The package kernel's skeleton (csrc/threefry.cu) with F's hooks.
// threefry2x32 of the counter pair (hi, lo) under seg's key; returns
// x0 ^ x1. kWide: hi may be nonzero. x0's injection after groups 0-3 and
// the next group's first add are one step (F::boundary_add), so that a
// form may fold them into one three-input add.
template <class F, bool kWide>
__device__ __forceinline__ uint32_t word_of(const Segment& seg, uint32_t one, uint32_t hi,
                                            uint32_t lo) {
  uint32_t x0 = kWide ? hi + seg.k0 : seg.k0;
  uint32_t x1 = lo + seg.k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = g > 0 && i == 0 ? F::boundary_add(x0, x1, seg.inject[2 * g - 2], one)
                           : F::round_add(x0, x1, one);
      x1 = F::rotate_xor(x1, x0, rotation(g, i), one);
    }
    x1 = F::inject(x1, seg.inject[2 * g + 1], one);
  }
  return F::inject(x0, seg.inject[8], one) ^ x1;
}

// sqrt(2) * erf_inv(u) * scale for kN words' uniforms u (|u| < 1)
template <class F, int kN>
__device__ __forceinline__ void normals_of(const uint32_t (&word)[kN], float scale,
                                           uint32_t one, float (&out)[kN]) {
  float u[kN], w[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    u[i] = F::uniform(word[i], one);
    w[i] = -log1pf(__fmul_rn(-u[i], u[i]));
  }
  F::poly(w, out);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    out[i] = __fmul_rn(__fmul_rn(kSqrt2, __fmul_rn(out[i], u[i])), scale);
  }
}

// Element e of seg into dst[e] (dst: the segment's first element)
template <class F, bool kNormal, typename Index>
__device__ __forceinline__ void scalar_element(void* dst, const Segment& seg, uint32_t one,
                                               Index e) {
  const uint32_t w =
      probe::word_of<F, (sizeof(Index) > 4)>(seg, one, (uint32_t)((uint64_t)e >> 32),
                                             (uint32_t)e);
  if constexpr (kNormal) {
    const uint32_t word[1] = {w};
    float r[1];
    probe::normals_of<F>(word, seg.scale, one, r);
    static_cast<float*>(dst)[e] = r[0];
  } else {
    static_cast<uint32_t*>(dst)[e] = w;
  }
}

// Index: uint32_t when every segment of the launch is below 2^31
// elements (the counter's high word is 0, and no index wraps), uint64_t
// otherwise. A block serves one segment: its head (threads 0-2 of the
// segment's first block), its vectors of F::kVec elements at a stride of
// the segment's blocks, and its tail (threads 32-34 of the first block).
// The table stays in the parameter space (__grid_constant__: no copy to
// local memory for the segment's index).
template <class F, bool kNormal, typename Index>
__global__ void __launch_bounds__(kThreads)
    segments_kernel(void* __restrict__ out, const __grid_constant__ Table table) {
  int s = 0;
  while (s + 1 < table.nseg && (int)blockIdx.x >= table.seg[s + 1].first_block) ++s;
  const Segment& seg = table.seg[s];
  const uint32_t one = table.one;
  constexpr int kVec = F::kVec;
  constexpr bool kWide = sizeof(Index) > 4;
  void* dst = static_cast<uint32_t*>(out) + seg.offset;
  const Index head = (Index)head_of(dst, seg.count);
  const Index vectors = ((Index)seg.count - head) / kVec;
  const Index block = (Index)(blockIdx.x - seg.first_block);
  if (block == 0) {
    const Index tail = ((Index)seg.count - head) % kVec;
    if (threadIdx.x < head) {
      probe::scalar_element<F, kNormal>(dst, seg, one, (Index)threadIdx.x);
    } else if (threadIdx.x >= 32 && threadIdx.x - 32 < tail) {
      probe::scalar_element<F, kNormal>(dst, seg, one,
                                        head + vectors * kVec + (threadIdx.x - 32));
    }
  }
  const Index stride = (Index)seg.blocks * kThreads;
  for (Index v = block * kThreads + threadIdx.x; v < vectors; v += stride) {
    const Index e = head + v * kVec;
    uint32_t w[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const Index ei = e + i;
      w[i] = probe::word_of<F, kWide>(seg, one, (uint32_t)((uint64_t)ei >> 32),
                                      (uint32_t)ei);
    }
    if constexpr (kNormal) {
      float r[kVec];
      probe::normals_of<F>(w, seg.scale, one, r);
      if constexpr (kVec == 4) {
        *reinterpret_cast<float4*>(static_cast<float*>(dst) + e) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
        static_cast<float*>(dst)[e] = r[0];
      }
    } else if constexpr (kVec == 4) {
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(dst) + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      static_cast<uint32_t*>(dst)[e] = w[0];
    }
  }
}

// Blocks of segments_kernel<F, kNormal, Index> resident on an SM
// (asked once an instantiation)
template <class F, bool kNormal, typename Index>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, segments_kernel<F, kNormal, Index>, kThreads, 0) != cudaSuccess ||
        n < 1) {
      n = 1;
    }
    cached = n;
  }
  return cached;
}

template <class F, bool kNormal, typename Index>
int launch_kernel(void* out, Table& table, int sms, cudaStream_t stream) {
  long long mine[kMaxSegments], vectors = 0;
  for (int s = 0; s < table.nseg; ++s) {
    const Segment& seg = table.seg[s];
    const long long head = head_of(static_cast<uint32_t*>(out) + seg.offset, seg.count);
    mine[s] = (seg.count - head) / F::kVec + 1;
    vectors += mine[s];
  }
  const long long resident = (long long)sms * probe::blocks_per_sm<F, kNormal, Index>();
  long long first = 0;
  for (int s = 0; s < table.nseg; ++s) {
    Segment& seg = table.seg[s];
    const long long needed = (mine[s] + kThreads - 1) / kThreads;
    const long long share = (resident * mine[s] + vectors - 1) / vectors;
    seg.blocks = (int)(share < needed ? share : needed);
    seg.first_block = (int)first;
    first += seg.blocks;
  }
  segments_kernel<F, kNormal, Index><<<(unsigned)first, kThreads, 0, stream>>>(out, table);
  return (int)cudaGetLastError();
}

// Launches F's kernel on segments[0, nseg): gives each segment a share
// of the resident blocks in proportion to its vectors, at least one
// block and at most a block for every kThreads vectors.
template <class F>
int launch(void* out, const Segment* segments, int nseg, int normal, cudaStream_t stream) {
  if (nseg <= 0) return 0;
  if (nseg > kMaxSegments) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  Table table;
  table.nseg = nseg;
  table.one = 1u;
  long long most = 0;
  for (int s = 0; s < nseg; ++s) {
    table.seg[s] = segments[s];
    most = segments[s].count > most ? segments[s].count : most;
  }
  if (most >= (1ll << 31)) {
    return normal ? probe::launch_kernel<F, true, uint64_t>(out, table, sms, stream)
                  : probe::launch_kernel<F, false, uint64_t>(out, table, sms, stream);
  }
  return normal ? probe::launch_kernel<F, true, uint32_t>(out, table, sms, stream)
                : probe::launch_kernel<F, false, uint32_t>(out, table, sms, stream);
}

// the first forms, then three steps from imad_both (the package's kernel
// is imad_both with the uniform of threefry::uniform_of: imad_both_u24)
//                      vec round  inject fused  wide   uniform tail
using Alu = Probe<4, false, false, false, false, 0, 1>;
using Select = Probe<4, false, false, false, false, 0, 0>;
using Single = Probe<1, false, false, false, false, 0, 1>;
using ImadRound = Probe<4, true, false, false, false, 0, 1>;
using ImadInject = Probe<4, false, true, false, false, 0, 1>;
using ImadBoth = Probe<4, true, true, false, false, 0, 1>;
using ImadRoundHi = Probe<4, true, false, false, false, 1, 1>;
using Wide = Probe<4, false, false, false, true, 0, 1>;
using WideImadRound = Probe<4, true, false, false, true, 0, 1>;
using ImadBothOnce = Probe<4, true, true, false, false, 0, 2>;
using ImadBothU24 = Probe<4, true, true, false, false, 2, 1>;
using ImadFused = Probe<4, true, true, true, false, 0, 1>;
using ImadFusedU24Once = Probe<4, true, true, true, false, 2, 2>;

}  // namespace probe

using namespace probe;

// probes/threefry_layout.py's FORMS, in order
extern "C" int probe_threefry(int form, void* out, const threefry::Segment* segments, int nseg,
                              int normal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return threefry::launch(out, segments, nseg, normal, st);
    case 1: return probe::launch<Alu>(out, segments, nseg, normal, st);
    case 2: return probe::launch<Select>(out, segments, nseg, normal, st);
    case 3: return probe::launch<Single>(out, segments, nseg, normal, st);
    case 4: return probe::launch<ImadRound>(out, segments, nseg, normal, st);
    case 5: return probe::launch<ImadInject>(out, segments, nseg, normal, st);
    case 6: return probe::launch<ImadBoth>(out, segments, nseg, normal, st);
    case 7: return probe::launch<ImadRoundHi>(out, segments, nseg, normal, st);
    case 8: return probe::launch<Wide>(out, segments, nseg, normal, st);
    case 9: return probe::launch<WideImadRound>(out, segments, nseg, normal, st);
    case 10: return probe::launch<ImadBothOnce>(out, segments, nseg, normal, st);
    case 11: return probe::launch<ImadBothU24>(out, segments, nseg, normal, st);
    case 12: return probe::launch<ImadFused>(out, segments, nseg, normal, st);
    case 13: return probe::launch<ImadFusedU24Once>(out, segments, nseg, normal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int probe_threefry_replaced(void* out, unsigned k0, unsigned k1, long long n,
                                       int normal, void* stream) {
  return replaced::launch_replaced(out, k0, k1, n, normal, static_cast<cudaStream_t>(stream));
}
