// The threefry kernel of csrc/threefry.cu as it was before strided segments
// (an 88-byte Segment with a counter base, every segment one run of
// counters), kept verbatim below so that chip_smoke.py's parallel phase can
// time the kernel's contiguous draw at start = 0 against this one in the
// same process.
//
// jax.random's threefry2x32 draws on NVIDIA Hopper (sm_90a): 32-bit
// words (jax.random.bits) and float32 standard normals
// (jax.random.normal), element for element as the JAX package draws them,
// for a list of draws (segments) in one launch.
//
// Replaces no Pallas kernel: in the JAX package these draws are XLA ops,
// jax.random.normal in torchio_tpu/transforms/fuse.py:195-197 and
// intensity/noise.py:121-123 (Noise), and in
// torchio_tpu/transforms/intensity/bias_field.py:42 and :65 (BiasField). The
// plain versions are torchio_tpu_torch/random.py's bits_plain,
// normal_of_bits and normals_plain.
//
// What element e of segment s (key (k0, k1), n_s elements, counter base
// start_s) computes, in registers:
//   1. the counter pair (c >> 32, c & 0xFFFFFFFF) of c = start_s + e:
//      JAX's counter mode (jax_threefry_partitionable), in which an
//      element's bits depend on its flat index alone, so a segment's
//      words are those of a separate draw, and a segment with a start is
//      elements [start, start + n) of a larger draw (a rank's batch rows
//      of a draw of the whole batch);
//   2. threefry2x32 of the pair: 20 rounds of add, rotate, xor, with the
//      key schedule injected after every 4 (the ten injected words,
//      k2 = k0 ^ k1 ^ 0x1BD11BDA plus the group's index, summed on the
//      host: ops/threefry_kernel.py::segment_plan); the word is x0 ^ x1;
//   3. for normals, jax.random.uniform on [nextafter(-1, 0), 1): the top
//      23 bits as a float in [1, 2), minus 1, times 2 plus lo (two
//      roundings); then sqrt(2) * erf_inv(u), with Giles'
//      single-precision polynomial as XLA's ErfInv32 evaluates it:
//      w = -log1p(-u^2), Horner's rule on w - 2.5 (w < 5) or
//      sqrt(w) - 3, a separate multiply and add a step; then times the
//      segment's scale (1 where the draw has none: exact).
// Every float multiply and add is an explicit __fmul_rn / __fadd_rn (and
// the file is built with -fmad=false), so nothing contracts into an FMA:
// the words are equal to the plain version's, and the normals differ
// from it only where log1pf rounds differently from the host library's
// log1p. u lies in [lo, 1 - 3 * 2^-24]: the uniform's max(lo, .) and
// erf_inv's +-1 edge never apply, and the kernel leaves them out.
//
// What bounds it on an H100: the writes are 4 bytes an element (268 MB
// for the headline's B=4 x 256^3 noise, 0.080 ms at 3.35 TB/s); the work
// is about 100 operations an element, 73 of them 32-bit integer adds,
// rotates and xors. An SM sub-partition issues one warp instruction a
// clock; its integer ALU pipe has 16 lanes, so an ALU instruction holds
// that pipe for two clocks; the FMA pipe (which also takes IMAD) has two
// halves of 16. The kernel this one replaced ran every integer operation
// and erf_inv's nine coefficient selects on the ALU pipe, and the ALU set
// its pace. What this form does about it (probes/threefry_layout.py
// times it against the forms that lost):
//   - every integer add is written as a multiply-add by a 1 the compiler
//     cannot fold (Table::one), which ptxas issues as IMAD on the FMA pipe;
//     the ALU keeps the rotates (SHF) and xors (LOP3);
//   - a thread takes four consecutive elements, with one 16-byte store
//     (a segment's unaligned head and its tail are scalar), so the loop
//     control and addresses are paid once for four;
//   - erf_inv branches on the tail (w >= 5, 0.34 % of draws; about 10 %
//     of warps) instead of selecting each coefficient;
//   - the uniform takes one float operation fewer (uniform_of);
//   - a block serves one segment: it finds it once, by its index, and
//     walks the segment's vectors at a stride of the segment's blocks.
// 32-bit indexing below 2^31 elements leaves the counter's high word 0
// (x0 starts at k0); a 64-bit instantiation carries it past 2^32.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace threefry {

constexpr int kThreads = 256;
// blocks resident on an SM: 2,048 threads at up to 32 registers each
constexpr int kBlocksPerSm = 8;
// elements of a thread's 16-byte store
constexpr int kVec = 4;
// Segments a launch takes: the table is a kernel parameter, under the
// 4 KB that every CUDA version accepts (ops/threefry_kernel.py's
// MAX_SEGMENTS splits a longer list into launches of this many).
constexpr int kMaxSegments = 46;
// nextafterf(-1, 0) = -(1 - 2^-24): jax.random.normal's lower bound
constexpr float kNormalLo = -0x1.fffffep-1f;
constexpr float kSqrt2 = 1.41421356237309515f;

// One draw of a launch, as ops/threefry_kernel.py's _Row lays it out.
struct Segment {
  uint32_t k0, k1;      // the key: x0 = hi + k0, x1 = lo + k1
  uint32_t inject[10];  // after group g of 4 rounds: x0 += inject[2 g], x1 += inject[2 g + 1]
  long long offset;     // the draw's first element in out
  long long count;      // its elements
  long long start;      // the counter of its first element
  float scale;          // each normal times scale
  int first_block;      // its first block and its blocks (set by launch below)
  int blocks;
};

struct Table {
  int nseg;
  uint32_t one;  // 1, unknown to the compiler: a * one + b is an IMAD
  Segment seg[kMaxSegments];
};

static_assert(sizeof(Segment) == 88, "ops/threefry_kernel.py's _Row mirrors Segment");
static_assert(sizeof(Table) <= 4096, "the table is a kernel parameter");

// The elements of a segment at dst (4-byte aligned) before its first
// 16-byte aligned one, at most count
__host__ __device__ __forceinline__ long long head_of(const void* dst, long long count) {
  const long long head = (long long)((16 - ((uintptr_t)dst & 15)) & 15) / 4;
  return head < count ? head : count;
}

// threefry2x32's rotation of round i in group g: (13, 15, 26, 6) in even
// groups, (17, 29, 16, 24) in odd ones
__host__ __device__ constexpr int rotation(int g, int i) {
  return g & 1 ? (i == 0 ? 17 : i == 1 ? 29 : i == 2 ? 16 : 24)
               : (i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : 6);
}

// a + b as a multiply-add by the launch's 1: an IMAD, on the FMA pipe
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t one) {
  return a * one + b;
}

__device__ __forceinline__ float step(float p, float w, float c) {
  return __fadd_rn(c, __fmul_rn(p, w));
}

// Giles' erf_inv on w < 5 (w - 2.5 given) and on w >= 5 (sqrt(w) - 3)
__device__ __forceinline__ float poly_below(float w) {
  float p = 2.81022636e-08f;
  p = step(p, w, 3.43273939e-07f);
  p = step(p, w, -3.5233877e-06f);
  p = step(p, w, -4.39150654e-06f);
  p = step(p, w, 0.00021858087f);
  p = step(p, w, -0.00125372503f);
  p = step(p, w, -0.00417768164f);
  p = step(p, w, 0.246640727f);
  return step(p, w, 1.50140941f);
}

__device__ __forceinline__ float poly_above(float w) {
  float p = -0.000200214257f;
  p = step(p, w, 0.000100950558f);
  p = step(p, w, 0.00134934322f);
  p = step(p, w, -0.00367342844f);
  p = step(p, w, 0.00573950773f);
  p = step(p, w, -0.0076224613f);
  p = step(p, w, 0.00943887047f);
  p = step(p, w, 1.00167406f);
  return step(p, w, 2.83297682f);
}

// The uniform of a word on [nextafter(-1, 0), 1), as jax.random.uniform
// maps it: the top 23 bits as the mantissa of m in [1, 2), then
// (m - 1) * 2 + lo with two roundings. (m - 1) * 2 is exact, so it is
// written as 2m - 2 from the same bits with exponent 1 (2m in [2, 4)):
// one subtract where m - 1 and the multiply were two.
__device__ __forceinline__ float uniform_of(uint32_t word) {
  return __fadd_rn(__fsub_rn(__uint_as_float((word >> 9) | 0x40000000u), 2.0f), kNormalLo);
}

// threefry2x32 of the counter pair (hi, lo) under seg's key; returns
// x0 ^ x1. kWide: hi may be nonzero.
template <bool kWide>
__device__ __forceinline__ uint32_t word_of(const Segment& seg, uint32_t one, uint32_t hi,
                                            uint32_t lo) {
  uint32_t x0 = kWide ? hi + seg.k0 : seg.k0;
  uint32_t x1 = lo + seg.k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = add(x0, x1, one);
      x1 = __funnelshift_l(x1, x1, rotation(g, i)) ^ x0;
    }
    x0 = add(x0, seg.inject[2 * g], one);
    x1 = add(x1, seg.inject[2 * g + 1], one);
  }
  return x0 ^ x1;
}

// erf_inv's polynomial at w = -log1p(-u^2): a branch on the tail
__device__ __forceinline__ float poly(float w) {
  if (w < 5.0f) return poly_below(__fsub_rn(w, 2.5f));
  return poly_above(__fsub_rn(sqrtf(w), 3.0f));
}

// sqrt(2) * erf_inv(u) * scale for kN words' uniforms u (|u| < 1)
template <int kN>
__device__ __forceinline__ void normals_of(const uint32_t (&word)[kN], float scale,
                                           float (&out)[kN]) {
  float u[kN], w[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    u[i] = uniform_of(word[i]);
    w[i] = -log1pf(__fmul_rn(-u[i], u[i]));
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) out[i] = poly(w[i]);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    out[i] = __fmul_rn(__fmul_rn(kSqrt2, __fmul_rn(out[i], u[i])), scale);
  }
}

// Element e of seg (counter base + e) into dst[e] (dst: the segment's
// first element)
template <bool kNormal, typename Index>
__device__ __forceinline__ void scalar_element(void* dst, const Segment& seg, uint32_t one,
                                               Index base, Index e) {
  const Index c = base + e;
  const uint32_t w =
      word_of<(sizeof(Index) > 4)>(seg, one, (uint32_t)((uint64_t)c >> 32), (uint32_t)c);
  if constexpr (kNormal) {
    const uint32_t word[1] = {w};
    float r[1];
    normals_of(word, seg.scale, r);
    static_cast<float*>(dst)[e] = r[0];
  } else {
    static_cast<uint32_t*>(dst)[e] = w;
  }
}

// Index: uint32_t when every segment's start + count of the launch is
// below 2^31 (the counter's high word is 0, and no index wraps), uint64_t
// otherwise. A block serves one segment: its head (threads 0-2 of the
// segment's first block), its vectors of kVec elements at a stride of
// the segment's blocks, and its tail (threads 32-34 of the first block).
// The table stays in the parameter space (__grid_constant__: no copy to
// local memory for the segment's index).
template <bool kNormal, typename Index>
__global__ void __launch_bounds__(kThreads)
    segments_kernel(void* __restrict__ out, const __grid_constant__ Table table) {
  int s = 0;
  while (s + 1 < table.nseg && (int)blockIdx.x >= table.seg[s + 1].first_block) ++s;
  const Segment& seg = table.seg[s];
  const uint32_t one = table.one;
  constexpr bool kWide = sizeof(Index) > 4;
  void* dst = static_cast<uint32_t*>(out) + seg.offset;
  const Index head = (Index)head_of(dst, seg.count);
  const Index vectors = ((Index)seg.count - head) / kVec;
  const Index block = (Index)(blockIdx.x - seg.first_block);
  const Index base = (Index)seg.start;
  if (block == 0) {
    const Index tail = ((Index)seg.count - head) % kVec;
    if (threadIdx.x < head) {
      scalar_element<kNormal>(dst, seg, one, base, (Index)threadIdx.x);
    } else if (threadIdx.x >= 32 && threadIdx.x - 32 < tail) {
      scalar_element<kNormal>(dst, seg, one, base, head + vectors * kVec + (threadIdx.x - 32));
    }
  }
  const Index stride = (Index)seg.blocks * kThreads;
  for (Index v = block * kThreads + threadIdx.x; v < vectors; v += stride) {
    const Index e = head + v * kVec;
    const Index c = base + e;  // the vector's first counter
    uint32_t w[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const Index ci = c + i;
      w[i] = word_of<kWide>(seg, one, (uint32_t)((uint64_t)ci >> 32), (uint32_t)ci);
    }
    if constexpr (kNormal) {
      float r[kVec];
      normals_of(w, seg.scale, r);
      *reinterpret_cast<float4*>(static_cast<float*>(dst) + e) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(dst) + e) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Gives each segment a share of the resident blocks in proportion to its
// vectors, at least one block and at most a block for every kThreads
// vectors, and launches.
template <bool kNormal, typename Index>
int launch_kernel(void* out, Table& table, int sms, cudaStream_t stream) {
  long long mine[kMaxSegments], vectors = 0;
  for (int s = 0; s < table.nseg; ++s) {
    const Segment& seg = table.seg[s];
    const long long head = head_of(static_cast<uint32_t*>(out) + seg.offset, seg.count);
    mine[s] = (seg.count - head) / kVec + 1;
    vectors += mine[s];
  }
  const long long resident = (long long)sms * kBlocksPerSm;
  long long first = 0;
  for (int s = 0; s < table.nseg; ++s) {
    Segment& seg = table.seg[s];
    const long long needed = (mine[s] + kThreads - 1) / kThreads;
    const long long share = (resident * mine[s] + vectors - 1) / vectors;
    seg.blocks = (int)(share < needed ? share : needed);
    seg.first_block = (int)first;
    first += seg.blocks;
  }
  segments_kernel<kNormal, Index><<<(unsigned)first, kThreads, 0, stream>>>(out, table);
  return (int)cudaGetLastError();
}

// The kernel on segments[0, nseg)
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
    const long long end = segments[s].start + segments[s].count;
    most = end > most ? end : most;
  }
  if (most >= (1ll << 31)) {
    return normal ? launch_kernel<true, uint64_t>(out, table, sms, stream)
                  : launch_kernel<false, uint64_t>(out, table, sms, stream);
  }
  return normal ? launch_kernel<true, uint32_t>(out, table, sms, stream)
                : launch_kernel<false, uint32_t>(out, table, sms, stream);
}

}  // namespace threefry

extern "C" const char* tio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: the segments' float32 normals (normal != 0) or uint32 words, each
// at its offset, contiguous, 4-byte aligned, on the current device;
// segments: nseg (<= kMaxSegments) host-side Segment rows, first_block
// and blocks unset
extern "C" int tio_threefry_segments(void* out, const threefry::Segment* segments, int nseg,
                                     int normal, void* stream) {
  return threefry::launch(out, segments, nseg, normal, static_cast<cudaStream_t>(stream));
}
