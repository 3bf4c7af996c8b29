// jax.random's threefry2x32 draws on NVIDIA Hopper (sm_90a): 32-bit
// words (jax.random.bits) and float32 standard normals
// (jax.random.normal), element for element as the JAX package draws them.
//
// Replaces no Pallas kernel: in the JAX package these draws are XLA ops,
// jax.random.normal in torchio_tpu/transforms/fuse.py:195-197 and
// intensity/noise.py:121-123 (Noise), and in
// torchio_tpu/transforms/intensity/bias_field.py:42 and :65 (BiasField). The
// plain versions are torchio_tpu_torch/random.py's bits_plain and
// normal_of_bits.
//
// What element e of a draw of n under the key (k0, k1) computes, in
// registers, one thread an element:
//   1. the counter pair (e >> 32, e & 0xFFFFFFFF): JAX's counter mode
//      (jax_threefry_partitionable), in which an element's bits depend
//      on its flat index alone;
//   2. threefry2x32 of the pair: 20 rounds of add, rotate (one
//      __funnelshift_l), xor, with the key schedule (k0, k1,
//      k0 ^ k1 ^ 0x1BD11BDA) injected after every 4; the word is x0 ^ x1;
//   3. for normals, jax.random.uniform on [nextafter(-1, 0), 1): the top
//      23 bits as a float in [1, 2), minus 1, times 2 plus lo (two
//      roundings), at least lo; then sqrt(2) * erf_inv(u), with Giles'
//      single-precision polynomial as XLA's ErfInv32 evaluates it:
//      w = -log1p(-u^2), Horner's rule on w - 2.5 (w < 5) or
//      sqrt(w) - 3, a separate multiply and add a step.
// Every multiply and add is an explicit __fmul_rn / __fadd_rn (and the
// file is built with -fmad=false), so nothing contracts into an FMA: the
// bits are equal to the plain version's, and the normals differ from it
// only where log1pf rounds differently from the host library's log1p.
//
// What bounds it on an H100: the writes are 4 bytes an element (268 MB
// for the headline's B=4 x 256^3 noise, 0.080 ms at 3.35 TB/s); the work
// is about 110 integer and float operations an element (20 rounds of 3,
// 6 key injections of 2-3, the uniform, log1pf, 8 Horner steps), 7.4 G
// operations at that size: the issue rate, not the memory, is the bound.
// So the kernel keeps everything in registers and reads nothing; 32-bit
// indexing below 2^31 elements leaves the counter's high word 0, and a
// 64-bit instantiation carries it past 2^32.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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

}  // namespace

extern "C" const char* tio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: n float32 normals (normal != 0) or n uint32 words, contiguous, on
// the current device; (k0, k1) the key
extern "C" int tio_threefry(void* out, unsigned k0, unsigned k1, long long n,
                            int normal, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (normal) {
    launch<true>(out, ks, n, blocks, st);
  } else {
    launch<false>(out, ks, n, blocks, st);
  }
  return (int)cudaGetLastError();
}
