// jax.random's threefry streams for Hopper (sm_90a): the bulk bits and
// a fused dropout.
//
// No TPU kernel is replaced: the JAX package draws these bits through
// jax.random, whose threefry2x32 XLA expands into integer ops
// (jax/_src/prng.py: threefry_2x32 :1092, rounds in
// _threefry2x32_lowering :883, the counter layout of
// _threefry_random_bits_partitionable :1184 under the installed
// default jax_threefry_partitionable=True). Element j of a draw over a
// flat shape hashes the counter pair (j >> 32, j & 0xffffffff) under
// the key (k0, k1) and keeps out0 ^ out1:
//   x = (hi + k0, lo + k1); 20 rounds of  x0 += x1; x1 = rotl(x1, r);
//   x1 ^= x0  with r cycling [13,15,26,6] and [17,29,16,24], the key
//   schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after every 4
//   rounds with the injection count s added to x1.
// The words are bit for bit those of jax.random.bits(key, shape) on the
// CPU; apex_tpu_torch/utils/prng.py holds the plain int64 version.
//
// Two entry points:
// - apx_threefry_bits: rows x n words, row r under its own key (the
//   decode tick's gumbel draw, one key per slot, as
//   jax.vmap(jax.random.categorical)(keys, logits) draws it), or every
//   row under one key passed by value.
// - apx_threefry_dropout: out = x * keep * s with keep = u < p, u the
//   uniform of the element's word, (word >> 9 | 0x3f800000) as a float
//   minus 1 (jax.random.uniform), p = fp32(1 - rate) and s =
//   fp32(1 / dtype(1 - rate)): what XLA compiles
//   x * jax.random.bernoulli(key, 1 - rate, x.shape) / (1 - rate) to
//   (the division by a constant becomes a multiply by its fp32
//   reciprocal; a bf16 x is widened, multiplied and rounded once).
//
// What bounds it on an H100: integer operations. An element's hash is
// 72 operations: 40 funnel shifts and xors and 32 adds (20 in the
// rounds, 12 injecting the key), plus the xor of its two words (and,
// for dropout, the shift and or that build the uniform), against 4 bytes
// written (bits) or 2-4 read and written (dropout). Shifts and logic ops
// run only on the integer ALU, 64 lanes an SM; the adds can run as
// IMAD on the FMA pipe beside them. So the ALU's 41 (bits) or 43
// (dropout) operations an element bound it: at 1.98 GHz on 132 SMs one
// (64, 128, 1024) bf16 dropout takes at least 0.0216 ms, its bytes
// 0.010 ms.
//
// Design: a grid-stride loop, one element's hash a thread at a time
// (each hash is a 72-op dependency chain; the many threads of a full
// grid hide its latency), rotations as one funnel shift each, 16-byte
// loads and stores of x and out where the pointers allow; the counter's
// high word is the constant 0 when a row holds at most 2^32 elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1 };
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds; returns out0 ^ out1.
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0, x1 = lo + k1;
#define APX_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;
#define APX_ROUNDS_A APX_ROUND(13) APX_ROUND(15) APX_ROUND(26) APX_ROUND(6)
#define APX_ROUNDS_B APX_ROUND(17) APX_ROUND(29) APX_ROUND(16) APX_ROUND(24)
  APX_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  APX_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  APX_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  APX_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  APX_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef APX_ROUNDS_B
#undef APX_ROUNDS_A
#undef APX_ROUND
  return x0 ^ x1;
}

template <bool kWide>
__device__ __forceinline__ uint32_t word_at(uint32_t k0, uint32_t k1,
                                            int64_t j) {
  return threefry_word(k0, k1, kWide ? static_cast<uint32_t>(j >> 32) : 0u,
                       static_cast<uint32_t>(j));
}

template <bool kWide>
__global__ void bits_kernel(const uint32_t* __restrict__ keys, uint32_t k0,
                            uint32_t k1, uint32_t* __restrict__ out,
                            int64_t n) {
  const int64_t row = blockIdx.y;
  if (keys != nullptr) {
    k0 = keys[2 * row];
    k1 = keys[2 * row + 1];
  }
  uint32_t* o = out + row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < n; j += stride)
    o[j] = word_at<kWide>(k0, k1, j);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

template <typename T, bool kWide>
__device__ __forceinline__ T drop(T x, int64_t j, uint32_t k0, uint32_t k1,
                                  float p, float s) {
  const uint32_t w = word_at<kWide>(k0, k1, j);
  const float u = __uint_as_float((w >> 9) | 0x3f800000u) - 1.0f;
  const float keep = u < p ? 1.0f : 0.0f;
  T y;
  narrow(__fmul_rn(__fmul_rn(widen(x), keep), s), &y);
  return y;
}

template <typename T> struct VecOf;   // elements in 16 bytes
template <> struct VecOf<float> { static constexpr int kN = 4; };
template <> struct VecOf<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T, bool kWide, bool kVec>
__global__ void dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                               int64_t n, uint32_t k0, uint32_t k1, float p,
                               float s) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (kVec) {
    constexpr int kN = VecOf<T>::kN;
    const int64_t nv = n / kN;
    for (int64_t v = tid; v < nv; v += stride) {
      uint4 raw = reinterpret_cast<const uint4*>(x)[v];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        e[i] = drop<T, kWide>(e[i], v * kN + i, k0, k1, p, s);
      reinterpret_cast<uint4*>(out)[v] = raw;
    }
    done = nv * kN;
  }
  for (int64_t j = done + tid; j < n; j += stride)
    out[j] = drop<T, kWide>(x[j], j, k0, k1, p, s);
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename T>
void launch_dropout(const void* x, void* out, int64_t n, uint32_t k0,
                    uint32_t k1, float p, float s, cudaStream_t st) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const bool wide = n > (int64_t{1} << 32);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int blocks = blocks_for(vec ? n / VecOf<T>::kN + 1 : n);
  if (wide && vec)
    dropout_kernel<T, true, true><<<blocks, kThreads, 0, st>>>(xi, o, n, k0,
                                                               k1, p, s);
  else if (wide)
    dropout_kernel<T, true, false><<<blocks, kThreads, 0, st>>>(xi, o, n, k0,
                                                                k1, p, s);
  else if (vec)
    dropout_kernel<T, false, true><<<blocks, kThreads, 0, st>>>(xi, o, n, k0,
                                                                k1, p, s);
  else
    dropout_kernel<T, false, false><<<blocks, kThreads, 0, st>>>(
        xi, o, n, k0, k1, p, s);
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out: (rows, n) uint32 words. keys: (rows, 2) uint32 on the device, or
// null for every row under (k0, k1). rows <= 65535 (the grid's y).
// Launches on `stream`; returns cudaGetLastError().
int apx_threefry_bits(const void* keys, unsigned k0, unsigned k1, void* out,
                      long long n, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 65535 || n < 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(blocks_for(n), rows);
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (n > (1ll << 32))
    bits_kernel<true><<<grid, kThreads, 0, st>>>(kp, k0, k1, o, n);
  else
    bits_kernel<false><<<grid, kThreads, 0, st>>>(kp, k0, k1, o, n);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n contiguous elements of dtype 0 fp32 / 1 bf16 (out may not
// alias x). p = fp32(1 - rate), s = fp32(1 / dtype(1 - rate)).
int apx_threefry_dropout(const void* x, void* out, long long n, int dtype,
                         unsigned k0, unsigned k1, float p, float s,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == kBF16)
    launch_dropout<__nv_bfloat16>(x, out, n, k0, k1, p, s, st);
  else
    launch_dropout<float>(x, out, n, k0, k1, p, s, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
