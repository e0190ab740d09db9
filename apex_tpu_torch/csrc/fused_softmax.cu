// Scaled masked softmax (padding mask, causal mask) and its backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/transformer/functional/
// fused_softmax.py: _masked_fwd_kernel (launched by _sms_fwd),
// _causal_fwd_kernel (launched by _sut_fwd) and _bwd_kernel (launched by
// _bwd_call). Same contract, per row of sk scores:
//   z  = x * scale                                  (fp32)
//   z  = -10000 where masked (mask != 0; causal: key k > query q)
//   y  = exp(z - max z) / sum exp(z - max z)        (stored in x's dtype)
//   dx = (scale * (dy - sum(y * dy))) * y           (fp32, stored in y's dtype)
// The mask constant is not scaled and is not -inf, so a row masked
// everywhere comes out uniform, 1 / sk. The padding mask is read through
// strides (batch, head, query, key): BERT's (b, 1, 1, sk) mask is read
// with stride 0 over heads and queries and never expanded in memory.
//
// What bounds it on an H100: bytes. Each row is read once and written once
// (the backward reads two rows), against about five operations a score.
// At BERT-Large's (64, 16, 128, 128) bf16 the forward moves 67 MB and the
// backward 101 MB: 20 and 30 us at 3.35 TB/s.
//
// Design. Rows whose length is a multiple of one 16-byte vector (8 bf16 or
// fp16, 4 fp32) and at most 8 vectors a thread (sk <= 2048 bf16, 1024
// fp32) take the register path: a group of tpr = 1..32 threads (a power of
// two) owns a row, each thread loads whole 16-byte vectors, keeps its part
// of the row in registers, and the group reduces the max and the sum by
// warp shuffles; a warp holds 32 / tpr rows (two at sk = 128 in bf16). Any
// other sk takes the generic path: a warp a row, three sweeps over the row
// in global memory (max, sum, write), scalar loads. Arithmetic is fp32
// throughout (expf, an IEEE division for y).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1, kF16 = 2 };
constexpr int kThreads = 128;
constexpr float kMaskValue = -10000.f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// N values of T loaded or stored as one vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Where one row's mask lives: base + k * sk_stride (int32 or uint8).
struct MaskRow {
  const void* base;
  int64_t sk_stride;
  int is_u8;
  __device__ __forceinline__ bool masked(int k) const {
    return is_u8 ? static_cast<const uint8_t*>(base)[k * sk_stride] != 0
                 : static_cast<const int32_t*>(base)[k * sk_stride] != 0;
  }
};

struct MaskArgs {
  const void* mask;  // null for the causal kernels
  int64_t sb, sh, sq, sk;  // element strides over (batch, head, query, key)
  int is_u8;
};

__device__ __forceinline__ MaskRow mask_row(const MaskArgs& ma, int64_t row,
                                            int sq, int heads) {
  const int64_t q = row % sq, bh = row / sq;
  const int64_t b = bh / heads, h = bh % heads;
  const size_t esz = ma.is_u8 ? 1 : 4;
  const char* base = static_cast<const char*>(ma.mask) +
                     (b * ma.sb + h * ma.sh + q * ma.sq) * esz;
  return MaskRow{base, ma.sk, ma.is_u8};
}

template <bool CAUSAL>
__device__ __forceinline__ float score(float xv, float scale, int k,
                                       int64_t q, const MaskRow& mr) {
  const bool masked = CAUSAL ? (k > q) : mr.masked(k);
  return masked ? kMaskValue : xv * scale;
}

// Reductions over the tpr threads of a row group (tpr a power of two;
// every lane of the warp takes part).
__device__ __forceinline__ float group_max(float v, int tpr) {
  for (int o = tpr >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int tpr) {
  for (int o = tpr >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

template <typename T, int VEC, int CHUNKS, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_reg(const T* __restrict__ x, T* __restrict__ y, MaskArgs ma,
                int64_t rows, int sq, int sk, int heads, float scale,
                int tpr) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) +
                      threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const bool valid = row < rows;
  const int64_t q = valid ? row % sq : 0;
  MaskRow mr{nullptr, 0, 0};
  if (!CAUSAL && valid) mr = mask_row(ma, row, sq, heads);
  float z[CHUNKS][VEC];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (valid && c < sk) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(x + row * sk + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        z[j][e] = score<CAUSAL>(to_f(p.v[e]), scale, c + e, q, mr);
        mx = fmaxf(mx, z[j][e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) z[j][e] = -INFINITY;
    }
  }
  mx = group_max(mx, tpr);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      z[j][e] = z[j][e] == -INFINITY ? 0.f : expf(z[j][e] - mx);
      sum += z[j][e];
    }
  sum = group_sum(sum, tpr);
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (c >= sk) continue;
    Pack<T, VEC> p;
#pragma unroll
    for (int e = 0; e < VEC; ++e) p.v[e] = from_f<T>(z[j][e] / sum);
    *reinterpret_cast<Pack<T, VEC>*>(y + row * sk + c) = p;
  }
}

template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_reg(const T* __restrict__ y, const T* __restrict__ dy,
                T* __restrict__ dx, int64_t rows, int sk, float scale,
                int tpr) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / tpr) +
                      threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const bool valid = row < rows;
  float yv[CHUNKS][VEC], gv[CHUNKS][VEC];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (valid && c < sk) {
      const Pack<T, VEC> a =
          *reinterpret_cast<const Pack<T, VEC>*>(y + row * sk + c);
      const Pack<T, VEC> b =
          *reinterpret_cast<const Pack<T, VEC>*>(dy + row * sk + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        yv[j][e] = to_f(a.v[e]);
        gv[j][e] = to_f(b.v[e]);
        s += yv[j][e] * gv[j][e];
      }
    }
  }
  s = group_sum(s, tpr);
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (c >= sk) continue;
    Pack<T, VEC> p;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      p.v[e] = from_f<T>(__fmul_rn(__fmul_rn(scale, gv[j][e] - s), yv[j][e]));
    *reinterpret_cast<Pack<T, VEC>*>(dx + row * sk + c) = p;
  }
}

// ---------------------------------------------------------------------------
// generic path: a warp a row, any sk
// ---------------------------------------------------------------------------

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_any(const T* __restrict__ x, T* __restrict__ y, MaskArgs ma,
                int64_t rows, int sq, int sk, int heads, float scale) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const int64_t q = row % sq;
  MaskRow mr{nullptr, 0, 0};
  if (!CAUSAL) mr = mask_row(ma, row, sq, heads);
  const T* xr = x + row * sk;
  float mx = -INFINITY;
  for (int k = lane; k < sk; k += 32)
    mx = fmaxf(mx, score<CAUSAL>(to_f(xr[k]), scale, k, q, mr));
  mx = group_max(mx, 32);
  float sum = 0.f;
  for (int k = lane; k < sk; k += 32)
    sum += expf(score<CAUSAL>(to_f(xr[k]), scale, k, q, mr) - mx);
  sum = group_sum(sum, 32);
  for (int k = lane; k < sk; k += 32)
    y[row * sk + k] = from_f<T>(
        expf(score<CAUSAL>(to_f(xr[k]), scale, k, q, mr) - mx) / sum);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_any(const T* __restrict__ y, const T* __restrict__ dy,
                T* __restrict__ dx, int64_t rows, int sk, float scale) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* yr = y + row * sk;
  const T* gr = dy + row * sk;
  float s = 0.f;
  for (int k = lane; k < sk; k += 32) s += to_f(yr[k]) * to_f(gr[k]);
  s = group_sum(s, 32);
  for (int k = lane; k < sk; k += 32)
    dx[row * sk + k] = from_f<T>(
        __fmul_rn(__fmul_rn(scale, to_f(gr[k]) - s), to_f(yr[k])));
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
struct Plan {
  static constexpr int kVec = 16 / sizeof(T);
  int reg;     // register path?
  int tpr;     // threads a row (register path)
  int chunks;  // vectors a thread (register path)
  unsigned blocks;
};

template <typename T>
Plan<T> plan(int64_t rows, int sk, const void* a, const void* b) {
  Plan<T> p{0, 32, 1, 0};
  constexpr int vec = Plan<T>::kVec;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const int nvec = sk / vec;
  if (aligned && sk % vec == 0 && nvec <= 32 * 8) {
    p.reg = 1;
    p.tpr = 1;
    while (p.tpr < nvec && p.tpr < 32) p.tpr <<= 1;
    while (p.tpr * p.chunks < nvec) p.chunks <<= 1;
    const int64_t per_block = kThreads / p.tpr;
    p.blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  } else {
    p.blocks = static_cast<unsigned>((rows + kThreads / 32 - 1) /
                                     (kThreads / 32));
  }
  return p;
}

template <typename T, bool CAUSAL>
void launch_fwd(const void* x, void* y, const MaskArgs& ma, int64_t rows,
                int sq, int sk, int heads, float scale, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const Plan<T> p = plan<T>(rows, sk, x, y);
  constexpr int V = Plan<T>::kVec;
  if (!p.reg) {
    softmax_fwd_any<T, CAUSAL><<<p.blocks, kThreads, 0, s>>>(
        xp, yp, ma, rows, sq, sk, heads, scale);
    return;
  }
#define APX_FWD(C)                                                         \
  softmax_fwd_reg<T, V, C, CAUSAL><<<p.blocks, kThreads, 0, s>>>(          \
      xp, yp, ma, rows, sq, sk, heads, scale, p.tpr)
  switch (p.chunks) {
    case 1: APX_FWD(1); break;
    case 2: APX_FWD(2); break;
    case 4: APX_FWD(4); break;
    default: APX_FWD(8); break;
  }
#undef APX_FWD
}

template <typename T>
void launch_bwd(const void* y, const void* dy, void* dx, int64_t rows,
                int sk, float scale, cudaStream_t s) {
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  // all three rows must be 16-byte aligned for the register path
  const uintptr_t both = reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(dx);
  const Plan<T> p = plan<T>(rows, sk, y, reinterpret_cast<const void*>(both));
  constexpr int V = Plan<T>::kVec;
  if (!p.reg) {
    softmax_bwd_any<T><<<p.blocks, kThreads, 0, s>>>(yp, gp, dp, rows, sk,
                                                      scale);
    return;
  }
#define APX_BWD(C)                                                         \
  softmax_bwd_reg<T, V, C><<<p.blocks, kThreads, 0, s>>>(yp, gp, dp, rows, \
                                                         sk, scale, p.tpr)
  switch (p.chunks) {
    case 1: APX_BWD(1); break;
    case 2: APX_BWD(2); break;
    case 4: APX_BWD(4); break;
    default: APX_BWD(8); break;
  }
#undef APX_BWD
}

template <bool CAUSAL>
int fwd_by_dtype(const void* x, void* y, const MaskArgs& ma, int64_t rows,
                 int sq, int sk, int heads, int dtype, float scale,
                 cudaStream_t s) {
  if (dtype == kBF16)
    launch_fwd<__nv_bfloat16, CAUSAL>(x, y, ma, rows, sq, sk, heads, scale, s);
  else if (dtype == kF16)
    launch_fwd<__half, CAUSAL>(x, y, ma, rows, sq, sk, heads, scale, s);
  else
    launch_fwd<float, CAUSAL>(x, y, ma, rows, sq, sk, heads, scale, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Padding-mask forward. x, y: (b, heads, sq, sk) contiguous, dtype 0 fp32 /
// 1 bf16 / 2 fp16. mask: int32 (mask_u8 = 0) or uint8/bool (1), read at
// mask[b * m_sb + h * m_sh + q * m_sq + k * m_sk]. Launches on `stream`;
// returns cudaGetLastError().
int apx_softmax_masked_fwd(const void* x, const void* mask, void* y, int b,
                           int heads, int sq, int sk, long long m_sb,
                           long long m_sh, long long m_sq, long long m_sk,
                           int mask_u8, int dtype, float scale,
                           void* stream) {
  const MaskArgs ma{mask, m_sb, m_sh, m_sq, m_sk, mask_u8};
  const int64_t rows = static_cast<int64_t>(b) * heads * sq;
  return fwd_by_dtype<false>(x, y, ma, rows, sq, sk, heads, dtype, scale,
                             static_cast<cudaStream_t>(stream));
}

// Causal forward. x, y: (batches, sq, sk) contiguous; key k > query q is
// masked.
int apx_softmax_causal_fwd(const void* x, void* y, int batches, int sq,
                           int sk, int dtype, float scale, void* stream) {
  const MaskArgs ma{nullptr, 0, 0, 0, 0, 0};
  const int64_t rows = static_cast<int64_t>(batches) * sq;
  return fwd_by_dtype<true>(x, y, ma, rows, sq, sk, 1, dtype, scale,
                            static_cast<cudaStream_t>(stream));
}

// Backward of either forward. y, dy, dx: (rows, sk) contiguous, one dtype.
int apx_softmax_bwd(const void* y, const void* dy, void* dx, long long rows,
                    int sk, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, s);
  else if (dtype == kF16)
    launch_bwd<__half>(y, dy, dx, rows, sk, scale, s);
  else
    launch_bwd<float>(y, dy, dx, rows, sk, scale, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
