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
// warp shuffles. Any other sk takes the generic path: a warp a row, three
// sweeps over the row in global memory (max, sum, write), scalar loads.
//
// The forwards are laid out so that a score costs few instructions: a
// block's rows share their (batch, head), which the grid gives
// (blockIdx.x a tile of queries, y the head, z the batch; the causal
// kernels' flattened batch over y and z), so a row's query comes from
// 32-bit arithmetic on the thread index and no row divides. Where the
// mask's key stride is 1 (BERT's (b, 1, 1, sk) padding mask, a (b, 1, sq,
// sk) one) and its rows are aligned, a thread reads the mask values of a
// vector in one load (8 bytes of uint8 or 32 of int32); any other mask is
// read element by element through its strides. Arithmetic is fp32: expf
// of z - max, then one correctly rounded reciprocal of the row sum and a
// multiply a score (fused_softmax.fwd_limits holds that form: one
// rounding more than a division, within the model's slack).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum MaskKind { kCausal = 0, kMaskU8 = 1, kMaskI32 = 2 };
constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;
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

// The padding mask: element (b, h, q, k) at mask[b sb + h sh + q sq + k
// sk], int32 or uint8 (KIND).
struct MaskArgs {
  const void* mask;  // null for the causal kernels
  int64_t sb, sh, sq, sk;
  int vec;  // sk == 1 and every row aligned to a vector of mask values
};

template <int KIND>
using MaskT = typename std::conditional<KIND == kMaskU8, uint8_t,
                                        int32_t>::type;

// Whether the VEC keys k0 .. k0 + VEC - 1 of a row are masked, the row's
// mask starting at mr (the padding kernels) or its query being q (causal).
template <int KIND, int VEC>
__device__ __forceinline__ void masked_of(const void* mr, int64_t sk_stride,
                                          int vec, int k0, int q,
                                          bool (&m)[VEC]) {
  if constexpr (KIND == kCausal) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = k0 + e > q;
  } else {
    using M = MaskT<KIND>;
    const M* p = static_cast<const M*>(mr);
    if (vec) {
      const Pack<M, VEC>* v = reinterpret_cast<const Pack<M, VEC>*>(p + k0);
      Pack<M, VEC> pk;
      if constexpr (sizeof(Pack<M, VEC>) > 16) {  // 32 bytes: two loads
        const uint4* src = reinterpret_cast<const uint4*>(v);
        uint4* dst = reinterpret_cast<uint4*>(&pk);
        dst[0] = src[0];
        dst[1] = src[1];
      } else {
        pk = *v;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[e] = pk.v[e] != 0;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[e] = p[(k0 + e) * sk_stride] != 0;
    }
  }
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

// Where a forward block's rows live: the (batch, head) slab of rows
// (b heads + h, or the causal kernels' flattened batch) and its mask
// base. False for a causal block past the last batch.
template <int KIND>
__device__ __forceinline__ bool block_rows(const MaskArgs& ma, int batches,
                                           int64_t& bh, const char*& mb) {
  mb = nullptr;
  if constexpr (KIND == kCausal) {
    bh = blockIdx.y + static_cast<int64_t>(gridDim.y) * blockIdx.z;
    return bh < batches;
  } else {
    bh = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
    mb = static_cast<const char*>(ma.mask) +
         (blockIdx.z * ma.sb + blockIdx.y * ma.sh) * sizeof(MaskT<KIND>);
    return true;
  }
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------

// Block (x, y, z): queries [x rpb, (x + 1) rpb) of one (batch, head), rpb
// = kThreads / tpr; thread i the query x rpb + i / tpr, vectors j tpr +
// i % tpr (j < CHUNKS) of its row.
template <typename T, int VEC, int CHUNKS, int KIND>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_reg(const T* __restrict__ x, T* __restrict__ y, MaskArgs ma,
                int batches, int sq, int sk, float scale, int lg_tpr) {
  int64_t bh;
  const char* mb;
  if (!block_rows<KIND>(ma, batches, bh, mb)) return;  // the whole block
  const int tpr = 1 << lg_tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int q = blockIdx.x * (kThreads >> lg_tpr) + (threadIdx.x >> lg_tpr);
  const bool valid = q < sq;
  const int64_t base = (bh * sq + q) * sk;
  const void* mr = nullptr;
  if constexpr (KIND != kCausal)
    mr = mb + q * ma.sq * static_cast<int64_t>(sizeof(MaskT<KIND>));
  float z[CHUNKS][VEC];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (valid && c < sk) {
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(x + base + c);
      bool m[VEC];
      masked_of<KIND, VEC>(mr, ma.sk, ma.vec, c, q, m);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        z[j][e] = m[e] ? kMaskValue : to_f(p.v[e]) * scale;
        mx = fmaxf(mx, z[j][e]);
      }
    }
  }
  mx = group_max(mx, tpr);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (valid && c < sk) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        z[j][e] = expf(z[j][e] - mx);
        sum += z[j][e];
      }
    }
  }
  sum = group_sum(sum, tpr);
  if (!valid) return;
  const float r = __frcp_rn(sum);
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int c = (j * tpr + lane) * VEC;
    if (c >= sk) continue;
    Pack<T, VEC> p;
#pragma unroll
    for (int e = 0; e < VEC; ++e) p.v[e] = from_f<T>(__fmul_rn(z[j][e], r));
    *reinterpret_cast<Pack<T, VEC>*>(y + base + c) = p;
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

// Block (x, y, z) as the register path's with four rows a block, a warp
// each.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
softmax_fwd_any(const T* __restrict__ x, T* __restrict__ y, MaskArgs ma,
                int batches, int sq, int sk, float scale) {
  int64_t bh;
  const char* mb;
  if (!block_rows<KIND>(ma, batches, bh, mb)) return;
  const int q = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= sq) return;  // whole warps leave together
  const void* mr = nullptr;
  if constexpr (KIND != kCausal)
    mr = mb + q * ma.sq * static_cast<int64_t>(sizeof(MaskT<KIND>));
  const T* xr = x + (bh * sq + q) * sk;
  T* yr = y + (bh * sq + q) * sk;
  auto score = [&](int k) {
    bool m[1];
    masked_of<KIND, 1>(mr, ma.sk, 0, k, q, m);
    return m[0] ? kMaskValue : to_f(xr[k]) * scale;
  };
  float mx = -INFINITY;
  for (int k = lane; k < sk; k += 32) mx = fmaxf(mx, score(k));
  mx = group_max(mx, 32);
  float sum = 0.f;
  for (int k = lane; k < sk; k += 32) sum += expf(score(k) - mx);
  sum = group_sum(sum, 32);
  const float r = __frcp_rn(sum);
  for (int k = lane; k < sk; k += 32)
    yr[k] = from_f<T>(__fmul_rn(expf(score(k) - mx), r));
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

// The register path's row group: tpr = 2^lg threads a row, each with
// `chunks` vectors (0 chunks: the generic path).
struct RegPlan {
  int chunks, lg_tpr;
};

// As few vectors a thread as 32 threads a row allow: at sk 128 in bf16
// (BERT-Large's step) one vector a thread and 16 threads a row took
// 0.0259 ms on the H100, two vectors 0.0273, four 0.0290 and eight
// 0.0403 (one process, examples/kernel_ab.py).
RegPlan plan(int sk, int vec, bool aligned) {
  const int nvec = sk / vec;
  if (!aligned || sk % vec != 0 || nvec > 32 * 8) return {0, 5};
  int chunks = 1, lg = 0;
  while ((1 << lg) < nvec && lg < 5) ++lg;
  while ((chunks << lg) < nvec) chunks <<= 1;
  return {chunks, lg};
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// grid: (query tiles, heads, batch) for the padding kernels; (query
// tiles, the flattened batch over y and z) for the causal ones.
template <typename T, int KIND>
int launch_fwd(const void* x, void* y, const MaskArgs& ma, int batch,
               int heads, int sq, int sk, float scale, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const RegPlan p = plan(sk, V, aligned16(x, y));
  const int rpb = kThreads >> p.lg_tpr;
  dim3 grid(static_cast<unsigned>((sq + rpb - 1) / rpb), heads, batch);
  if (KIND == kCausal) {
    grid.y = batch < kMaxGridY ? batch : kMaxGridY;
    grid.z = (batch + kMaxGridY - 1) / kMaxGridY;
  } else if (heads > kMaxGridY || batch > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.chunks == 0) {
    softmax_fwd_any<T, KIND><<<grid, kThreads, 0, s>>>(xp, yp, ma, batch,
                                                       sq, sk, scale);
    return 0;
  }
#define APX_FWD(C)                                                         \
  softmax_fwd_reg<T, V, C, KIND><<<grid, kThreads, 0, s>>>(                \
      xp, yp, ma, batch, sq, sk, scale, p.lg_tpr)
  switch (p.chunks) {
    case 1: APX_FWD(1); break;
    case 2: APX_FWD(2); break;
    case 4: APX_FWD(4); break;
    default: APX_FWD(8); break;
  }
#undef APX_FWD
  return 0;
}

template <typename T>
void launch_bwd(const void* y, const void* dy, void* dx, int64_t rows,
                int sk, float scale, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  // all three rows must be 16-byte aligned for the register path
  const RegPlan p = plan(
      sk, V, aligned16(y, reinterpret_cast<const void*>(
                              reinterpret_cast<uintptr_t>(dy) |
                              reinterpret_cast<uintptr_t>(dx))));
  const int tpr = 1 << p.lg_tpr;
  const int64_t per_block = p.chunks ? kThreads / tpr : kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  if (p.chunks == 0) {
    softmax_bwd_any<T><<<blocks, kThreads, 0, s>>>(yp, gp, dp, rows, sk,
                                                    scale);
    return;
  }
#define APX_BWD(C)                                                         \
  softmax_bwd_reg<T, V, C><<<blocks, kThreads, 0, s>>>(yp, gp, dp, rows,   \
                                                       sk, scale, tpr)
  switch (p.chunks) {
    case 1: APX_BWD(1); break;
    case 2: APX_BWD(2); break;
    case 4: APX_BWD(4); break;
    default: APX_BWD(8); break;
  }
#undef APX_BWD
}

template <int KIND>
int fwd_by_dtype(const void* x, void* y, const MaskArgs& ma, int batch,
                 int heads, int sq, int sk, int dtype, float scale,
                 cudaStream_t s) {
  int err;
  if (dtype == kBF16)
    err = launch_fwd<__nv_bfloat16, KIND>(x, y, ma, batch, heads, sq, sk,
                                          scale, s);
  else if (dtype == kF16)
    err = launch_fwd<__half, KIND>(x, y, ma, batch, heads, sq, sk, scale, s);
  else
    err = launch_fwd<float, KIND>(x, y, ma, batch, heads, sq, sk, scale, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Padding-mask forward. x, y: (b, heads, sq, sk) contiguous, dtype 0 fp32 /
// 1 bf16 / 2 fp16; b and heads at most 65535. mask: int32 (mask_u8 = 0) or
// uint8/bool (1), read at mask[b * m_sb + h * m_sh + q * m_sq + k * m_sk].
// Launches on `stream`; returns cudaGetLastError().
int apx_softmax_masked_fwd(const void* x, const void* mask, void* y, int b,
                           int heads, int sq, int sk, long long m_sb,
                           long long m_sh, long long m_sq, long long m_sk,
                           int mask_u8, int dtype, float scale,
                           void* stream) {
  // the mask values of one 16-byte vector of x in one load: key stride 1
  // and every row's start aligned to that many mask bytes (at most 16)
  const int esz = mask_u8 ? 1 : 4;
  const int vbytes = (dtype == kF32 ? 4 : 8) * esz;
  const long long align = vbytes < 16 ? vbytes : 16;
  const bool vec =
      m_sk == 1 && sk % (dtype == kF32 ? 4 : 8) == 0 &&
      ((reinterpret_cast<uintptr_t>(mask) | static_cast<uintptr_t>(
            (m_sb | m_sh | m_sq) * esz)) % align) == 0;
  const MaskArgs ma{mask, m_sb, m_sh, m_sq, m_sk, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask_u8 ? fwd_by_dtype<kMaskU8>(x, y, ma, b, heads, sq, sk, dtype,
                                         scale, s)
                 : fwd_by_dtype<kMaskI32>(x, y, ma, b, heads, sq, sk, dtype,
                                          scale, s);
}

// Causal forward. x, y: (batches, sq, sk) contiguous; key k > query q is
// masked.
int apx_softmax_causal_fwd(const void* x, void* y, int batches, int sq,
                           int sk, int dtype, float scale, void* stream) {
  const MaskArgs ma{nullptr, 0, 0, 0, 0, 0};
  return fwd_by_dtype<kCausal>(x, y, ma, batches, 1, sq, sk, dtype, scale,
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
