// Paged decode attention for Hopper (sm_90a): one query a slot against
// one layer's page pool, reading K and V through the slot's block table.
//
// No Pallas kernel is replaced: the JAX package computes this step as
// plain XLA (apex_tpu/models/gpt.py:403 _paged_decode_attention, :951
// _paged_decode_attention_q8). There every layer gathers the slot's
// whole block-table row out of the pool (k_pages[block_tables]),
// upcasts it to fp32 (dequantizes an int8 pool), and masks the scores
// past `pos` to finfo(f32).min, whose probabilities are exactly 0. This
// kernel computes the same function and reads only the live rows
// 0..pos: skipping the masked rows is exact.
//
// What bounds it on an H100: bytes. A slot's live K and V rows are read
// once (2 (pos + 1) nh hd sizeof(pool) bytes, plus an int8 pool's
// scales), against about 4 flops a K/V element pair; far below the
// card's 295 flops a byte.
//
// Design (a simple first version): one block of 256 threads a (head,
// slot); q in registers (each lane holds VE consecutive elements of
// its row, LPR lanes a row, 32 / LPR rows a warp at once); the warps
// walk the logical positions 0..pos in a fixed interleave (position t
// goes to warp (t / RPW) % 8 and row group t % RPW), U positions at a
// time with every K and V load in flight before the first score; each
// physical page id is read from the table at the position's logical
// page; VE-element vector loads of the rows (16 bytes where hd and the
// pool allow); an online softmax in fp32 per row group, then the row
// groups of a warp combined by shuffles and the warps in warp order
// through shared memory; ctx = acc / l, rounded once to q's type. The
// order of every operation depends only on logical positions, so the
// same logical contents under any physical page assignment give the
// same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;          // positions a row group has in flight
constexpr int kMaxHd = 256;

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int VB> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<1> { using T = uint8_t; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// exp(a - b), 0 where a is -inf (an empty row group's state)
__device__ __forceinline__ float rescale(float a, float b) {
  return a == -CUDART_INF_F ? 0.f : expf(a - b);
}

template <typename TQ, typename TKV, int VE, bool kQ8>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ bt, const int* __restrict__ pos,
                    TQ* __restrict__ out, int nh, int page, int hd,
                    int max_pages, int lpr, float scale) {
  using R = typename Raw<VE * sizeof(TKV)>::T;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxHd];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;               // rows a warp holds at once
  const int g = lane / lpr, e0 = (lane % lpr) * VE;
  const bool live = e0 < hd;              // hd % VE == 0

  float qr[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i)
    qr[i] = live ? to_f(q[(static_cast<long long>(b) * nh + h) * hd + e0
                          + i]) : 0.f;

  const int n = min(pos[b], max_pages * page - 1) + 1;
  const int* row = bt + static_cast<long long>(b) * max_pages;
  const long long page_stride = static_cast<long long>(nh) * page * hd;
  const long long head_off = static_cast<long long>(h) * page * hd + e0;
  const int stride = kWarps * rpw;        // positions a pass covers

  float m = -CUDART_INF_F, l = 0.f, acc[VE];
#pragma unroll
  for (int i = 0; i < VE; ++i) acc[i] = 0.f;

  // warp-uniform trip count: every lane reaches every shuffle
  for (int base = warp * rpw; base < n; base += kU * stride) {
    R kr[kU], vr[kU];
    float ksc[kU], vsc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = base + g + u * stride;
      if (t < n && live) {
        const int phys = row[t / page];
        const long long off = phys * page_stride + head_off
            + static_cast<long long>(t % page) * hd;
        kr[u] = *reinterpret_cast<const R*>(kp + off);
        vr[u] = *reinterpret_cast<const R*>(vp + off);
        if (kQ8) {
          ksc[u] = ks[static_cast<long long>(phys) * nh + h];
          vsc[u] = vs[static_cast<long long>(phys) * nh + h];
        }
      } else {
        kr[u] = R();
        vr[u] = R();
        ksc[u] = vsc[u] = 0.f;
      }
    }
    float s[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const TKV* ke = reinterpret_cast<const TKV*>(&kr[u]);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const float kv = kQ8 ? __fmul_rn(to_f(ke[i]), ksc[u]) : to_f(ke[i]);
        d = fmaf(qr[i], kv, d);
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      const int t = base + g + u * stride;
      s[u] = t < n ? d * scale : -CUDART_INF_F;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u]);
    const float c = rescale(m, mx);
    l *= c;
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] *= c;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (s[u] == -CUDART_INF_F) continue;
      const float p = expf(s[u] - mx);
      l += p;
      const TKV* ve = reinterpret_cast<const TKV*>(&vr[u]);
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const float vv = kQ8 ? __fmul_rn(to_f(ve[i]), vsc[u]) : to_f(ve[i]);
        acc[i] = fmaf(p, vv, acc[i]);
      }
    }
    m = mx;
  }

  // the row groups of a warp, combined by lane order (lanes lpr apart)
  for (int o = lpr; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float c1 = rescale(m, mn), c2 = rescale(m2, mn);
    const bool low = (lane & o) == 0;     // this lane's group comes first
    l = low ? __fadd_rn(__fmul_rn(l, c1), __fmul_rn(l2, c2))
            : __fadd_rn(__fmul_rn(l2, c2), __fmul_rn(l, c1));
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      const float a2 = __shfl_xor_sync(0xffffffffu, acc[i], o);
      acc[i] = low ? __fadd_rn(__fmul_rn(acc[i], c1), __fmul_rn(a2, c2))
                   : __fadd_rn(__fmul_rn(a2, c2), __fmul_rn(acc[i], c1));
    }
    m = mn;
  }
  if (g == 0) {
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < VE; ++i) sm_acc[warp][e0 + i] = acc[i];
    }
  }
  __syncthreads();

  // the warps in warp order
  const int e = threadIdx.x;
  if (e < hd) {
    float mt = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w], mt);
      lt = __fadd_rn(lt, __fmul_rn(sm_l[w], c));
      at = __fadd_rn(at, __fmul_rn(sm_acc[w][e], c));
    }
    from_f(at / lt, out + (static_cast<long long>(b) * nh + h) * hd + e);
  }
}

template <typename TQ, typename TKV, int VE>
cudaError_t launch_ve(const void* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* bt,
                      const int* pos, void* out, int b, int nh, int page,
                      int hd, int max_pages, float scale,
                      cudaStream_t st) {
  if constexpr (VE * sizeof(TKV) > 16) {
    return cudaErrorInvalidValue;
  } else {
    int lpr = 1;
    while (lpr * VE < hd) lpr <<= 1;
    if (lpr > 32) return cudaErrorInvalidValue;
    const dim3 grid(nh, b);
    const TQ* qq = static_cast<const TQ*>(q);
    TQ* oo = static_cast<TQ*>(out);
    const TKV* kk = static_cast<const TKV*>(kp);
    const TKV* vv = static_cast<const TKV*>(vp);
    if (ks != nullptr)
      paged_decode_kernel<TQ, TKV, VE, true><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, ks, vs, bt, pos, oo, nh, page, hd, max_pages, lpr,
          scale);
    else
      paged_decode_kernel<TQ, TKV, VE, false><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, ks, vs, bt, pos, oo, nh, page, hd, max_pages, lpr,
          scale);
    return cudaGetLastError();
  }
}

// The widest vector (16, 8, 4, 2 or 1 bytes) that divides a row and
// the pools' base addresses.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, void* out, int b, int nh, int page,
                   int hd, int max_pages, float scale, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(kp)
      | reinterpret_cast<uintptr_t>(vp);
  const int row_bytes = hd * static_cast<int>(sizeof(TKV));
  int vb = 16;
  while (vb > static_cast<int>(sizeof(TKV))
         && (row_bytes % vb || addr % vb))
    vb >>= 1;
  const int ve = vb / static_cast<int>(sizeof(TKV));
#define APX_VE(N)                                                          \
  if (ve == N)                                                             \
    return launch_ve<TQ, TKV, N>(q, kp, vp, ks, vs, bt, pos, out, b, nh,   \
                                 page, hd, max_pages, scale, st);
  APX_VE(16) APX_VE(8) APX_VE(4) APX_VE(2) APX_VE(1)
#undef APX_VE
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* pos, void* out, int b, int nh, int page,
                     int hd, int max_pages, int kv_dtype, float scale,
                     cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, kp, vp, nullptr, nullptr, bt, pos, out,
                               b, nh, page, hd, max_pages, scale, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, kp, vp, nullptr, nullptr, bt,
                                       pos, out, b, nh, page, hd,
                                       max_pages, scale, st);
    case kI8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(q, kp, vp, ks, vs, bt, pos, out, b, nh,
                                page, hd, max_pages, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, out: (b, nh, hd) contiguous, dtype q_dtype (0 fp32, 1 bf16).
// k_pages, v_pages: (num_pages, nh, page, hd) contiguous, dtype kv_dtype
// (0 fp32, 1 bf16, 2 int8); k_scale, v_scale: (num_pages, nh) fp32 for
// int8, else null. block_tables: (b, max_pages) int32; pos: (b,) int32.
// Attends logical positions 0..min(pos, max_pages * page - 1). hd <= 256
// and at most 32 vectors a row; b <= 65535. Launches on `stream`;
// returns cudaGetLastError().
int apx_paged_decode_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale,
                               const void* block_tables, const void* pos,
                               void* out, int b, int nh, int page, int hd,
                               int max_pages, int q_dtype, int kv_dtype,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || nh < 1 || nh > 65535 || page < 1 || hd < 1
      || hd > kMaxHd || max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps = static_cast<const int*>(pos);
  cudaError_t err;
  if (q_dtype == kF32)
    err = launch_q<float>(q, k_pages, v_pages, ks, vs, bt, ps, out, b, nh,
                          page, hd, max_pages, kv_dtype, scale, st);
  else if (q_dtype == kBF16)
    err = launch_q<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, bt, ps,
                                  out, b, nh, page, hd, max_pages,
                                  kv_dtype, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
