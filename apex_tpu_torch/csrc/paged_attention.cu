// Paged attention for Hopper (sm_90a): k1 queries a slot against one
// layer's page pool, reading K and V through the slot's block table.
// k1 = 1 is a decode step; k1 > 1 a speculative verify step, whose
// queries see the slot's committed rows and, inside the k1-row window
// the step has just written, the rows an ancestor matrix admits.
//
// No Pallas kernel is replaced: the JAX package computes these steps as
// plain XLA (apex_tpu/models/gpt.py:403 _paged_decode_attention, :537
// _paged_verify_attention, :816 _paged_tree_verify_attention, and the
// int8 forms :951 and :1004). There every layer gathers the slot's
// whole block-table row out of the pool (k_pages[block_tables]),
// upcasts it to fp32 (dequantizes an int8 pool), and masks each query's
// scores outside its visible rows to finfo(f32).min, whose
// probabilities are exactly 0. Key row s is visible to query j when
// s < pos, or when 0 <= s - pos < k1 and anc[s - pos][j] is set
// (_tree_score_mask, :739); a linear verify is anc[i][j] = i <= j, a
// decode step k1 = 1. This kernel computes the same function and reads
// only the rows 0 .. pos + k1 - 1: skipping masked rows is exact.
//
// What bounds it on an H100: bytes. The slot's live K and V rows are
// read once for all k1 queries (2 (pos + k1) nh hd sizeof(pool) bytes,
// plus an int8 pool's scales), against about 4 k1 flops a K/V element
// pair; below the card's 295 flops a byte for any k1 <= 64. What bound
// the first design (one block a (head, slot) walking the slot's rows
// in tiles of 128, four barriers a tile) was the latency of that walk:
// 128 blocks on 132 SMs at 8 slots, the longest slot's tiles in series.
//
// Design. Each slot's rows are cut into parts of kPart = 128 logical
// positions, a constant of this file; one block of 128 threads a
// (part, head, slot). The grid is sized from the table (pos lies on the
// card): a part past the rows any query of the launch may see exits at
// once. A block reads pos and each of its rows' physical page (the
// table at the row's logical page) together, stages q in fp32 in shared
// memory, then copies the part's K rows and V rows, in the pool's own
// type, by cp.async (16-byte copies where hd and the pools allow, else
// 8, 4, 2 or 1; rows past the last one read are zero-filled), K and V
// in two groups so that V lands while the scores are taken (rows too
// wide for both beside 64 queries, a function of hd and the pool's type:
// V into K's buffer after the scores). Scores: a thread a row, the dot
// product with each query over the row in element order, K converted in
// registers from 16-byte shared reads (an int8 element dequantized by
// the one __fmul_rn(int8, scale) of the plain version), q read by
// broadcast. Softmax over the part: one warp a query, four rows a lane
// (r + 32 u): the part's max m_p, p = exp(s - m_p), the part's sum l_p
// (the lane's four in order, then a butterfly). P V: 8 lanes an item of
// 4 elements, lane i summing rows i, i + 8, ... in order, then a
// butterfly. Past one query, a thread takes the scores and P V sums of
// up to four queries at once (their accumulators in registers, each K
// and V element read once for them): every query's sums keep the order
// above. Four block barriers (two more for the parts' count) and no
// rescale inside a part. Blocks an SM asked of the compiler: 8 over an
// int8 pool (its rows are small enough for 8 in shared memory; the
// 64-register cap spills 8-28 bytes, and 5 blocks were 9 % slower on an
// H100 at the A/B configuration), 5 over a bf16 or fp32 pool (shared
// memory holds about 5 at hd 64 over bf16 and fewer above; 91-96
// registers and no spill, where 8 capped them at 64 for an occupancy
// that shared memory never gave).
//
// A slot whose rows fit one part writes ctx = acc / l, rounded once to
// q's type. Otherwise each part writes its (m_p, l_p, acc_p) to a work
// buffer, and the last part of a (head, slot) to arrive, by an integer
// counter that it resets (the counters are zero at every launch and
// are left zero, so CUDA-graph replays find them so), combines the
// parts in part order: M = max m_p, w_p = exp(m_p - M) (exactly 1 at
// M), L = sum w_p l_p and acc = sum w_p acc_p from the first part the
// query sees, each product and sum rounded once; ctx = acc / L. No
// float atomics: the same bits whichever part arrives last.
//
// Query j's order of operations depends only on logical positions, hd
// and the rows it can see, never on k1, the other queries, the slot
// count, the card's occupancy or physical page ids: part p holds the
// rows 128 p .. 128 p + 127 whatever the launch; inside it each of j's
// sums runs over the part's logical rows in a fixed order, rows j
// cannot see entering as exact zeros (p = 0, and rows past the
// launch's last are zero-filled); a part where j sees no row carries
// m_p = -inf, which the combine skips (an exact no-op); and one part
// alone gives acc / l, the combine's 1 * acc / (1 * l) too. So the same
// logical contents under any page placement give the same bits, and
// column j of a linear verify at pos meets the parts and sums of a
// decode step at pos + j, whose part boundaries are the same logical
// rows.
//
// A launch takes a slice of the window's queries: nq queries from q0
// of a window of wk (q, out and anc keep the window's shape). By the
// order above, a window launched in slices gives the bits of one
// launch over all of it. Shared memory holds the part's raw K and V
// rows and, a query, q, its scores and m, l: 64 queries fit at every
// hd and pool type but an fp32 pool at hd above 252 (62 at 256).
//
// The prompt-chunk attention (apx_paged_chunk_attention, below the
// decode and verify kernel) is a second kernel of this file: one slot's
// chunk of sc bf16 queries against a bf16 pool on the tensor cores. Its
// note stands above its code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kPart = 128;      // logical positions a part
constexpr int kLanes = 8;       // lanes a (query, 4 elements) P V item
constexpr int kItems = kThreads / kLanes;
constexpr int kRowPad = 16;     // bytes after each K/V row in shared memory
constexpr int kBatch = 8;       // parts' (m, l) a thread has in flight
constexpr int kSumBatch = 4;    // parts' (m, l, acc) a thread has in flight
constexpr int kGroup = 4;       // the most queries a thread takes at once
constexpr int kMaxK1 = 64;
constexpr int kMaxHd = 256;
constexpr int kMaxSmem = 232448;

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// exp(a - b), 0 where a is -inf (a query that has seen no row yet)
__device__ __forceinline__ float rescale(float a, float b) {
  return a == -CUDART_INF_F ? 0.f : expf(a - b);
}

// A K/V row's bytes in shared memory: whole 16-byte chunks, then
// kRowPad more (eight rows read at once fall on distinct banks)
__host__ __device__ constexpr int row_stride(int hd, int esz) {
  return (hd * esz + 15) / 16 * 16 + kRowPad;
}

// q's floats a query in shared memory: hd rounded up to float4s
__host__ __device__ constexpr int q_width(int hd) { return (hd + 3) / 4 * 4; }

// the row offsets, the K and V rows, a query's q, scores, m and l, the
// int8 scales and the last arrival's flag (16 bytes)
__host__ __device__ constexpr size_t smem_parts(int nq, int hd, int esz,
                                                int kv_rows) {
  return sizeof(long long) * kPart +
         static_cast<size_t>(kv_rows) * row_stride(hd, esz) +
         sizeof(float) * (static_cast<size_t>(nq) * (q_width(hd) + kPart + 2)
                          + 2 * kPart) + 16;
}

// Whether the V rows reuse the K rows' buffer once the scores are taken:
// rows too wide for both beside kMaxK1 queries (a function of hd and the
// pool's type alone).
__host__ __device__ constexpr bool kv_shared(int hd, int esz) {
  return smem_parts(kMaxK1, hd, esz, 2 * kPart) > kMaxSmem;
}

__host__ __device__ constexpr size_t smem_bytes(int nq, int hd, int esz) {
  return smem_parts(nq, hd, esz, kv_shared(hd, esz) ? kPart : 2 * kPart);
}

static_assert(kThreads == kPart && kPart % 32 == 0 && kPart % kLanes == 0,
              "a thread a row; whole warps and lane groups a part");

__device__ __forceinline__ uint32_t shared_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// VB bytes global -> shared; `in` false zero-fills (cp.async for 4, 8
// and 16 bytes, a load and a store below)
template <int VB>
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, bool in) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else if constexpr (VB >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src), "n"(VB), "r"(in ? VB : 0)
                 : "memory");
  } else {
    using R = std::conditional_t<VB == 2, uint16_t, uint8_t>;
    *reinterpret_cast<R*>(dst) = in ? *reinterpret_cast<const R*>(src) : R();
  }
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float i8_at(uint32_t w, int k, float sc) {
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * k))),
                   sc);
}

// the 16 / sizeof(TKV) elements of a 16-byte chunk of a row in fp32 (an
// int8 element times its page's scale, one rounding)
template <typename TKV>
__device__ __forceinline__ void unpack16(const uint4& r, float sc,
                                         float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(TKV) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(TKV) == 2) {
      f[2 * i] = bf_lo(w[i]);
      f[2 * i + 1] = bf_hi(w[i]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[4 * i + k] = i8_at(w[i], k, sc);
    }
  }
}

// element e of a row in fp32
template <typename TKV>
__device__ __forceinline__ float elem(const unsigned char* row, int e,
                                      float sc) {
  if constexpr (sizeof(TKV) == 4) {
    return reinterpret_cast<const float*>(row)[e];
  } else if constexpr (sizeof(TKV) == 2) {
    return to_f(reinterpret_cast<const __nv_bfloat16*>(row)[e]);
  } else {
    return __fmul_rn(static_cast<float>(
                         reinterpret_cast<const int8_t*>(row)[e]), sc);
  }
}

// elements e .. e + 3 of a row in fp32 (e a multiple of 4; past hd the
// values are never used)
template <typename TKV>
__device__ __forceinline__ float4 load4(const unsigned char* row, int e,
                                        float sc) {
  if constexpr (sizeof(TKV) == 4) {
    return *reinterpret_cast<const float4*>(row + 4 * e);
  } else if constexpr (sizeof(TKV) == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(row + 2 * e);
    return make_float4(bf_lo(r.x), bf_hi(r.x), bf_lo(r.y), bf_hi(r.y));
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + e);
    return make_float4(i8_at(w, 0, sc), i8_at(w, 1, sc), i8_at(w, 2, sc),
                       i8_at(w, 3, sc));
  }
}

struct Params {
  const void* q;         // (b, nh, wk, hd)
  const void* kp;        // (num_pages, nh, page, hd)
  const void* vp;
  const float* ks;       // (num_pages, nh) int8 scales, else null
  const float* vs;
  const int* bt;         // (b, max_pages)
  const int* pos;        // (b,)
  const uint8_t* anc;    // (b, wk, wk) or null
  void* out;             // (b, nh, wk, hd)
  float* work;           // the parts' records; null with one part
  int* counters;         // (b nh) arrival counters, zero
  int nh, wk, q0, nq, page, hd, max_pages, parts;
  float scale;
};

template <typename TQ, typename TKV, int VB>
__global__ void __launch_bounds__(kThreads, sizeof(TKV) == 1 ? 8 : 5)
paged_attention_kernel(const Params p) {
  // nq: the slice's queries, window queries q0 .. q0 + nq - 1 of wk
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd, nq = p.nq, hq = q_width(hd);
  const int rs = row_stride(hd, sizeof(TKV));
  const bool shared = kv_shared(hd, sizeof(TKV));
  long long* srow = reinterpret_cast<long long*>(smem);  // kPart; -1 unread
  unsigned char* sk = smem + sizeof(long long) * kPart;  // kPart x rs
  unsigned char* sv = shared ? sk : sk + kPart * rs;     // kPart x rs
  float* sq = reinterpret_cast<float*>(sv + kPart * rs); // nq x hq
  float* sp = sq + nq * hq;                              // nq x kPart
  float* sm = sp + nq * kPart;                           // nq
  float* sl = sm + nq;                                   // nq
  float* sks = sl + nq;                                  // kPart
  float* svs = sks + kPart;                              // kPart
  int* s_last = reinterpret_cast<int*>(svs + kPart);     // 1

  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_len = p.max_pages * p.page;
  const int r0 = part * kPart, tr = r0 + tid;  // this thread's row
  // its physical page, read beside pos
  long long ph = 0;
  if (tid < kPart && tr < s_len)
    ph = p.bt[static_cast<long long>(b) * p.max_pages + tr / p.page];
  const int p0 = p.pos[b];
  // rows any query of the slice may see: a tree's ancestors may lie
  // anywhere in the window, a linear query's up to its own row
  const int nmax = min(p0 + (p.anc != nullptr ? p.wk : p.q0 + nq), s_len);
  const int ns = (nmax + kPart - 1) / kPart;
  if (part >= ns) return;
  const long long unit = static_cast<long long>(b) * p.nh + h;
  const long long qoff = (unit * p.wk + p.q0) * hd;
  const uint8_t* a = p.anc == nullptr
      ? nullptr : p.anc + static_cast<long long>(b) * p.wk * p.wk;

  // each row's place in the pool
  if (tid < kPart)
    srow[tid] =
        tr < nmax ? ((ph * p.nh + h) * p.page + tr % p.page) * hd : -1;
  const TQ* qg = static_cast<const TQ*>(p.q) + qoff;
  for (int i = tid; i < nq * hq; i += kThreads) {
    const int j = i / hq, e = i % hq;
    sq[i] = e < hd ? to_f(qg[j * hd + e]) : 0.f;
  }
  __syncthreads();

  // the part's K rows, then its V rows, VB bytes a copy
  const int rv = hd * static_cast<int>(sizeof(TKV)) / VB;  // copies a row
  auto copy_rows = [&](unsigned char* dst, const void* pool) {
    const unsigned char* src = static_cast<const unsigned char*>(pool);
    if (kThreads % rv == 0) {        // a thread's column fixed
      const int c = (tid % rv) * VB, step = kThreads / rv;
      for (int r = tid / rv; r < kPart; r += step) {
        const long long off = srow[r];
        stage<VB>(dst + r * rs + c,
                  src + (off < 0 ? 0 : off * sizeof(TKV)) + c, off >= 0);
      }
    } else {
      for (int v = tid; v < kPart * rv; v += kThreads) {
        const int r = v / rv, c = (v % rv) * VB;
        const long long off = srow[r];
        stage<VB>(dst + r * rs + c,
                  src + (off < 0 ? 0 : off * sizeof(TKV)) + c, off >= 0);
      }
    }
    stage_commit();
  };
  copy_rows(sk, p.kp);
  if (!shared) copy_rows(sv, p.vp);
  // the int8 scales while the rows are in flight
  if (std::is_same<TKV, int8_t>::value && tid < kPart) {
    sks[tid] = tr < nmax ? p.ks[ph * p.nh + h] : 0.f;
    svs[tid] = tr < nmax ? p.vs[ph * p.nh + h] : 0.f;
  }
  if (shared)
    stage_wait<0>();
  else
    stage_wait<1>();
  __syncthreads();

  // scores, a thread a row and G queries at a time, each query's dot
  // product over the row in element order
  auto score = [&](auto group, int j0) {
    constexpr int G = decltype(group)::value;
    constexpr int kCE = 16 / sizeof(TKV);  // elements a 16-byte chunk
    const int r = tid, t = r0 + r, w = t - p0;
    const unsigned char* kr = sk + r * rs;
    const float sc = sks[r];
    const int full = hd / kCE;
    {
      bool vis[G];
      bool any = false;
      const float* qj[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g;
        vis[g] = j < nq && t < s_len
            && (w < 0 || (w < p.wk && (a != nullptr
                                       ? a[static_cast<long long>(w) * p.wk
                                           + p.q0 + j] != 0
                                       : w <= p.q0 + j)));
        any = any || vis[g];
        qj[g] = sq + min(j, nq - 1) * hq;
      }
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = 0.f;
      if (any) {
        for (int c = 0; c < full; ++c) {
          float f[kCE];
          unpack16<TKV>(*reinterpret_cast<const uint4*>(kr + 16 * c), sc, f);
#pragma unroll
          for (int u = 0; u < kCE; u += 4) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 x =
                  *reinterpret_cast<const float4*>(qj[g] + c * kCE + u);
              d[g] = fmaf(x.x, f[u], d[g]);
              d[g] = fmaf(x.y, f[u + 1], d[g]);
              d[g] = fmaf(x.z, f[u + 2], d[g]);
              d[g] = fmaf(x.w, f[u + 3], d[g]);
            }
          }
        }
        for (int e = full * kCE; e < hd; ++e) {
          const float ke = elem<TKV>(kr, e, sc);
#pragma unroll
          for (int g = 0; g < G; ++g) d[g] = fmaf(qj[g][e], ke, d[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (j0 + g < nq)
          sp[(j0 + g) * kPart + r] = vis[g] ? d[g] * p.scale : -CUDART_INF_F;
    }
  };
  for (int j0 = 0; j0 < nq;) {
    if (nq - j0 >= kGroup) {
      score(std::integral_constant<int, kGroup>(), j0);
      j0 += kGroup;
    } else if (nq - j0 >= 2) {
      score(std::integral_constant<int, 2>(), j0);
      j0 += 2;
    } else {
      score(std::integral_constant<int, 1>(), j0);
      j0 += 1;
    }
  }
  if (shared) {                      // V into K's buffer
    __syncthreads();
    copy_rows(sv, p.vp);
  }
  stage_wait<0>();
  __syncthreads();

  // the parts' records: acc (hq floats) a (slot, head, part, query),
  // then (m, l) a (slot, head, query, part)
  const long long units = static_cast<long long>(gridDim.z) * p.nh;
  float* acc0 = p.work + unit * p.parts * nq * hq;    // this (slot, head)
  float2* ml0 = reinterpret_cast<float2*>(p.work + units * p.parts * nq * hq)
      + unit * nq * p.parts;

  // the part's softmax, a warp a query, rows lane + 32 u a lane
  for (int j = warp; j < nq; j += kWarps) {
    constexpr int kRows = kPart / 32;
    float* sj = sp + j * kPart;
    float sv4[kRows];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      sv4[u] = sj[lane + 32 * u];
      mx = fmaxf(mx, sv4[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float l = 0.f;
    if (mx != -CUDART_INF_F) {           // warp-uniform
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        sv4[u] = rescale(sv4[u], mx);
        l = __fadd_rn(l, sv4[u]);
        sj[lane + 32 * u] = sv4[u];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
    }
    if (lane == 0) {
      sm[j] = mx;
      sl[j] = l;
      if (ns > 1) ml0[j * p.parts + part] = make_float2(mx, l);
    }
  }
  __syncthreads();

  // acc = sum of p v: kLanes lanes an item of 4 elements, G queries at a
  // time, lane i summing rows i, i + kLanes, ... in order, then a
  // butterfly; the items padded to a multiple of the block's so that
  // every lane reaches every shuffle
  TQ* og = static_cast<TQ*>(p.out) + qoff;
  const int nq4 = hq / 4, li = tid % kLanes;
  auto pv = [&](auto group, int i, int j0) {
    constexpr int G = decltype(group)::value;
    const int e = min(i, nq4 - 1) * 4;
    float4 s4[G];
    const float* pj[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s4[g] = make_float4(0.f, 0.f, 0.f, 0.f);
      pj[g] = sp + (j0 + g) * kPart;
    }
#pragma unroll 4
    for (int k = 0; k < kPart / kLanes; ++k) {
      const int r = li + k * kLanes;
      const float4 v4 = load4<TKV>(sv + r * rs, e, svs[r]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = pj[g][r];
        s4[g].x = fmaf(pr, v4.x, s4[g].x);
        s4[g].y = fmaf(pr, v4.y, s4[g].y);
        s4[g].z = fmaf(pr, v4.z, s4[g].z);
        s4[g].w = fmaf(pr, v4.w, s4[g].w);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        s4[g].x = __fadd_rn(s4[g].x, __shfl_xor_sync(0xffffffffu, s4[g].x, o));
        s4[g].y = __fadd_rn(s4[g].y, __shfl_xor_sync(0xffffffffu, s4[g].y, o));
        s4[g].z = __fadd_rn(s4[g].z, __shfl_xor_sync(0xffffffffu, s4[g].z, o));
        s4[g].w = __fadd_rn(s4[g].w, __shfl_xor_sync(0xffffffffu, s4[g].w, o));
      }
    }
    if (li != 0 || i >= nq4) return;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + g;
      if (sm[j] == -CUDART_INF_F) continue;
      if (ns == 1) {
        const float l = sl[j];
        const float o4[4] = {s4[g].x / l, s4[g].y / l, s4[g].z / l,
                             s4[g].w / l};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u < hd) from_f(o4[u], og + j * hd + e + u);
      } else {
        *reinterpret_cast<float4*>(acc0 + (part * nq + j) * hq + e) = s4[g];
      }
    }
  };
  const int n_items = (nq4 + kItems - 1) / kItems * kItems;
  for (int i = tid / kLanes; i < n_items; i += kItems) {
    for (int j0 = 0; j0 < nq;) {
      if (nq - j0 >= kGroup) {
        pv(std::integral_constant<int, kGroup>(), i, j0);
        j0 += kGroup;
      } else if (nq - j0 >= 2) {
        pv(std::integral_constant<int, 2>(), i, j0);
        j0 += 2;
      } else {
        pv(std::integral_constant<int, 1>(), i, j0);
        j0 += 1;
      }
    }
  }
  if (ns == 1) return;

  // the last part of this (head, slot) to arrive combines the parts:
  // the block's records, then (one thread) a fence and the count
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int prev = atomicAdd(p.counters + unit, 1);
    *s_last = prev == ns - 1;
    if (*s_last) {
      p.counters[unit] = 0;             // for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!*s_last) return;
  // a thread an item (query j, elements e .. e + 3): the parts' (m, l)
  // kBatch at a time for the largest m_p, then the sums in part order,
  // each part's (m, l) and acc read together
  for (int i = tid; i < nq * nq4; i += kThreads) {
    const int j = i / nq4, e = (i % nq4) * 4;
    const float2* mlj = ml0 + j * p.parts;
    const float* aj = acc0 + j * hq + e;
    float mm = -CUDART_INF_F;
    for (int q0 = 0; q0 < ns; q0 += kBatch) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = q0 + u < ns ? __ldcg(mlj + q0 + u)
                           : make_float2(-CUDART_INF_F, 0.f);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) mm = fmaxf(mm, v[u].x);
    }
    float big_l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    bool first = true;
    for (int q0 = 0; q0 < ns; q0 += kSumBatch) {
      float2 v[kSumBatch];
      float4 a4[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        v[u] = make_float2(-CUDART_INF_F, 0.f);
        if (q0 + u < ns) {
          v[u] = __ldcg(mlj + q0 + u);
          a4[u] = __ldcg(reinterpret_cast<const float4*>(
              aj + static_cast<long long>(q0 + u) * nq * hq));
        }
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (v[u].x == -CUDART_INF_F) continue;  // no row of j in the part
        const float w = v[u].x == mm ? 1.f : expf(v[u].x - mm);
        if (first) {
          big_l = __fmul_rn(w, v[u].y);
          acc = make_float4(__fmul_rn(w, a4[u].x), __fmul_rn(w, a4[u].y),
                            __fmul_rn(w, a4[u].z), __fmul_rn(w, a4[u].w));
          first = false;
        } else {
          big_l = __fadd_rn(big_l, __fmul_rn(w, v[u].y));
          acc.x = __fadd_rn(acc.x, __fmul_rn(w, a4[u].x));
          acc.y = __fadd_rn(acc.y, __fmul_rn(w, a4[u].y));
          acc.z = __fadd_rn(acc.z, __fmul_rn(w, a4[u].z));
          acc.w = __fadd_rn(acc.w, __fmul_rn(w, a4[u].w));
        }
      }
    }
    const float o4[4] = {acc.x / big_l, acc.y / big_l, acc.z / big_l,
                         acc.w / big_l};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u < hd) from_f(o4[u], og + j * hd + e + u);
  }
}

template <typename TQ, typename TKV, int VB>
cudaError_t launch_vb(const Params& p, int b, cudaStream_t st) {
  if constexpr (VB < static_cast<int>(sizeof(TKV))) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = smem_bytes(p.nq, p.hd, sizeof(TKV));
    auto kernel = paged_attention_kernel<TQ, TKV, VB>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<dim3(p.parts, p.nh, b), kThreads, smem, st>>>(p);
    return cudaGetLastError();
  }
}

// The widest copy (16, 8, 4, 2 or 1 bytes) that divides a row and the
// pools' base addresses.
template <typename TQ, typename TKV>
cudaError_t launch(const Params& p, int b, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.kp)
      | reinterpret_cast<uintptr_t>(p.vp);
  const int row_bytes = p.hd * static_cast<int>(sizeof(TKV));
  int vb = 16;
  while (vb > static_cast<int>(sizeof(TKV))
         && (row_bytes % vb || addr % vb))
    vb >>= 1;
  switch (vb) {
    case 16: return launch_vb<TQ, TKV, 16>(p, b, st);
    case 8: return launch_vb<TQ, TKV, 8>(p, b, st);
    case 4: return launch_vb<TQ, TKV, 4>(p, b, st);
    case 2: return launch_vb<TQ, TKV, 2>(p, b, st);
    default: return launch_vb<TQ, TKV, 1>(p, b, st);
  }
}

template <typename TQ>
cudaError_t launch_q(const Params& p, int b, int kv_dtype,
                     cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(p, b, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(p, b, st);
    case kI8:
      if (p.ks == nullptr || p.vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(p, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- the prompt-chunk attention on the tensor cores --------------------------
//
// One slot's prompt chunk: sc bf16 queries at logical positions pos ..
// pos + sc - 1 against one layer's bf16 page pool, query j seeing the
// rows s <= pos + j (the linear mask) through the slot's gather row.
// No Pallas kernel is replaced: the JAX package computes it as XLA in
// apex_tpu/models/gpt.py:659 _paged_chunk_prefill_attention, a gather
// of the whole row, fp32 scores divided by sqrt(hd), finfo(f32).min
// where a query cannot see the row, an fp32 softmax and an fp32 product
// with V, one cast to bf16. It promises no bit relation between a chunk
// query and a decode step, and speculation never reaches this path, so
// this kernel leaves the decode kernel's per-query order behind.
//
// What bounds it on an H100: bytes. The live K and V rows are read once
// for all sc queries (4 (pos + sc) nh hd bytes) against 4 operations a
// query a visible K/V element, between sc / 2 and sc operations a byte:
// below the bf16 tensor cores' 295 at sc = 256. What bounded the verify
// kernel's route (16 blocks a launch, scalar fp32 dots from shared
// memory, four launches a chunk in series), and what bounds this
// kernel as built, is the latency of a block's walk over its tiles.
//
// Design. One launch a chunk: one 256-thread block a (64-query tile,
// head, part, slot), the longest tiles first. Two warps share each 16
// queries, each taking half of every tile's 64 keys (two warps a
// scheduler hide each other's mma and exp latency; the halves' m, l and
// acc are combined at the end, first half first). The block walks
// 64-row logical K/V tiles from row 0 to the last row its last query
// sees (tiles wholly past it are never loaded); each row's address
// comes from the gather row (held in shared memory) at s / page and s %
// page, copied by 16-byte cp.async.cg into a three-tile ring of bf16
// rows padded by 16 bytes (ldmatrix reads eight rows on distinct
// banks), hd zero-padded to 32, 64 or 128, two tiles in flight while
// one is used (flash_attention.cu's ring, one stage deeper: a slot's
// chunk leaves one block an SM, so nothing else hides the copies'
// latency). S = q k^T by mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators (exact products, as the reference's upcast einsum), then
// multiplied by the scale in fp32 (q is not prescaled and rounded). The
// mask is applied only on tiles that cross a warp's diagonal or the
// last row read. An online softmax keeps m, l and the accumulator in
// fp32, with expf. P V keeps the fp32 probabilities: p is split into a
// bf16 hi and a bf16 lo = bf16(p - hi) (p - hi is exact), two mma into
// the same fp32 accumulator, hi then lo, so each p keeps about 16 bits
// (its residual below 2^-16 p) where one rounding would keep 8. ctx =
// acc / l, rounded once to bf16, staged through shared memory and
// written as 16-byte rows.
//
// The split: one slot's chunk fills few blocks (64 at sc 256, 16
// heads), and a tile's block walks up to pos / 64 + 4 tiles in series.
// The rows are cut into at most `splits` parts of at least kMinTiles
// tiles (the count from pos, on the card: the grid is sized from the
// table, parts past it exit at once; the grid places every first part
// before any later one, so the first parts spread over the SMs). Each
// part writes its m, l and fp32 accumulator; the last part to arrive,
// by an integer counter that it resets, combines them in part order
// (weights exp(m_p - M)) and writes ctx. No float atomics: the same bits
// on every launch, whichever part arrives last. The ring's depth, the
// key halves and kMinTiles were chosen by their times on the card
// (PERF.md): at pos 768 the split walk takes about 0.7 of one part's.
//
// Every sum's order depends only on logical positions, pos, sc and hd,
// never on physical page ids: the same logical contents under any page
// placement give the same bits. Shared memory is (64 + 6 x 64) padded
// rows plus the gather row, 64.5 KB at hd 64; at most 128 registers a
// thread at hd <= 64, so two blocks fit an SM (one at hd 128).
namespace chunk {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;        // queries a block: four row groups of 16
constexpr int kBK = 64;        // logical rows a K/V tile
constexpr int kKW = kBK / 2;   // keys of a tile a warp takes: one half
constexpr int kThreads = 256;  // two warps (key halves) a row group
constexpr int kStages = 3;     // K/V tiles in the ring
constexpr int kPad = 8;        // bf16 padding a shared row: 16 bytes
constexpr int kMinTiles = 2;   // the fewest tiles a part of a split walk
constexpr int kMaxSplits = 4;
constexpr int kMaxHd = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices (ldmatrix; .trans for an operand stored k-major)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col); lane (g =
// lane / 4, t = lane % 4) holds c[0..1] at row g, cols 2t, 2t + 1 and
// c[2..3] at row g + 8 (flash_attention.cu's mma_bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p's bf16 hi and lo = bf16(p - hi) for two columns (low column in the
// low half); p - hi is exact in fp32
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes global -> shared, bypassing L1; `full` false zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This lane's row address for an x4 ldmatrix of the 16 x 16 slice at
// (row0, col0): A operand (row major), B from n-major rows, B from
// k-major rows (.trans); flash_attention.cu's a_addr, bn_addr, bk_addr
template <int LD>
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int row0, int col0,
                                           int lane) {
  return smem_addr(t + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bn_addr(const bf16* t, int n0, int k0,
                                            int lane) {
  return smem_addr(t + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 +
                   ((lane >> 3) & 1) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bk_addr(const bf16* t, int k0, int n0,
                                            int lane) {
  return smem_addr(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

struct Params {
  const bf16* q;     // (b, nh, sc, hd)
  const bf16* kp;    // (num_pages, nh, page, hd)
  const bf16* vp;
  const int* bt;     // (b, max_pages)
  const int* pos;    // (b,)
  bf16* out;         // (b, nh, sc, hd)
  float* work;       // parts' m, l, acc; null without a split
  int* counters;     // arrival counters, zero; null without a split
  int nb, nh, sc, page, hd, max_pages, splits, nqt;
  float scale;
};

// head_dim rounded up to the tile width the kernel is built for
__host__ __device__ __forceinline__ int tile_dm(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}

size_t smem_bytes(int hd, int max_pages) {
  return static_cast<size_t>(kBQ + 2 * kStages * kBK) * (tile_dm(hd) + kPad) *
             2 +
         (static_cast<size_t>(max_pages) + 3) / 4 * 16;
}

// two blocks an SM at hd <= 64 (at most 128 registers a thread), one
// at 128
template <int DM>
__global__ void __launch_bounds__(kThreads, DM == 128 ? 1 : 2)
chunk_attention_kernel(const Params p) {
  constexpr int LD = DM + kPad;
  constexpr int KC = DM / 16;          // k chunks of q k^T
  constexpr int NT = kKW / 8;          // score n-tiles a warp
  constexpr int ND = DM / 8;           // output n-tiles
  constexpr int CH = DM / 8;           // 16-byte chunks a row
  constexpr int ITER = kBK * CH / kThreads;
  constexpr int RSTEP = kThreads / CH; // rows between a thread's copies
  static_assert(kBK * CH % kThreads == 0 && kBQ == kBK, "whole copies");
  extern __shared__ float4 smem4[];
  __shared__ int s_last;
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + kBQ * LD;                  // kStages buffers
  bf16* Vs = Ks + kStages * kBK * LD;        // kStages buffers
  int* Ts = reinterpret_cast<int*>(Vs + kStages * kBK * LD);  // gather row

  // the grid runs x (tiles, the longest first), then heads, then (part,
  // slot): every slot's first parts are placed before any later part
  const int qt = p.nqt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int part = blockIdx.z / p.nb, b = blockIdx.z % p.nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // warp (qw, kh): queries qw * 16 .. + 15 of the tile, keys kh * kKW ..
  // + kKW - 1 of each K/V tile
  const int qw = warp & 3, kh = warp >> 2, kc0 = kh * kKW;
  const int j0 = qt * kBQ;
  const int p0 = p.pos[b];
  // the rows this tile's queries see: 0 .. nrows - 1
  const int nrows = min(p0 + min(j0 + kBQ, p.sc), p.max_pages * p.page);
  const int n_kt = (nrows + kBK - 1) / kBK;
  const int ns = max(1, min(p.splits, n_kt / kMinTiles));
  if (part >= ns) return;
  const int kt_lo = part * n_kt / ns, kt_hi = (part + 1) * n_kt / ns;

  const int* row = p.bt + static_cast<long long>(b) * p.max_pages;
  for (int i = tid; i * p.page < nrows; i += kThreads) Ts[i] = row[i];
  __syncthreads();

  const long long page_stride = static_cast<long long>(p.nh) * p.page * p.hd;
  const bf16* kg = p.kp + static_cast<long long>(h) * p.page * p.hd;
  const bf16* vg = p.vp + static_cast<long long>(h) * p.page * p.hd;
  const int cc = (tid % CH) * 8;       // this thread's column of every row
  // tile kt's rows, each from its page in the gather row (one division a
  // tile, then steps of RSTEP rows); zeros past the last row read and hd
  auto issue = [&](int kt) {
    int r = tid / CH, s = kt * kBK + r;
    int lp = s / p.page, rin = s % p.page;
    bf16* kd = Ks + (kt % kStages) * kBK * LD;
    bf16* vd = Vs + (kt % kStages) * kBK * LD;
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const bool in = s < nrows && cc < p.hd;
      long long off = 0;
      if (in)
        off = Ts[lp] * page_stride + static_cast<long long>(rin) * p.hd + cc;
      cp_async16(smem_addr(kd + r * LD + cc), kg + off, in);
      cp_async16(smem_addr(vd + r * LD + cc), vg + off, in);
      r += RSTEP;
      s += RSTEP;
      for (rin += RSTEP; rin >= p.page; rin -= p.page) ++lp;
    }
  };
  const bf16* qg =
      p.q + ((static_cast<long long>(b) * p.nh + h) * p.sc + j0) * p.hd;
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int r = tid / CH + it * RSTEP;
    const bool in = j0 + r < p.sc && cc < p.hd;
    cp_async16(smem_addr(Qs + r * LD + cc), in ? qg + r * p.hd + cc : qg,
               in);
  }
  // one commit group a tile (the first with q): tile kt has landed once
  // at most kStages - 2 later groups are pending
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (kt_lo + st < kt_hi) issue(kt_lo + st);
    cp_async_commit();
  }

  const int row0 = j0 + qw * 16;      // this warp's first query
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qf[KC][4];

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's buffer consumed
    if (kt + kStages - 1 < kt_hi) issue(kt + kStages - 1);
    cp_async_commit();
    if (kt == kt_lo) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc], a_addr<LD>(Qs, qw * 16, kc * 16, lane));
    }
    const int k0 = kt * kBK + kc0;    // this warp's first key
    const bf16* Kb = Ks + (kt % kStages) * kBK * LD + kc0 * LD;
    const bf16* Vb = Vs + (kt % kStages) * kBK * LD + kc0 * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t r[4];
        ldsm_x4(r, bn_addr<LD>(Kb, j * 16, kc * 16, lane));
        mma_bf16(s[2 * j], qf[kc], r[0], r[1]);
        mma_bf16(s[2 * j + 1], qf[kc], r[2], r[3]);
      }

    // the online softmax over this lane's rows row0 + g and row0 + g +
    // 8: scores times the scale in fp32; -inf (p = 0) where a query
    // cannot see the row, on tiles that cross the warp's diagonal or the
    // last row read
    auto softmax = [&](auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[n][i] *= p.scale;
          if constexpr (MASKED) {
            const int col = k0 + n * 8 + 2 * t4 + (i & 1);
            if (col >= nrows || col > p0 + row0 + g + (i >> 1) * 8)
              s[n][i] = -CUDART_INF_F;
          }
        }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = rescale(m[r], m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pr;
          if constexpr (MASKED)
            pr = s[n][i] == -CUDART_INF_F ? 0.f : expf(s[n][i] - m[i >> 1]);
          else
            pr = expf(s[n][i] - m[i >> 1]);
          l[i >> 1] += pr;
          s[n][i] = pr;
        }
    };
    if (k0 + kKW > nrows || k0 + kKW - 1 > p0 + row0)
      softmax(std::true_type());
    else
      softmax(std::false_type());

    // acc += p v, p as hi + lo: the score accumulator's layout is the A
    // operand's, two n-tiles to a k chunk of 16 rows
#pragma unroll
    for (int kk = 0; kk < kKW / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(hi[0], lo[0], s[2 * kk][0], s[2 * kk][1]);
      split_bf16(hi[1], lo[1], s[2 * kk][2], s[2 * kk][3]);
      split_bf16(hi[2], lo[2], s[2 * kk + 1][0], s[2 * kk + 1][1]);
      split_bf16(hi[3], lo[3], s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, bk_addr<LD>(Vb, kk * 16, j * 16, lane));
        mma_bf16(acc[2 * j], hi, r[0], r[1]);
        mma_bf16(acc[2 * j], lo, r[0], r[1]);
        mma_bf16(acc[2 * j + 1], hi, r[2], r[3]);
        mma_bf16(acc[2 * j + 1], lo, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  {
    // the second key half's m, l and acc into the first's, through the
    // ring's shared memory: acc = acc_0 e^(m_0 - m) + acc_1 e^(m_1 - m)
    constexpr int XW = 16 * DM + 32;
    float* x = reinterpret_cast<float*>(Ks) + qw * XW;
    __syncthreads();                   // every warp is past the ring
    if (kh == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(x + (g + 8 * r) * DM + n * 8 + 2 * t4) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
        if (t4 == 0) {
          x[16 * DM + g + 8 * r] = m[r];
          x[16 * DM + 16 + g + 8 * r] = l[r];
        }
      }
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = x[16 * DM + g + 8 * r];
        const float mm = fmaxf(m[r], m1);
        const float c0 = rescale(m[r], mm), c1 = rescale(m1, mm);
        l[r] = l[r] * c0 + x[16 * DM + 16 + g + 8 * r] * c1;
        m[r] = mm;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float2 a1 = *reinterpret_cast<const float2*>(
              x + (g + 8 * r) * DM + n * 8 + 2 * t4);
          acc[n][2 * r] = acc[n][2 * r] * c0 + a1.x * c1;
          acc[n][2 * r + 1] = acc[n][2 * r + 1] * c0 + a1.y * c1;
        }
      }
    }
  }
  bf16* og = p.out + ((static_cast<long long>(b) * p.nh + h) * p.sc + j0) *
                         p.hd;
  if (ns == 1) {
    if (kh != 0) return;
    // ctx = acc / l through this warp's own 16 rows of the q tile, out
    // in 16-byte rows
    bf16* Qw = Qs + qw * 16 * LD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(Qw + (g + 8 * r) * LD + n * 8 +
                                           2 * t4) =
            __floats2bfloat162_rn(acc[n][2 * r] / l[r],
                                  acc[n][2 * r + 1] / l[r]);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int i = lane + it * 32;
      const int r = i / CH, c = (i % CH) * 8, j = qw * 16 + r;
      if (j0 + j < p.sc && c < p.hd)
        *reinterpret_cast<uint4*>(og + static_cast<long long>(j) * p.hd + c) =
            *reinterpret_cast<const uint4*>(Qw + r * LD + c);
    }
    return;
  }

  // a split walk: this part's m, l and acc, then the last part to arrive
  // combines the parts in part order
  const long long unit = (static_cast<long long>(b) * p.nh + h) * p.nqt + qt;
  const long long part_floats = static_cast<long long>(kBQ) * (p.hd + 2);
  float* mine = p.work + (unit * p.splits + part) * part_floats;
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < p.hd)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(mine + (qw * 16 + g + 8 * r) * p.hd +
                                     c) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
    if (t4 == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = qw * 16 + g + 8 * r;
        mine[kBQ * p.hd + j] = m[r];
        mine[kBQ * p.hd + kBQ + j] = l[r];
      }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(p.counters + unit, 1);
    s_last = prev == ns - 1;
    if (s_last) p.counters[unit] = 0;   // for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* parts = p.work + unit * p.splits * part_floats;
  float* W = reinterpret_cast<float*>(Qs);   // [ns][kBQ] weights, [kBQ] L
  if (tid < kBQ) {
    float mm = -CUDART_INF_F;
    for (int q = 0; q < ns; ++q)
      mm = fmaxf(mm, __ldcg(parts + q * part_floats + kBQ * p.hd + tid));
    float big_l = 0.f;
    for (int q = 0; q < ns; ++q) {
      const float* pq = parts + q * part_floats + kBQ * p.hd;
      const float w = rescale(__ldcg(pq + tid), mm);
      W[q * kBQ + tid] = w;
      big_l += w * __ldcg(pq + kBQ + tid);
    }
    W[ns * kBQ + tid] = big_l;
  }
  __syncthreads();
  // ctx = sum over parts (in part order) of w_q acc_q, over L: each
  // thread ITEMS float4s of the tile, every part's loads in flight
  constexpr int Q4 = DM / 4;
  constexpr int ITEMS = kBQ * Q4 / kThreads;
  float4 o[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q) {
    if (q < ns) {
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int i = tid + u * kThreads, j = i / Q4, c = (i % Q4) * 4;
        if (c < p.hd && j0 + j < p.sc) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(
              parts + q * part_floats + j * p.hd + c));
          const float w = W[q * kBQ + j];
          o[u].x += w * a.x;
          o[u].y += w * a.y;
          o[u].z += w * a.z;
          o[u].w += w * a.w;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int i = tid + u * kThreads, j = i / Q4, c = (i % Q4) * 4;
    if (c < p.hd && j0 + j < p.sc) {
      const float big_l = W[ns * kBQ + j];
      const __nv_bfloat162 lo2 =
          __floats2bfloat162_rn(o[u].x / big_l, o[u].y / big_l);
      const __nv_bfloat162 hi2 =
          __floats2bfloat162_rn(o[u].z / big_l, o[u].w / big_l);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo2);
      v.y = *reinterpret_cast<const uint32_t*>(&hi2);
      *reinterpret_cast<uint2*>(og + static_cast<long long>(j) * p.hd + c) = v;
    }
  }
}

template <int DM>
cudaError_t launch_chunk(const Params& p, cudaStream_t st) {
  const size_t smem = smem_bytes(p.hd, p.max_pages);
  auto kernel = chunk_attention_kernel<DM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.nqt, p.nh, p.splits * p.nb);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace chunk

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most queries a slot one launch holds, and the logical positions
// a part of a slot's rows holds.
int apx_paged_attention_max_k1() { return kMaxK1; }
int apx_paged_attention_part_rows() { return kPart; }

// q, out: (b, nh, wk, hd) contiguous, dtype q_dtype (0 fp32, 1 bf16);
// the launch computes the window's queries q0 .. q0 + k1 - 1.
// k_pages, v_pages: (num_pages, nh, page, hd) contiguous, dtype kv_dtype
// (0 fp32, 1 bf16, 2 int8); k_scale, v_scale: (num_pages, nh) fp32 for
// int8, else null. block_tables: (b, max_pages) int32; pos: (b,) int32.
// anc: (b, wk, wk) bytes, anc[b][i][j] != 0 when window row i is
// visible to query j, or null for the linear mask (i <= j). Query j
// attends logical rows s < max_pages * page with s < pos, or s - pos in
// [0, wk) admitted by the mask. With parts = ceil(max_pages * page /
// 128) > 1, work holds b * nh * parts * k1 * (2 + ceil(hd / 4) * 4) fp32
// and counters b * nh int32 zeros (left zero); with one part both may
// be null. 1 <= k1 <= 64, q0 >= 0, q0 + k1 <= wk, hd <= 256, b <= 65535.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
int apx_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* pos, const void* anc, void* out,
                        void* work, void* counters, int b, int nh, int wk,
                        int q0, int k1, int page, int hd, int max_pages,
                        int q_dtype, int kv_dtype, float scale,
                        void* stream) {
  const long long parts =
      (static_cast<long long>(max_pages) * page + kPart - 1) / kPart;
  if (b < 1 || b > 65535 || nh < 1 || nh > 65535 || k1 < 1
      || k1 > kMaxK1 || q0 < 0 || wk < k1 || q0 > wk - k1 || page < 1
      || hd < 1 || hd > kMaxHd || max_pages < 1
      || static_cast<long long>(max_pages) * page > 0x7fffffff
      || (parts > 1 && (work == nullptr || counters == nullptr))
      || (kv_dtype >= kF32 && kv_dtype <= kI8
          && smem_bytes(k1, hd, kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2
                                                                         : 1)
                 > kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.kp = k_pages;
  p.vp = v_pages;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.bt = static_cast<const int*>(block_tables);
  p.pos = static_cast<const int*>(pos);
  p.anc = static_cast<const uint8_t*>(anc);
  p.out = out;
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  p.nh = nh;
  p.wk = wk;
  p.q0 = q0;
  p.nq = k1;
  p.page = page;
  p.hd = hd;
  p.max_pages = max_pages;
  p.parts = static_cast<int>(parts);
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kF32)
    err = launch_q<float>(p, b, kv_dtype, st);
  else if (q_dtype == kBF16)
    err = launch_q<__nv_bfloat16>(p, b, kv_dtype, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The most parts a chunk tile's key walk is cut into, and the fewest
// 64-row tiles a part holds.
int apx_paged_chunk_max_splits() { return chunk::kMaxSplits; }
int apx_paged_chunk_min_tiles() { return chunk::kMinTiles; }

// The prompt-chunk attention. q, out: (b, nh, sc, hd) bf16 contiguous;
// k_pages, v_pages: (num_pages, nh, page, hd) bf16 contiguous;
// block_tables: (b, max_pages) int32 (each slot's gather row); pos: (b,)
// int32. Query j of slot b attends the logical rows s <= pos[b] + j, s <
// max_pages * page. splits: 1 .. 4, the most parts a 64-query tile's
// walk over the rows is cut into (the count on the card from pos); with
// splits > 1, work holds splits * b * nh * ceil(sc / 64) * 64 * (hd + 2)
// fp32 and counters b * nh * ceil(sc / 64) int32 zeros (left zero).
// 8 <= hd <= 128, hd % 8 == 0; q, pools and out 16-byte aligned;
// nh, b * splits <= 65535. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
int apx_paged_chunk_attention(const void* q, const void* k_pages,
                              const void* v_pages, const void* block_tables,
                              const void* pos, void* out, void* work,
                              void* counters, int b, int nh, int sc,
                              int page, int hd, int max_pages, int splits,
                              float scale, void* stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
      reinterpret_cast<uintptr_t>(v_pages) | reinterpret_cast<uintptr_t>(out);
  if (b < 1 || nh < 1 || nh > 65535 || sc < 1 || page < 1 || hd < 8 ||
      hd > chunk::kMaxHd || hd % 8 || max_pages < 1 || splits < 1 ||
      splits > chunk::kMaxSplits || b * splits > 65535 || addr % 16 ||
      (splits > 1 && (work == nullptr || counters == nullptr)) ||
      chunk::smem_bytes(hd, max_pages) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  chunk::Params p;
  p.q = static_cast<const chunk::bf16*>(q);
  p.kp = static_cast<const chunk::bf16*>(k_pages);
  p.vp = static_cast<const chunk::bf16*>(v_pages);
  p.bt = static_cast<const int*>(block_tables);
  p.pos = static_cast<const int*>(pos);
  p.out = static_cast<chunk::bf16*>(out);
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  p.nb = b;
  p.nh = nh;
  p.sc = sc;
  p.page = page;
  p.hd = hd;
  p.max_pages = max_pages;
  p.splits = splits;
  p.nqt = (sc + chunk::kBQ - 1) / chunk::kBQ;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (chunk::tile_dm(hd)) {
    case 32:
      err = chunk::launch_chunk<32>(p, st);
      break;
    case 64:
      err = chunk::launch_chunk<64>(p, st);
      break;
    default:
      err = chunk::launch_chunk<128>(p, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
