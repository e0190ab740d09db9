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
// pair; below the card's 295 flops a byte for any k1 <= 64.
//
// Design (a simple first version): one block of 256 threads a (head,
// slot), at most 128 registers a thread so that two blocks share an
// SM. q (k1 x hd) and the k1 accumulators live in shared memory in
// fp32. The block walks the rows in tiles of 128 logical positions: the
// tile's K and V rows are loaded (each row's physical page read from the
// table at its logical page), upcast (dequantized) into shared memory,
// and the next tile's loads are issued before this tile is computed.
// Rows are padded to whole float4s (zeros past hd). Scores: a thread a
// (query, row) pair, its dot product over the float4s in element order.
// Softmax: one warp a query, four rows a
// lane (r + 32 i): tile max, rescale c = exp(m - m'), p = exp(s - m'),
// the tile's sum of p (each lane's four in order, then a butterfly). PV: 8
// lanes an item of 4 elements of one query, each summing every 8th row
// of the tile in order, the 8 parts then a butterfly. A tile a query
// cannot see is skipped for it. ctx = acc / l, rounded once to q's type.
//
// The order of every operation of query j depends only on logical
// positions, hd and the rows it can see, never on k1, the other
// queries, or physical page ids. So the same logical contents under any
// page placement give the same bits, and column j of a linear verify
// gives the bits of a decode step at pos + j (the rows the verify
// loads beyond a query's reach enter its sums as exact zeros).
//
// A launch takes a slice of the window's queries: nq queries from q0
// of a window of wk (q, out and anc keep the window's shape). Shared
// memory holds the slice's queries, so a window wider than one launch
// holds (kMaxK1, or fewer at a wide hd) runs as consecutive slices,
// and by the order above they give the bits of one launch over all.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 128;        // logical positions a tile (four a lane)
constexpr int kParts = 8;      // lanes a (query, 4 elements) of the PV sum
constexpr int kPad = 4;        // K and V row padding in shared memory
constexpr int kMaxV = 8;       // vectors a thread has in flight
constexpr int kMaxK1 = 64;
constexpr int kMaxHd = 256;
constexpr int kMaxSmem = 232448;

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

// exp(a - b), 0 where a is -inf (a query that has seen no row yet)
__device__ __forceinline__ float rescale(float a, float b) {
  return a == -CUDART_INF_F ? 0.f : expf(a - b);
}

// head_dim rounded up to whole float4s: q and the tiles' rows carry
// zeros past hd, so every dot product and PV sum runs over float4s
__host__ __device__ __forceinline__ int padded(int hd) {
  return (hd + 3) / 4 * 4;
}

size_t smem_bytes(int k1, int hd) {
  const size_t hp = padded(hd);
  return sizeof(float) * (2 * static_cast<size_t>(kT) * (hp + kPad)
                          + 2 * static_cast<size_t>(k1) * hp
                          + static_cast<size_t>(k1) * kT + 3 * k1);
}

// The tile's K and V rows as VE-element vectors: vector v < 2 kT rv
// (rv vectors a row) is K (v < kT rv) or V, row (v / rv) % kT, column
// (v % rv) VE. A thread's first kMaxV vectors (every vector of a tile up
// to 2048 of them) keep their row, column and logical page in registers
// from tile to tile, so the hot loop divides nothing; wider tiles load
// the rest through the general path.
template <typename TKV, int VE, bool kQ8>
struct Tile {
  using R = typename Raw<VE * sizeof(TKV)>::T;
  const TKV* kp;
  const TKV* vp;
  const float* ks;
  const float* vs;
  const int* row;
  int nh, h, page, hd, rv, nmax;
  int q_t, r_t;                  // kT / page, kT % page
  int r[kMaxV], c[kMaxV], lp[kMaxV], rin[kMaxV], phys[kMaxV];

  __device__ __forceinline__ int total() const { return 2 * kT * rv; }
  __device__ __forceinline__ bool is_k(int i) const {
    return static_cast<int>(threadIdx.x) + i * kThreads < kT * rv;
  }
  __device__ __forceinline__ bool on(int i) const {
    return static_cast<int>(threadIdx.x) + i * kThreads < total();
  }

  __device__ __forceinline__ void init() {
    q_t = kT / page;
    r_t = kT % page;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      const int v = threadIdx.x + i * kThreads;
      r[i] = (v / rv) % kT;
      c[i] = (v % rv) * VE;
      lp[i] = r[i] / page;
      rin[i] = r[i] % page;
    }
  }

  // the next tile: every row kT positions on
  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      lp[i] += q_t;
      rin[i] += r_t;
      if (rin[i] >= page) {
        rin[i] -= page;
        ++lp[i];
      }
    }
  }

  // issue the loads of the thread's first kMaxV vectors of tile t0
  __device__ __forceinline__ void fetch(R* raw, int t0) {
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (on(i) && t0 + r[i] < nmax) {
        phys[i] = row[lp[i]];
        const long long off =
            ((static_cast<long long>(phys[i]) * nh + h) * page + rin[i])
            * hd + c[i];
        raw[i] = *reinterpret_cast<const R*>((is_k(i) ? kp : vp) + off);
      } else {
        raw[i] = R();
      }
    }
  }

  // 16-byte stores where the vector has 4 elements or more (rows and
  // columns are then multiples of 4 floats): scalar stores of 8-element
  // vectors would put 8 lanes of a warp on each bank
  __device__ __forceinline__ void store(const R& raw, float* dst,
                                        float sc) const {
    const TKV* e = reinterpret_cast<const TKV*>(&raw);
    float f[VE];
#pragma unroll
    for (int u = 0; u < VE; ++u)
      f[u] = kQ8 ? __fmul_rn(to_f(e[u]), sc) : to_f(e[u]);
    if constexpr (VE % 4 == 0) {
#pragma unroll
      for (int u = 0; u < VE; u += 4)
        *reinterpret_cast<float4*>(dst + u) =
            make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < VE; ++u) dst[u] = f[u];
    }
  }

  // upcast (dequantize) them into the tile (K and V rows hd + kPad
  // floats apart)
  __device__ __forceinline__ void put(const R* raw, int t0, float* sk,
                                      float* sv) const {
    const int ld = padded(hd) + kPad;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (on(i)) {
        float sc = 1.f;
        if (kQ8 && t0 + r[i] < nmax)
          sc = (is_k(i) ? ks : vs)[static_cast<long long>(phys[i]) * nh + h];
        store(raw[i], (is_k(i) ? sk : sv) + r[i] * ld + c[i], sc);
      }
    }
  }

  // the vectors past the first kMaxV a thread (tiles of more than 2048
  // vectors), loaded and stored by the general path
  __device__ __forceinline__ void rest(int t0, float* sk, float* sv) const {
    const int ld = padded(hd) + kPad;
    for (int v = threadIdx.x + kMaxV * kThreads; v < total();
         v += kThreads) {
      const bool k = v < kT * rv;
      const int rr = (v / rv) % kT, cc = (v % rv) * VE, t = t0 + rr;
      R raw = R();
      float sc = 1.f;
      if (t < nmax) {
        const int ph = row[t / page];
        const long long off =
            ((static_cast<long long>(ph) * nh + h) * page + t % page) * hd
            + cc;
        raw = *reinterpret_cast<const R*>((k ? kp : vp) + off);
        if (kQ8) sc = (k ? ks : vs)[static_cast<long long>(ph) * nh + h];
      }
      store(raw, (k ? sk : sv) + rr * ld + cc, sc);
    }
  }
};

template <typename TQ, typename TKV, int VE, bool kQ8>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_kernel(const TQ* __restrict__ q,
                       const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ pos,
                       const uint8_t* __restrict__ anc,
                       TQ* __restrict__ out, int nh, int wk, int q0,
                       int k1, int page, int hd, int max_pages,
                       float scale) {
  // k1: the slice's queries, window queries q0 .. q0 + k1 - 1 of wk
  using T = Tile<TKV, VE, kQ8>;
  extern __shared__ __align__(16) float sm[];
  const int hp = padded(hd), ld = hp + kPad;
  float* sk = sm;                          // kT x ld
  float* sv = sk + kT * ld;                // kT x ld
  float* sq = sv + kT * ld;                // k1 x hp
  float* sacc = sq + k1 * hp;              // k1 x hp
  float* sp = sacc + k1 * hp;              // k1 x kT scores, then p
  float* sm_m = sp + k1 * kT;              // k1
  float* sm_l = sm_m + k1;                 // k1
  float* sm_c = sm_l + k1;                 // k1; -1: tile skipped

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_len = max_pages * page;
  const int p0 = pos[b];
  // rows any query of the slice may see: a tree's ancestors may lie
  // anywhere in the window, a linear query's up to its own row
  const int nmax = min(p0 + (anc != nullptr ? wk : q0 + k1), s_len);
  const long long qoff =
      ((static_cast<long long>(b) * nh + h) * wk + q0) * hd;
  const uint8_t* a = anc == nullptr
      ? nullptr : anc + static_cast<long long>(b) * wk * wk;

  for (int i = threadIdx.x; i < k1 * hp; i += kThreads) {
    const int j = i / hp, e = i % hp;
    sq[i] = e < hd ? to_f(q[qoff + j * hd + e]) : 0.f;
    sacc[i] = 0.f;
  }
  // the rows' columns past hd stay zero (no load writes them)
  for (int i = threadIdx.x; i < 2 * kT * (hp - hd); i += kThreads) {
    const int rr = i / (hp - hd), e = hd + i % (hp - hd);
    sk[rr * ld + e] = 0.f;               // rr < 2 kT: K then V rows
  }
  for (int j = threadIdx.x; j < k1; j += kThreads) {
    sm_m[j] = -CUDART_INF_F;
    sm_l[j] = 0.f;
  }

  T tile{kp, vp, ks, vs, bt + static_cast<long long>(b) * max_pages,
         nh, h, page, hd, hd / VE, nmax};
  tile.init();
  typename T::R raw[kMaxV];
  tile.fetch(raw, 0);

  for (int t0 = 0; t0 < nmax; t0 += kT) {
    tile.put(raw, t0, sk, sv);
    tile.rest(t0, sk, sv);
    __syncthreads();
    if (t0 + kT < nmax) {                     // in flight below
      tile.advance();
      tile.fetch(raw, t0 + kT);
    }

    // scores, a thread a (query, row): the dot product over the
    // float4s of q and of the K row, in element order
    for (int pr = threadIdx.x; pr < k1 * kT; pr += kThreads) {
      const int j = pr / kT, r = pr % kT;
      const int t = t0 + r, w = t - p0;
      const bool vis = t < s_len
          && (w < 0 || (w < wk && (a != nullptr
                                   ? a[static_cast<long long>(w) * wk + q0
                                       + j] != 0
                                   : w <= q0 + j)));
      float d = 0.f;
      if (vis) {
        const float4* qv = reinterpret_cast<const float4*>(sq + j * hp);
        const float4* kv = reinterpret_cast<const float4*>(sk + r * ld);
#pragma unroll 4
        for (int e = 0; e < hp / 4; ++e) {
          const float4 x = qv[e], y = kv[e];
          d = fmaf(x.x, y.x, d);
          d = fmaf(x.y, y.y, d);
          d = fmaf(x.z, y.z, d);
          d = fmaf(x.w, y.w, d);
        }
      }
      sp[j * kT + r] = vis ? d * scale : -CUDART_INF_F;
    }
    __syncthreads();

    // online softmax, a warp a query, rows lane + 32 i a lane
    for (int j = warp; j < k1; j += kWarps) {
      constexpr int kRows = kT / 32;
      float sv4[kRows], p[kRows];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        sv4[u] = sp[j * kT + 32 * u + lane];
        mx = fmaxf(mx, sv4[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx == -CUDART_INF_F) {           // warp-uniform
        if (lane == 0) sm_c[j] = -1.f;
        continue;
      }
      const float m_old = sm_m[j];
      const float mn = fmaxf(m_old, mx);
      const float c = rescale(m_old, mn);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        p[u] = sv4[u] == -CUDART_INF_F ? 0.f : expf(sv4[u] - mn);
        ps = __fadd_rn(ps, p[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
#pragma unroll
      for (int u = 0; u < kRows; ++u) sp[j * kT + 32 * u + lane] = p[u];
      if (lane == 0) {
        sm_c[j] = c;
        sm_m[j] = mn;
        sm_l[j] = __fadd_rn(__fmul_rn(sm_l[j], c), ps);
      }
    }
    __syncthreads();

    // acc = acc c + sum of the tile's p v: kParts lanes an item of 4
    // elements of one query, part q summing rows q, q + kParts, ... in
    // order, then a butterfly; the items padded to a multiple of the
    // block's so that every lane reaches every shuffle
    {
      constexpr int kItems = kThreads / kParts;
      const int part = threadIdx.x % kParts, nq = hp / 4;
      const int n_items = (k1 * nq + kItems - 1) / kItems * kItems;
      for (int i = threadIdx.x / kParts; i < n_items; i += kItems) {
        const int j = min(i / nq, k1 - 1), e = (i % nq) * 4;
        const bool on = i < k1 * nq && sm_c[j] >= 0.f;
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (on) {
#pragma unroll 4
          for (int r = part; r < kT; r += kParts) {
            const float pj = sp[j * kT + r];
            const float4 v4 = *reinterpret_cast<const float4*>(
                sv + r * ld + e);
            s4.x = fmaf(pj, v4.x, s4.x);
            s4.y = fmaf(pj, v4.y, s4.y);
            s4.z = fmaf(pj, v4.z, s4.z);
            s4.w = fmaf(pj, v4.w, s4.w);
          }
        }
#pragma unroll
        for (int o = 1; o < kParts; o <<= 1) {
          s4.x += __shfl_xor_sync(0xffffffffu, s4.x, o);
          s4.y += __shfl_xor_sync(0xffffffffu, s4.y, o);
          s4.z += __shfl_xor_sync(0xffffffffu, s4.z, o);
          s4.w += __shfl_xor_sync(0xffffffffu, s4.w, o);
        }
        if (on && part == 0) {
          float* acc = sacc + j * hp + e;
          const float c = sm_c[j];
          acc[0] = __fadd_rn(__fmul_rn(acc[0], c), s4.x);
          acc[1] = __fadd_rn(__fmul_rn(acc[1], c), s4.y);
          acc[2] = __fadd_rn(__fmul_rn(acc[2], c), s4.z);
          acc[3] = __fadd_rn(__fmul_rn(acc[3], c), s4.w);
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k1 * hd; i += kThreads) {
    const int j = i / hd;
    from_f(sacc[j * hp + i % hd] / sm_l[j], out + qoff + i);
  }
}

template <typename TQ, typename TKV, int VE>
cudaError_t launch_ve(const void* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* bt,
                      const int* pos, const uint8_t* anc, void* out,
                      int b, int nh, int wk, int q0, int k1, int page,
                      int hd, int max_pages, float scale,
                      cudaStream_t st) {
  if constexpr (VE * sizeof(TKV) > 16) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = smem_bytes(k1, hd);
    const dim3 grid(nh, b);
    const TQ* qq = static_cast<const TQ*>(q);
    TQ* oo = static_cast<TQ*>(out);
    const TKV* kk = static_cast<const TKV*>(kp);
    const TKV* vv = static_cast<const TKV*>(vp);
    auto run = [&](auto kernel) {
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
      }
      kernel<<<grid, kThreads, smem, st>>>(qq, kk, vv, ks, vs, bt, pos,
                                           anc, oo, nh, wk, q0, k1, page,
                                           hd, max_pages, scale);
      return cudaGetLastError();
    };
    if (ks != nullptr)
      return run(paged_attention_kernel<TQ, TKV, VE, true>);
    return run(paged_attention_kernel<TQ, TKV, VE, false>);
  }
}

// The widest vector (16, 8, 4, 2 or 1 bytes) that divides a row and
// the pools' base addresses.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* bt,
                   const int* pos, const uint8_t* anc, void* out, int b,
                   int nh, int wk, int q0, int k1, int page, int hd,
                   int max_pages, float scale, cudaStream_t st) {
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
    return launch_ve<TQ, TKV, N>(q, kp, vp, ks, vs, bt, pos, anc, out, b,  \
                                 nh, wk, q0, k1, page, hd, max_pages,      \
                                 scale, st);
  APX_VE(16) APX_VE(8) APX_VE(4) APX_VE(2) APX_VE(1)
#undef APX_VE
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* pos, const uint8_t* anc, void* out, int b,
                     int nh, int wk, int q0, int k1, int page, int hd,
                     int max_pages, int kv_dtype, float scale,
                     cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, kp, vp, nullptr, nullptr, bt, pos, anc,
                               out, b, nh, wk, q0, k1, page, hd, max_pages,
                               scale, st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, kp, vp, nullptr, nullptr, bt,
                                       pos, anc, out, b, nh, wk, q0, k1,
                                       page, hd, max_pages, scale, st);
    case kI8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(q, kp, vp, ks, vs, bt, pos, anc, out, b,
                                nh, wk, q0, k1, page, hd, max_pages, scale,
                                st);
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

// The most queries a slot one launch holds.
int apx_paged_attention_max_k1() { return kMaxK1; }

// q, out: (b, nh, wk, hd) contiguous, dtype q_dtype (0 fp32, 1 bf16);
// the launch computes the window's queries q0 .. q0 + k1 - 1.
// k_pages, v_pages: (num_pages, nh, page, hd) contiguous, dtype kv_dtype
// (0 fp32, 1 bf16, 2 int8); k_scale, v_scale: (num_pages, nh) fp32 for
// int8, else null. block_tables: (b, max_pages) int32; pos: (b,) int32.
// anc: (b, wk, wk) bytes, anc[b][i][j] != 0 when window row i is
// visible to query j, or null for the linear mask (i <= j). Query j
// attends logical rows s < max_pages * page with s < pos, or s - pos in
// [0, wk) admitted by the mask. 1 <= k1 <= 64, q0 >= 0, q0 + k1 <= wk,
// hd <= 256, the shared memory of (k1, hd) within the card's 227 KB;
// b <= 65535. Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
int apx_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* pos, const void* anc, void* out, int b,
                        int nh, int wk, int q0, int k1, int page, int hd,
                        int max_pages, int q_dtype, int kv_dtype,
                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || nh < 1 || nh > 65535 || k1 < 1
      || k1 > kMaxK1 || q0 < 0 || wk < k1 || q0 > wk - k1 || page < 1
      || hd < 1 || hd > kMaxHd || max_pages < 1
      || smem_bytes(k1, hd) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps = static_cast<const int*>(pos);
  const uint8_t* an = static_cast<const uint8_t*>(anc);
  cudaError_t err;
  if (q_dtype == kF32)
    err = launch_q<float>(q, k_pages, v_pages, ks, vs, bt, ps, an, out, b,
                          nh, wk, q0, k1, page, hd, max_pages, kv_dtype,
                          scale, st);
  else if (q_dtype == kBF16)
    err = launch_q<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, bt, ps, an,
                                  out, b, nh, wk, q0, k1, page, hd,
                                  max_pages, kv_dtype, scale, st);
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
