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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

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
                       TQ* __restrict__ out, int nh, int k1, int page,
                       int hd, int max_pages, float scale) {
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
  const int nmax = min(p0 + k1, s_len);    // rows any query may see
  const long long qoff = (static_cast<long long>(b) * nh + h) * k1 * hd;
  const uint8_t* a = anc == nullptr
      ? nullptr : anc + static_cast<long long>(b) * k1 * k1;

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
          && (w < 0 || (w < k1 && (a != nullptr ? a[w * k1 + j] != 0
                                                : w <= j)));
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
                      int b, int nh, int k1, int page, int hd,
                      int max_pages, float scale, cudaStream_t st) {
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
                                           anc, oo, nh, k1, page, hd,
                                           max_pages, scale);
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
                   int nh, int k1, int page, int hd, int max_pages,
                   float scale, cudaStream_t st) {
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
                                 nh, k1, page, hd, max_pages, scale, st);
  APX_VE(16) APX_VE(8) APX_VE(4) APX_VE(2) APX_VE(1)
#undef APX_VE
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_q(const void* q, const void* kp, const void* vp,
                     const float* ks, const float* vs, const int* bt,
                     const int* pos, const uint8_t* anc, void* out, int b,
                     int nh, int k1, int page, int hd, int max_pages,
                     int kv_dtype, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case kF32:
      return launch<TQ, float>(q, kp, vp, nullptr, nullptr, bt, pos, anc,
                               out, b, nh, k1, page, hd, max_pages, scale,
                               st);
    case kBF16:
      return launch<TQ, __nv_bfloat16>(q, kp, vp, nullptr, nullptr, bt,
                                       pos, anc, out, b, nh, k1, page, hd,
                                       max_pages, scale, st);
    case kI8:
      if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
      return launch<TQ, int8_t>(q, kp, vp, ks, vs, bt, pos, anc, out, b,
                                nh, k1, page, hd, max_pages, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The most queries a slot the kernel holds.
int apx_paged_attention_max_k1() { return kMaxK1; }

// q, out: (b, nh, k1, hd) contiguous, dtype q_dtype (0 fp32, 1 bf16).
// k_pages, v_pages: (num_pages, nh, page, hd) contiguous, dtype kv_dtype
// (0 fp32, 1 bf16, 2 int8); k_scale, v_scale: (num_pages, nh) fp32 for
// int8, else null. block_tables: (b, max_pages) int32; pos: (b,) int32.
// anc: (b, k1, k1) bytes, anc[b][i][j] != 0 when window row i is
// visible to query j, or null for the linear mask (i <= j). Query j
// attends logical rows s < max_pages * page with s < pos, or s - pos in
// [0, k1) admitted by the mask. 1 <= k1 <= 64, hd <= 256, the shared
// memory of (k1, hd) within the card's 227 KB; b <= 65535. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these limits.
int apx_paged_attention(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* pos, const void* anc, void* out, int b,
                        int nh, int k1, int page, int hd, int max_pages,
                        int q_dtype, int kv_dtype, float scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || nh < 1 || nh > 65535 || k1 < 1
      || k1 > kMaxK1 || page < 1 || hd < 1 || hd > kMaxHd
      || max_pages < 1 || smem_bytes(k1, hd) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps = static_cast<const int*>(pos);
  const uint8_t* an = static_cast<const uint8_t*>(anc);
  cudaError_t err;
  if (q_dtype == kF32)
    err = launch_q<float>(q, k_pages, v_pages, ks, vs, bt, ps, an, out, b,
                          nh, k1, page, hd, max_pages, kv_dtype, scale,
                          st);
  else if (q_dtype == kBF16)
    err = launch_q<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, bt, ps, an,
                                  out, b, nh, k1, page, hd, max_pages,
                                  kv_dtype, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
