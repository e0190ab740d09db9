// LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Forward. Replaces the TPU kernel apex_tpu/normalization/
// fused_layer_norm.py :: _fwd_kernel (launched by _fwd_call). Same contract: per row of
// x (rows, h), statistics in fp32 — LN: mean, var = mean((x-mean)^2),
// rstd = 1/sqrt(var + eps); RMS: rstd = 1/sqrt(mean(x^2) + eps) — then
// y = xhat * w + b in fp32, stored in x's dtype, plus the fp32 mean
// (LN only) and rstd that the backward will need.
//
// What bounds it on an H100: bytes. It does ~8 flops per element and
// moves 2 * sizeof(x) bytes per element, far below the ~295 flop/byte
// the card needs before compute matters; the least time is the bytes
// over 3.35 TB/s.
//
// Design: built for the bytes, on the backward's pieces below. A team of
// 32-1024 threads owns a row: the smallest power of two whose 8 elements
// a thread (up to 2^21 elements in all) or 32 (beyond) cover h, so h up to
// 32768. (1024, 1024) bf16 is 128 threads a row, one 16-byte chunk each;
// (8192, 1024) a warp a row, four chunks each. A 128-thread block holds
// 128 / team rows (one row a block for larger teams).
// Thread l of a team owns the row's 16-byte chunks l, l + team, ..., so
// x arrives by 16-byte loads (a warp's loads 512 contiguous bytes) and y
// leaves by 16-byte stores; w and b are loaded at the start too, and
// converted to fp32.
// The row stays in registers, as loaded, between the statistics passes
// and the output pass: device memory sees x once. The sums are warp
// shuffles, then for a team of several warps the warps' sums added in
// warp order through shared memory. Element loads and stores where h is
// not a multiple of the vector or x, y, w or b does not start 16-byte
// aligned. One kernel serves x fp32 or bf16, w and b each fp32 or bf16
// or absent, LN or RMS.
//
// Backward. Replaces _bwd_kernel (via _bwd_call) and, at h >= 2731
// where the JAX package splits columns, _bwd_colsum_kernel and
// _bwd_dx_kernel (via _bwd_call_colsplit): one design computes the
// same function at every h. Per row, in fp32: xhat = (x - mean) * rstd
// (RMS: x * rstd), wdy = w * dy, c1 = mean(xhat * wdy), c2 = mean(wdy),
// dx = (wdy - xhat * c1 - c2) * rstd (RMS drops c2), stored in x's
// dtype; dgamma = sum_rows dy * xhat and dbeta = sum_rows dy, stored in
// w's and b's dtypes. Bound by bytes, like the forward: dy and x read
// once, dx written once.
//
// Design: a two-stage reduction built for the bytes. Stage 1: one
// 512-thread block an SM (the wrapper sizes the grid from the card's SM
// count, so each block owns a contiguous run of rows and the partials are
// one fp32 row of dgamma and one of dbeta per SM: 1.1 MB at h = 1024, 4.3
// MB at h = 4096). Inside a block, a team of 32-512 threads (the smallest
// power of two whose 16 columns a thread cover h) owns a row; thread l of
// a team owns the row's 16-byte chunks l, l + team, ..., so dy and x
// arrive by 16-byte loads, a warp's loads 512 contiguous bytes, and dx
// leaves by 16-byte stores (element loads and stores where h is not a
// multiple of the vector or a row is not 16-byte aligned). The row stays
// in registers, as loaded, between the statistics pass and the dx pass,
// and the team's next row (dy, x, mean and rstd) is loaded across the
// current row's sums; two or three rows ahead ran slower on the H100 (a
// register copy of a row waits for its load, and a ring of slots unrolled
// over the loop spills). c1 and c2 are warp shuffles, then for a team of
// several warps the warps' sums added in a fixed order after the team's
// own named barrier (no block-wide barrier a row); dgamma and dbeta run in
// each thread's registers over the rows it sees, and at the end the
// block's teams add theirs in team order through shared memory. Stage 2, a
// second launch, sums the partial rows per column in a fixed order: a
// block owns 32 columns, 16 warps read 128-byte lines of 16 partial rows
// at a time, and one warp adds the 16 warp sums. No float atomics
// anywhere, so dgamma and dbeta are the same in every run on a card (their
// bits follow the grid, which follows the SM count). One kernel serves
// every h up to 8192, x fp32 or bf16, w and b each fp32 or bf16 (w is
// staged to shared memory in fp32), LN or RMS, with or without w and b.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float ld(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kBwdThreads = 512;  // stage 1: one block an SM
constexpr int kBwdElems = 16;     // stage 1: elements of a row a thread
constexpr int kBwdMaxH = kBwdThreads * kBwdElems;  // 8192
constexpr int kSumWarps = 16;     // stage 2: partial rows summed at once

// The team of threads that owns a row: the smallest power of two, at
// least a warp, whose kBwdElems columns a thread cover h.
inline int bwd_team(int h) {
  int t = 32;
  while (t * kBwdElems < h) t *= 2;
  return t;
}

// -- rows in 16-byte chunks (forward and backward) --------------------------

// 16 bytes of a row, kept as loaded (so a load in flight holds only its
// four registers) and read as fp32: one vector load where VEC (row
// starts 16-byte aligned, h a multiple of the vector), else element
// loads; 0 past h.
template <typename T, bool VEC>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
  uint4 u;
  __device__ __forceinline__ void load(const T* row, int c, int h) {
    if constexpr (VEC) {
      u = c < h ? *reinterpret_cast<const uint4*>(row + c)
                : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t w[4];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = c + i < h ? __float_as_uint(row[c + i]) : 0u;
      } else {
        const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = c + 2 * i < h ? r16[c + 2 * i] : 0u;
          const uint32_t hi = c + 2 * i + 1 < h ? r16[c + 2 * i + 1] : 0u;
          w[i] = lo | hi << 16;
        }
      }
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ __forceinline__ float operator[](int i) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
    const uint32_t b = w[i >> 1];
    return __uint_as_float(i & 1 ? b & 0xffff0000u : b << 16);
  }
};

template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* row, int c, int h,
                                            const float (&v)[16 / sizeof(T)]) {
  constexpr int N = 16 / sizeof(T);
  if constexpr (VEC) {
    if (c >= h) return;
    uint4 u;
    if constexpr (sizeof(T) == 4) {
      u = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                     __float_as_uint(v[2]), __float_as_uint(v[3]));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&b);
      }
      u = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(row + c) = u;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (c + i < h) st(row, c + i, v[i]);
  }
}

// -- forward ----------------------------------------------------------------

constexpr int kFwdThreads = 128;  // a block, or a team where that is larger
constexpr int kFwdMaxH = 1024 * 32;  // a 1024-thread team, 32 columns each
// Up to this many elements the rows take 8 columns a thread, beyond it
// 32: on the H100 8 took 10-21 % less time from (8, 1024) to (2048, 1024)
// bf16, 32 took 11-17 % less at (1024, 4096) bf16, (4096, 1024) and
// (8192, 1024) fp32 w.
constexpr long long kFwdFewElems = 1LL << 21;

// The columns of a row a thread holds: 8 for a problem of few elements
// (more threads, one 16-byte chunk each for bf16), else 32.
inline int fwd_elems(int rows, int h) {
  return static_cast<long long>(rows) * h <= kFwdFewElems && h <= 1024 * 8
             ? 8
             : 32;
}

// The team of threads that owns a row: the smallest power of two, at
// least a warp, whose `elems` columns a thread cover h.
inline int fwd_team(int h, int elems) {
  int t = 32;
  while (t * elems < h) t *= 2;
  return t;
}

// N elements of w or b (fp32 or bf16, `bf16`) at columns c .. c + N - 1
// as fp32, 0 past h: vector loads where VEC (the chunk wholly in or
// out of the row), else element loads.
template <int N, bool VEC>
__device__ __forceinline__ void load_param(const void* p, int bf16, int c,
                                           int h, float (&v)[N]) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p);
    if constexpr (VEC) {
      uint32_t w[N / 2];
      if constexpr (N == 8) {
        const uint4 u = c < h ? *reinterpret_cast<const uint4*>(q + c)
                              : make_uint4(0u, 0u, 0u, 0u);
        w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
      } else {
        const uint2 u = c < h ? *reinterpret_cast<const uint2*>(q + c)
                              : make_uint2(0u, 0u);
        w[0] = u.x, w[1] = u.y;
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u
                                     : w[i >> 1] << 16);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = c + i < h ? ld(q, c + i) : 0.f;
    }
  } else {
    const float* q = static_cast<const float*>(p);
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 f = c < h ? *reinterpret_cast<const float4*>(q + c + 4 * j)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z,
              v[4 * j + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = c + i < h ? q[c + i] : 0.f;
    }
  }
}

// TEAM threads own a row; thread l of a team holds the row's 16-byte
// chunks l, l + TEAM, ... (ELEMS columns) in registers from the load
// to the store. A team of several warps adds its warps' sums in warp
// order through shared memory (every thread of the block reaches the
// barriers; a team past the last row stores nothing).
template <typename TX, int TEAM, int ELEMS, bool VEC>
__global__ void __launch_bounds__(TEAM > kFwdThreads ? TEAM : kFwdThreads)
layer_norm_fwd_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                      int w_bf16, const void* __restrict__ b, int b_bf16,
                      TX* __restrict__ y, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int rows, int h, int rms,
                      float eps) {
  using C = Chunk<TX, VEC>;
  constexpr int N = C::N;
  constexpr int VPT = ELEMS / N;  // chunks a thread
  constexpr int BLOCK = TEAM > kFwdThreads ? TEAM : kFwdThreads;
  constexpr int WARPS = TEAM / 32;    // warps a team
  __shared__ float red[2][BLOCK / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / TEAM, tl = tid % TEAM;
  const int64_t row = (int64_t)blockIdx.x * (BLOCK / TEAM) + team;
  const bool live = row < rows;
  const TX* xr = x + (live ? row : 0) * h;
  C cx[VPT];
  float wv[VPT][N], bv[VPT][N];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = (tl + v * TEAM) * N;
    cx[v].load(xr, c, h);
#pragma unroll
    for (int i = 0; i < N; ++i) wv[v][i] = 1.f, bv[v][i] = 0.f;
    if (w != nullptr) load_param<N, VEC>(w, w_bf16, c, h, wv[v]);
    if (b != nullptr) load_param<N, VEC>(b, b_bf16, c, h, bv[v]);
  }
  auto team_sum = [&](float s, int pass) {
    s = warp_sum(s);
    if constexpr (WARPS > 1) {
      if (lane == 0) red[pass][warp] = s;
      __syncthreads();
      s = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += red[pass][team * WARPS + i];
    }
    return s;
  };
  const float fh = (float)h;
  float mean = 0.f;
  if (!rms) {  // columns past h hold 0 and add nothing
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i) acc += cx[v][i];
    mean = team_sum(acc, 0) / fh;
  }
  float acc = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if ((tl + v * TEAM) * N + i < h) {
        const float d = cx[v][i] - mean;
        acc += d * d;
      }
  const float rstd = 1.0f / sqrtf(team_sum(acc, 1) / fh + eps);
  if (!live) return;
  TX* yr = y + row * h;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = (cx[v][i] - mean) * rstd;
      if (w != nullptr) t *= wv[v][i];
      if (b != nullptr) t += bv[v][i];
      o[i] = t;
    }
    store_chunk<TX, VEC>(yr, (tl + v * TEAM) * N, h, o);
  }
  if (tl == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename TX, int TEAM, int ELEMS, bool VEC>
void launch_fwd(const void* x, const void* w, int w_bf16, const void* b,
                int b_bf16, void* y, float* mean, float* rstd, int rows,
                int h, int rms, float eps, cudaStream_t s) {
  constexpr int BLOCK = TEAM > kFwdThreads ? TEAM : kFwdThreads;
  constexpr int ROWS = BLOCK / TEAM;
  layer_norm_fwd_kernel<TX, TEAM, ELEMS, VEC>
      <<<(rows + ROWS - 1) / ROWS, BLOCK, 0, s>>>(
          static_cast<const TX*>(x), w, w_bf16, b, b_bf16, static_cast<TX*>(y),
          mean, rstd, rows, h, rms, eps);
}

template <typename TX, int ELEMS, bool VEC>
int fwd_dispatch_team(const void* x, const void* w, int w_bf16,
                      const void* b, int b_bf16, void* y, float* mean,
                      float* rstd, int rows, int h, int rms, float eps,
                      cudaStream_t s) {
#define APX_LN_FWD(T)                                                     \
  case T:                                                                 \
    launch_fwd<TX, T, ELEMS, VEC>(x, w, w_bf16, b, b_bf16, y, mean, rstd, \
                                  rows, h, rms, eps, s);                  \
    return 0;
  switch (fwd_team(h, ELEMS)) {
    APX_LN_FWD(32)
    APX_LN_FWD(64)
    APX_LN_FWD(128)
    APX_LN_FWD(256)
    APX_LN_FWD(512)
    APX_LN_FWD(1024)
  }
#undef APX_LN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX, bool VEC>
int fwd_dispatch_elems(const void* x, const void* w, int w_bf16,
                       const void* b, int b_bf16, void* y, float* mean,
                       float* rstd, int rows, int h, int rms, float eps,
                       cudaStream_t s) {
  return fwd_elems(rows, h) == 8
             ? fwd_dispatch_team<TX, 8, VEC>(x, w, w_bf16, b, b_bf16, y, mean,
                                             rstd, rows, h, rms, eps, s)
             : fwd_dispatch_team<TX, 32, VEC>(x, w, w_bf16, b, b_bf16, y,
                                              mean, rstd, rows, h, rms, eps,
                                              s);
}

template <typename TX>
int fwd_dispatch_vec(const void* x, const void* w, int w_bf16, const void* b,
                     int b_bf16, void* y, float* mean, float* rstd, int rows,
                     int h, int rms, float eps, cudaStream_t s) {
  constexpr int N = 16 / sizeof(TX);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = h % N == 0 && aligned(x) && aligned(y) && aligned(w) &&
                   aligned(b);
  return vec ? fwd_dispatch_elems<TX, true>(x, w, w_bf16, b, b_bf16, y, mean,
                                            rstd, rows, h, rms, eps, s)
             : fwd_dispatch_elems<TX, false>(x, w, w_bf16, b, b_bf16, y,
                                             mean, rstd, rows, h, rms, eps, s);
}

// -- backward ---------------------------------------------------------------

// Stage 1. TEAM threads own a row: thread l of a team owns the 16-byte
// chunks l, l + TEAM, ... (kBwdElems columns), so a warp's loads are 512
// contiguous bytes. The block's kBwdThreads / TEAM teams take the rows
// of its run in turn; each thread keeps its columns' running dgamma and
// dbeta in registers and holds its row's chunks between the statistics
// pass and the dx pass, while the next row's chunks load. A row's c1
// and c2 are warp shuffles, then, for a team of several warps, the
// warps' sums added in a fixed order after the team's own named
// barrier (double-buffered: one barrier a row). At the end the teams'
// column partials are added in team order through shared memory and
// the block writes one row of the (n_blocks, h) fp32 partials.
template <typename TX, int TEAM, bool VEC>
__global__ void __launch_bounds__(kBwdThreads, 1)
layer_norm_bwd_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                      const void* __restrict__ w, int w_bf16,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, TX* __restrict__ dx,
                      float* __restrict__ part_w, float* __restrict__ part_b,
                      int rows, int h, int rms, int rows_per_block) {
  using C = Chunk<TX, VEC>;
  constexpr int N = C::N;
  constexpr int VPT = kBwdElems / N;  // chunks a thread
  constexpr int TEAMS = kBwdThreads / TEAM;
  constexpr int WARPS = TEAM / 32;    // warps a team
  constexpr int SPAN = TEAM * kBwdElems;  // columns a team covers
  // w in fp32 (0 past h) during the row loop, then the teams' partials
  __shared__ float4 sbuf4[kBwdMaxH / 4];
  __shared__ float red[2][kBwdThreads / 32][2];
  float* sbuf = reinterpret_cast<float*>(sbuf4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team = tid / TEAM, tl = tid % TEAM;
  for (int c = tid; c < SPAN; c += kBwdThreads) {
    float wv = 0.f;
    if (c < h)
      wv = w == nullptr ? 1.f
           : w_bf16     ? ld(static_cast<const __nv_bfloat16*>(w), c)
                        : ld(static_cast<const float*>(w), c);
    sbuf[c] = wv;
  }
  __syncthreads();

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  const float fh = (float)h;
  float gw[kBwdElems], gb[kBwdElems];
#pragma unroll
  for (int j = 0; j < kBwdElems; ++j) gw[j] = gb[j] = 0.f;
  C cd[VPT], cx[VPT];  // this row's dy and x, mean and rstd
  float mu, rs;
  int row = r0 + team;
  auto load = [&](C (&d)[VPT], C (&xx)[VPT], float& m, float& s, int r) {
    m = mean != nullptr ? mean[r] : 0.f;
    s = rstd[r];
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int c = (tl + v * TEAM) * N;
      d[v].load(dy + (int64_t)r * h, c, h);
      xx[v].load(x + (int64_t)r * h, c, h);
    }
  };
  if (row < r1) load(cd, cx, mu, rs, row);
  for (int it = 0; row < r1; row += TEAMS, ++it) {
    // the next row's, in flight across this one
    C nd[VPT], nx[VPT];
    float nmu, nrs;
    if (row + TEAMS < r1) load(nd, nx, nmu, nrs, row + TEAMS);
    float s1 = 0.f, s2 = 0.f;
    // columns past h hold dy = x = w = 0: they add nothing (xhat may be
    // nonzero there, but dy and w dy are 0)
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = v * N + i;
        const float d = cd[v][i];
        const float xh = (cx[v][i] - mu) * rs;
        const float wd = d * sbuf[(tl + v * TEAM) * N + i];
        s1 += xh * wd;
        s2 += wd;
        gw[j] += d * xh;
        gb[j] += d;
      }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if constexpr (WARPS > 1) {
      const int buf = it & 1;
      if (lane == 0) {
        red[buf][warp][0] = s1;
        red[buf][warp][1] = s2;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(TEAM)
                   : "memory");
      s1 = s2 = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        s1 += red[buf][team * WARPS + i][0];
        s2 += red[buf][team * WARPS + i][1];
      }
    }
    const float c1 = s1 / fh, c2 = s2 / fh;
    TX* dxr = dx + (int64_t)row * h;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = (cx[v][i] - mu) * rs;
        const float wd = cd[v][i] * sbuf[(tl + v * TEAM) * N + i];
        float g = wd - xh * c1;
        if (!rms) g -= c2;
        o[i] = g * rs;
      }
      store_chunk<TX, VEC>(dxr, (tl + v * TEAM) * N, h, o);
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      cd[v] = nd[v];
      cx[v] = nx[v];
    }
    mu = nmu;
    rs = nrs;
  }

  // the teams' column partials, added in team order
  float* const parts[2] = {part_w, part_b};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (parts[k] == nullptr) continue;
    __syncthreads();  // sbuf is free (w read, or the last sum written)
#pragma unroll
    for (int v = 0; v < VPT; ++v)
#pragma unroll
      for (int i = 0; i < N; ++i)
        sbuf[team * SPAN + (tl + v * TEAM) * N + i] =
            k == 0 ? gw[v * N + i] : gb[v * N + i];
    __syncthreads();
    for (int c = tid; c < h; c += kBwdThreads) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < TEAMS; ++t) acc += sbuf[t * SPAN + c];
      parts[k][(int64_t)blockIdx.x * h + c] = acc;
    }
  }
}

// Stage 2: dgamma and dbeta, the partial rows summed per column in a
// fixed order. A block owns 32 columns: warp i sums rows i, i + 16, ...
// of them (each load one 128-byte line of a partial row), then warp 0
// adds the 16 warp sums in order.
template <typename TW, typename TB>
__global__ void __launch_bounds__(32 * kSumWarps)
layer_norm_bwd_colsum_kernel(const float* __restrict__ part_w,
                             const float* __restrict__ part_b,
                             TW* __restrict__ dw, TB* __restrict__ db,
                             int n_parts, int h) {
  __shared__ float s[2][kSumWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float aw = 0.f, ab = 0.f;
  if (c < h) {
#pragma unroll 4
    for (int r = warp; r < n_parts; r += kSumWarps) {
      if (part_w != nullptr) aw += part_w[(int64_t)r * h + c];
      if (part_b != nullptr) ab += part_b[(int64_t)r * h + c];
    }
  }
  s[0][warp][lane] = aw;
  s[1][warp][lane] = ab;
  __syncthreads();
  if (warp == 0 && c < h) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kSumWarps; ++i) {
      tw += s[0][i][lane];
      tb += s[1][i][lane];
    }
    if (dw != nullptr) st(dw, c, tw);
    if (db != nullptr) st(db, c, tb);
  }
}

template <typename TX, int TEAM, bool VEC>
void launch_bwd(const void* dy, const void* x, const void* w, int w_bf16,
                const float* mean, const float* rstd, void* dx,
                float* part_w, float* part_b, int rows, int h, int rms,
                int rpb, cudaStream_t s) {
  const int blocks = (rows + rpb - 1) / rpb;
  layer_norm_bwd_kernel<TX, TEAM, VEC><<<blocks, kBwdThreads, 0, s>>>(
      static_cast<const TX*>(dy), static_cast<const TX*>(x), w, w_bf16, mean,
      rstd, static_cast<TX*>(dx), part_w, part_b, rows, h, rms, rpb);
}

template <typename TX, bool VEC>
int dispatch_team(const void* dy, const void* x, const void* w, int w_bf16,
                  const float* mean, const float* rstd, void* dx,
                  float* part_w, float* part_b, int rows, int h, int rms,
                  int rpb, cudaStream_t s) {
#define APX_LN_BWD(T)                                                    \
  case T:                                                                \
    launch_bwd<TX, T, VEC>(dy, x, w, w_bf16, mean, rstd, dx, part_w,     \
                           part_b, rows, h, rms, rpb, s);                \
    return 0;
  switch (bwd_team(h)) {
    APX_LN_BWD(32)
    APX_LN_BWD(64)
    APX_LN_BWD(128)
    APX_LN_BWD(256)
    APX_LN_BWD(512)
  }
#undef APX_LN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int dispatch_vec(const void* dy, const void* x, const void* w, int w_bf16,
                 const float* mean, const float* rstd, void* dx,
                 float* part_w, float* part_b, int rows, int h, int rms,
                 int rpb, cudaStream_t s) {
  constexpr int N = 16 / sizeof(TX);
  const bool vec = h % N == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  return vec ? dispatch_team<TX, true>(dy, x, w, w_bf16, mean, rstd, dx,
                                       part_w, part_b, rows, h, rms, rpb, s)
             : dispatch_team<TX, false>(dy, x, w, w_bf16, mean, rstd, dx,
                                        part_w, part_b, rows, h, rms, rpb,
                                        s);
}

template <typename TW, typename TB>
void launch_colsum(const float* part_w, const float* part_b, void* dw,
                   void* db, int n_parts, int h, cudaStream_t s) {
  layer_norm_bwd_colsum_kernel<TW, TB>
      <<<(h + 31) / 32, 32 * kSumWarps, 0, s>>>(
          part_w, part_b, static_cast<TW*>(dw), static_cast<TB*>(db),
          n_parts, h);
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (rows, h) row-major, dtype x_dtype (0 fp32, 1 bf16). w, b: (h,)
// or null, dtypes w_dtype / b_dtype. mean (null in RMS mode), rstd:
// (rows,) fp32. h <= 32768. Launches on `stream` and returns
// cudaGetLastError().
int apx_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int rows, int h, int x_dtype,
                       int w_dtype, int b_dtype, int rms, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (h > kFwdMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const int wb = w_dtype == kBF16, bb = b_dtype == kBF16;
  const int e =
      x_dtype == kBF16
          ? fwd_dispatch_vec<__nv_bfloat16>(x, w, wb, b, bb, y, m, r, rows, h,
                                            rms, eps, s)
          : fwd_dispatch_vec<float>(x, w, wb, b, bb, y, m, r, rows, h, rms,
                                    eps, s);
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

// dy, x, dx: (rows, h) row-major, dtype x_dtype. w: (h,) or null, dtype
// w_dtype. mean (null in RMS mode), rstd: (rows,) fp32 from the forward.
// part_w / part_b: (ceil(rows / rows_per_block), h) fp32 scratch, null
// when there is no weight / bias; dw / db: (h,) in w_dtype / b_dtype, or
// null. Stage 1 writes dx and the partials; stage 2, launched only when
// there is a weight or a bias, sums the partials into dw and db. h <=
// 8192. Returns the first launch error (0 on success).
int apx_layer_norm_bwd(const void* dy, const void* x, const void* w,
                       const void* mean, const void* rstd, void* dx,
                       void* part_w, void* part_b, void* dw, void* db,
                       int rows, int h, int x_dtype, int w_dtype,
                       int b_dtype, int rms, int rows_per_block,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  if (h > kBwdMaxH) return static_cast<int>(cudaErrorInvalidValue);
  const int wb = w_dtype == kBF16;
  int e = x_dtype == kBF16
              ? dispatch_vec<__nv_bfloat16>(dy, x, w, wb, m, r, dx, pw, pb,
                                            rows, h, rms, rows_per_block, s)
              : dispatch_vec<float>(dy, x, w, wb, m, r, dx, pw, pb, rows, h,
                                    rms, rows_per_block, s);
  if (e != 0) return e;
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || (pw == nullptr && pb == nullptr)) return e;
  const int n_parts = (rows + rows_per_block - 1) / rows_per_block;
  if (w_dtype == kBF16) {
    if (b_dtype == kBF16)
      launch_colsum<__nv_bfloat16, __nv_bfloat16>(pw, pb, dw, db, n_parts, h,
                                                  s);
    else
      launch_colsum<__nv_bfloat16, float>(pw, pb, dw, db, n_parts, h, s);
  } else {
    if (b_dtype == kBF16)
      launch_colsum<float, __nv_bfloat16>(pw, pb, dw, db, n_parts, h, s);
    else
      launch_colsum<float, float>(pw, pb, dw, db, n_parts, h, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
