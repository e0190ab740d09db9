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
// Design: one warp per row, four rows per 128-thread block, so rows
// of any count and any h (not only multiples of 128) need no padding
// and no inter-block reduction: the TPU kernel's (TILE_R, H) VMEM tile
// becomes a warp walking its row with stride 32 (neighbouring lanes on
// neighbouring addresses, so loads coalesce), and the VPU row
// reduction becomes a shuffle reduction. The row is read three times
// (sum, centred sum of squares, output); the second and third reads
// hit L1, so device memory sees each input byte once. Weight and bias
// may each be fp32 or bf16, independently of x (fp32 or bf16).
// Not yet done: vectorised 16-byte loads and keeping the row in
// registers between passes.
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
constexpr int kRowsPerBlock = 4;

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

template <typename TX, typename TW, typename TB>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layer_norm_fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                      const TB* __restrict__ b, TX* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int rows, int h,
                      int rms, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * h;
  const float fh = (float)h;
  float mean = 0.f, acc = 0.f;
  if (!rms) {
    for (int i = lane; i < h; i += 32) acc += ld(xr, i);
    mean = warp_sum(acc) / fh;
    acc = 0.f;
  }
  for (int i = lane; i < h; i += 32) {
    const float d = ld(xr, i) - mean;
    acc += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(acc) / fh + eps);
  TX* yr = y + row * h;
  for (int i = lane; i < h; i += 32) {
    float t = (ld(xr, i) - mean) * rstd;
    if (w != nullptr) t *= ld(w, i);
    if (b != nullptr) t += ld(b, i);
    st(yr, i, t);
  }
  if (lane == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename TX, typename TW, typename TB>
void launch(const void* x, const void* w, const void* b, void* y,
            float* mean, float* rstd, int rows, int h, int rms, float eps,
            cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_fwd_kernel<TX, TW, TB>
      <<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(w),
          static_cast<const TB*>(b), static_cast<TX*>(y), mean, rstd, rows,
          h, rms, eps);
}

template <typename TX, typename TW>
void dispatch_b(int b_dtype, const void* x, const void* w, const void* b,
                void* y, float* mean, float* rstd, int rows, int h, int rms,
                float eps, cudaStream_t s) {
  if (b_dtype == kBF16)
    launch<TX, TW, __nv_bfloat16>(x, w, b, y, mean, rstd, rows, h, rms, eps,
                                  s);
  else
    launch<TX, TW, float>(x, w, b, y, mean, rstd, rows, h, rms, eps, s);
}

template <typename TX>
void dispatch_w(int w_dtype, int b_dtype, const void* x, const void* w,
                const void* b, void* y, float* mean, float* rstd, int rows,
                int h, int rms, float eps, cudaStream_t s) {
  if (w_dtype == kBF16)
    dispatch_b<TX, __nv_bfloat16>(b_dtype, x, w, b, y, mean, rstd, rows, h,
                                  rms, eps, s);
  else
    dispatch_b<TX, float>(b_dtype, x, w, b, y, mean, rstd, rows, h, rms,
                          eps, s);
}

// -- backward ---------------------------------------------------------------

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
// (rows,) fp32. Launches on `stream` and returns cudaGetLastError().
int apx_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int rows, int h, int x_dtype,
                       int w_dtype, int b_dtype, int rms, float eps,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (x_dtype == kBF16)
    dispatch_w<__nv_bfloat16>(w_dtype, b_dtype, x, w, b, y, m, r, rows, h,
                              rms, eps, s);
  else
    dispatch_w<float>(w_dtype, b_dtype, x, w, b, y, m, r, rows, h, rms, eps,
                      s);
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
