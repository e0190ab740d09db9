// Weight-only int8 matmuls with the dequantization fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/quant/kernels.py:
//   _w8_matmul_kernel         y = x (M, K) @ (float(wq (K, N)) * scale (N,)) + bias
//   _w8_matmul_nobias_kernel  the same without the bias
//   _w8_matmul_nk_kernel      y = x (M, K) @ (float(wq (N, K)) * scale (N,)^T)^T
// Same contract: each int8 weight is dequantized to fp32 times its
// channel's fp32 scale (one rounding), multiplied by x in fp32 (x fp32
// or bf16) and accumulated in fp32, the bias (fp32 or bf16) added in
// fp32, and the sum rounded once to the output dtype (fp32 or bf16).
// Device memory sees only the int8 weights, the scales, x and y.
//
// What bounds it on an H100. Decode (M = the slot count, 8): bytes, the
// int8 weight read (3.1 MB for GPT-2 medium's qkv, 51.5 MB for the tied
// word table), a few operations per byte. Prefill (M = 128..1024):
// operations, 2 M K N of them, here on the CUDA cores in fp32.
//
// Design. Two regimes, chosen by M alone, and the Pallas block structure
// (whole M, whole K, N tiles) is not carried over:
// - M <= 8, KN layout (w8_gemv_kn): a thread owns 8 neighbouring columns
//   (one 8-byte load a weight row) and a run of 16 rows of K; the 8 warps
//   of a block take 8 runs of the same 256 columns, so a block covers
//   128 rows of K, and the grid splits K in such chunks. Every thread
//   issues its 16 loads before any arithmetic, so the whole matrix is in
//   flight at once. x is staged in shared memory as fp32 and read as a
//   broadcast. The runs are summed in a fixed order in shared memory, the
//   chunks by w8_reduce in a fixed order: no atomics, so two launches give
//   the same bits.
// - M <= 8, NK layout (w8_gemv_nk): a thread owns one output channel and
//   reads its K-contiguous row in 16-byte loads, eight in flight; x is
//   staged in shared memory 512 columns at a time and read as a
//   broadcast, so no lane ever reduces with another.
// - M > 8, both layouts (w8_tiled): a 64 x 128 output tile per block of
//   256 threads, 4 x 8 outputs a thread in registers, K in steps of 16
//   with x and the dequantized weights in shared memory as fp32 and the
//   next step's global loads held in registers meanwhile. Where the grid
//   would hold fewer than two tiles a multiprocessor, K is split and the
//   parts summed by w8_reduce in a fixed order.
// Each thread sums its products in ascending k. Loads are vectorised
// where the row length and the base address allow it, byte by byte else,
// so any M, K and N is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSmallM = 8;  // rows of the gemv regime
// w8_gemv_kn
constexpr int kKnCols = 8;
constexpr int kKnSlices = 8;
constexpr int kKnRows = 16;
constexpr int kKnBlockN = 32 * kKnCols;           // 256 columns a block
constexpr int kKnChunk = kKnSlices * kKnRows;     // 128 rows of K a block
// w8_gemv_nk
constexpr int kNkThreads = 128;
constexpr int kNkChunk = 512;
constexpr int kNkVec = 8;
// w8_tiled
constexpr int BM = 64, BN = 128, BK = 16, kTileThreads = 256;
constexpr int kSms = 132;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float ld_x(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// bias_code: 0 none, 1 fp32, 2 bf16
__device__ __forceinline__ float add_bias(float acc, const void* b,
                                          int64_t n, int bias_code) {
  if (bias_code == 0) return acc;
  const float bv =
      bias_code == 2
          ? __bfloat162float(static_cast<const __nv_bfloat16*>(b)[n])
          : static_cast<const float*>(b)[n];
  return __fadd_rn(acc, bv);
}

__device__ __forceinline__ void store_out(void* o, int64_t i, float v,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(o)[i] = v;
}

// byte c of an 8-byte word pair, as a signed value
__device__ __forceinline__ float byte_of(uint32_t lo, uint32_t hi, int c) {
  const uint32_t w = c < 4 ? lo : hi;
  return static_cast<float>(
      static_cast<int8_t>((w >> (8 * (c & 3))) & 0xffu));
}

// Eight bytes at row[0..8), the ones at or past `valid` read as 0.
__device__ __forceinline__ uint2 load8(const int8_t* row, int valid,
                                       bool vec) {
  if (vec && valid >= 8) return *reinterpret_cast<const uint2*>(row);
  uint32_t lo = 0u, hi = 0u;
  for (int c = 0; c < 8 && c < valid; ++c) {
    const uint32_t b = static_cast<uint8_t>(row[c]);
    if (c < 4)
      lo |= b << (8 * c);
    else
      hi |= b << (8 * (c - 4));
  }
  return make_uint2(lo, hi);
}

__global__ void __launch_bounds__(kKnSlices * 32)
w8_gemv_kn(const void* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, const void* __restrict__ bias,
           void* __restrict__ out, float* __restrict__ partial, int M, int K,
           int N, int vec, int x_bf16, int out_bf16, int bias_code) {
  __shared__ __align__(16) float xs[kKnChunk][kSmallM];
  __shared__ __align__(16) float red[kKnSlices][kKnBlockN];
  const int tid = threadIdx.x, lane = tid & 31, slice = tid >> 5;
  const int split = blockIdx.y, k0 = split * kKnChunk;
  const int n0 = blockIdx.x * kKnBlockN + lane * kKnCols;
  for (int i = tid; i < kKnChunk * kSmallM; i += blockDim.x) {
    const int kk = i % kKnChunk, m = i / kKnChunk, k = k0 + kk;
    xs[kk][m] =
        (m < M && k < K) ? ld_x(x, static_cast<int64_t>(m) * K + k, x_bf16)
                         : 0.f;
  }
  float sc[kKnCols];
#pragma unroll
  for (int c = 0; c < kKnCols; ++c)
    sc[c] = n0 + c < N ? scale[n0 + c] : 0.f;
  const int kb = k0 + slice * kKnRows;
  uint2 w[kKnRows];
#pragma unroll
  for (int j = 0; j < kKnRows; ++j) {
    const int k = kb + j;
    w[j] = (k < K && n0 < N)
               ? load8(wq + static_cast<int64_t>(k) * N + n0, N - n0, vec)
               : make_uint2(0u, 0u);
  }
  __syncthreads();
  float acc[kSmallM][kKnCols];
#pragma unroll
  for (int m = 0; m < kSmallM; ++m)
#pragma unroll
    for (int c = 0; c < kKnCols; ++c) acc[m][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kKnRows; ++j) {
    const int kk = slice * kKnRows + j;
    const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
    const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
    const float xv[kSmallM] = {xa.x, xa.y, xa.z, xa.w,
                               xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int c = 0; c < kKnCols; ++c) {
      const float wv = __fmul_rn(byte_of(w[j].x, w[j].y, c), sc[c]);
#pragma unroll
      for (int m = 0; m < kSmallM; ++m)
        acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
    }
  }
  // the 8 runs of each column, summed in slice order
  const int n = blockIdx.x * kKnBlockN + tid;
#pragma unroll
  for (int m = 0; m < kSmallM; ++m) {
    if (m >= M) break;
    float4* dst = reinterpret_cast<float4*>(&red[slice][lane * kKnCols]);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    __syncthreads();
    if (n < N) {
      float v = red[0][tid];
      for (int s = 1; s < kKnSlices; ++s) v = __fadd_rn(v, red[s][tid]);
      const int64_t i = static_cast<int64_t>(m) * N + n;
      if (gridDim.y == 1)
        store_out(out, i, add_bias(v, bias, n, bias_code), out_bf16);
      else
        partial[static_cast<int64_t>(split) * M * N + i] = v;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kNkThreads)
w8_gemv_nk(const void* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, void* __restrict__ out, int M,
           int K, int N, int vec, int x_bf16, int out_bf16) {
  __shared__ __align__(16) float xs[kNkChunk][kSmallM];
  const int n = blockIdx.x * kNkThreads + threadIdx.x;
  const bool live = n < N;
  const float sc = live ? scale[n] : 0.f;
  const int8_t* row = wq + static_cast<int64_t>(live ? n : 0) * K;
  float acc[kSmallM];
#pragma unroll
  for (int m = 0; m < kSmallM; ++m) acc[m] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kNkChunk) {
    const int kc = min(kNkChunk, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kNkChunk * kSmallM; i += kNkThreads) {
      const int kk = i % kNkChunk, m = i / kNkChunk;
      xs[kk][m] = (m < M && kk < kc)
                      ? ld_x(x, static_cast<int64_t>(m) * K + k0 + kk, x_bf16)
                      : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    if (vec) {  // K % 16 == 0: whole 16-byte loads, zeros past kc
      for (int kk = 0; kk < kc; kk += 16 * kNkVec) {
        int4 w[kNkVec];
#pragma unroll
        for (int v = 0; v < kNkVec; ++v)
          w[v] = kk + 16 * v < kc
                     ? *reinterpret_cast<const int4*>(row + k0 + kk + 16 * v)
                     : make_int4(0, 0, 0, 0);
#pragma unroll
        for (int v = 0; v < kNkVec; ++v) {
          const uint32_t words[4] = {
              static_cast<uint32_t>(w[v].x), static_cast<uint32_t>(w[v].y),
              static_cast<uint32_t>(w[v].z), static_cast<uint32_t>(w[v].w)};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int k = kk + 16 * v + b;  // < kNkChunk: kk <= 384
            const float q = static_cast<float>(static_cast<int8_t>(
                (words[b >> 2] >> (8 * (b & 3))) & 0xffu));
            const float wv = __fmul_rn(q, sc);
            const float4 xa = *reinterpret_cast<const float4*>(&xs[k][0]);
            const float4 xb = *reinterpret_cast<const float4*>(&xs[k][4]);
            acc[0] = fmaf(xa.x, wv, acc[0]);
            acc[1] = fmaf(xa.y, wv, acc[1]);
            acc[2] = fmaf(xa.z, wv, acc[2]);
            acc[3] = fmaf(xa.w, wv, acc[3]);
            acc[4] = fmaf(xb.x, wv, acc[4]);
            acc[5] = fmaf(xb.y, wv, acc[5]);
            acc[6] = fmaf(xb.z, wv, acc[6]);
            acc[7] = fmaf(xb.w, wv, acc[7]);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kc; ++kk) {
        const float wv = __fmul_rn(static_cast<float>(row[k0 + kk]), sc);
#pragma unroll
        for (int m = 0; m < kSmallM; ++m)
          acc[m] = fmaf(xs[kk][m], wv, acc[m]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int m = 0; m < kSmallM; ++m) {
    if (m >= M) break;
    store_out(out, static_cast<int64_t>(m) * N + n, acc[m], out_bf16);
  }
}

// NK: wq is (N, K), K contiguous; else (K, N), N contiguous.
template <bool NK>
__global__ void __launch_bounds__(kTileThreads)
w8_tiled(const void* __restrict__ x, const int8_t* __restrict__ wq,
         const float* __restrict__ scale, const void* __restrict__ bias,
         void* __restrict__ out, float* __restrict__ partial, int M, int K,
         int N, int tiles_per_split, int vec, int x_bf16, int out_bf16,
         int bias_code) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kt0 = split * tiles_per_split;
  const int kt1 = min(kt0 + tiles_per_split, cdiv(K, BK));
  // x loads: row m0 + xr, columns xc .. xc + 3 of the step
  const int xr = tid / 4, xc = (tid % 4) * 4;
  // weight loads: KN row wr_k, columns wr_n .. wr_n + 7 of the tile;
  //               NK channel wr_n, columns wr_k .. wr_k + 7 of the step
  const int wr_k = NK ? (tid % 2) * 8 : tid / 16;
  const int wr_n = NK ? tid / 2 : (tid % 16) * 8;
  float sc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = NK ? n0 + wr_n : n0 + wr_n + c;
    sc[c] = n < N ? scale[n] : 0.f;
  }
  float xreg[4];
  uint2 wreg;
  auto load = [&](int kt) {
    const int kbase = kt * BK;
    const int m = m0 + xr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kbase + xc + j;
      xreg[j] = (m < M && k < K)
                    ? ld_x(x, static_cast<int64_t>(m) * K + k, x_bf16)
                    : 0.f;
    }
    if (NK) {
      const int n = n0 + wr_n, k = kbase + wr_k;
      wreg = (n < N && k < K)
                 ? load8(wq + static_cast<int64_t>(n) * K + k, K - k, vec)
                 : make_uint2(0u, 0u);
    } else {
      const int k = kbase + wr_k, n = n0 + wr_n;
      wreg = (k < K && n < N)
                 ? load8(wq + static_cast<int64_t>(k) * N + n, N - n, vec)
                 : make_uint2(0u, 0u);
    }
  };
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[xc + j][xr] = xreg[j];
    float d[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      d[c] = __fmul_rn(byte_of(wreg.x, wreg.y, c), sc[c]);
    if (NK) {
#pragma unroll
      for (int c = 0; c < 8; ++c) ws[wr_k + c][wr_n] = d[c];
    } else {
      float4* dst = reinterpret_cast<float4*>(&ws[wr_k][wr_n]);
      dst[0] = make_float4(d[0], d[1], d[2], d[3]);
      dst[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const int64_t o = static_cast<int64_t>(m) * N + n;
      if (gridDim.z == 1)
        store_out(out, o, add_bias(acc[i][j], bias, n, bias_code), out_bf16);
      else
        partial[static_cast<int64_t>(split) * M * N + o] = acc[i][j];
    }
  }
}

// Sums the K parts of every output in part order, then bias and cast.
__global__ void w8_reduce(const float* __restrict__ partial,
                          const void* __restrict__ bias,
                          void* __restrict__ out, int splits, int M, int N,
                          int out_bf16, int bias_code) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = partial[i];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, partial[s * total + i]);
    store_out(out, i, add_bias(v, bias, i % N, bias_code), out_bf16);
  }
}

struct Plan {
  bool small;
  dim3 grid;
  int splits;
  int tiles_per_split;
};

Plan plan(int M, int K, int N, bool nk) {
  if (M <= kSmallM) {
    if (nk) return {true, dim3(cdiv(N, kNkThreads)), 1, 0};
    const int s = cdiv(K, kKnChunk);
    return {true, dim3(cdiv(N, kKnBlockN), s), s, 0};
  }
  const int tiles = cdiv(M, BM) * cdiv(N, BN);
  const int kt = cdiv(K, BK);
  int per = kt;
  if (tiles < 2 * kSms) {
    int want = cdiv(2 * kSms, tiles);
    if (want > kt / 8) want = kt / 8;  // a part keeps 8 steps or more
    if (want < 1) want = 1;
    per = cdiv(kt, want);
  }
  const int s = cdiv(kt, per);
  return {false, dim3(cdiv(N, BN), cdiv(M, BM), s), s, per};
}

int launch(const void* x, const void* wq, const void* scale,
           const void* bias, int bias_code, void* out, void* work, int M,
           int K, int N, bool nk, int x_bf16, int out_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(M, K, N, nk);
  float* part = static_cast<float*>(work);
  if (p.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(wq);
  if (p.small && nk) {
    const int vec = (K % 16 == 0) && (wp % 16 == 0);
    w8_gemv_nk<<<p.grid, kNkThreads, 0, st>>>(x, w, sc, out, M, K, N, vec,
                                              x_bf16, out_bf16);
  } else if (p.small) {
    const int vec = (N % 8 == 0) && (wp % 8 == 0);
    w8_gemv_kn<<<p.grid, kKnSlices * 32, 0, st>>>(
        x, w, sc, bias, out, part, M, K, N, vec, x_bf16, out_bf16, bias_code);
  } else if (nk) {
    const int vec = (K % 8 == 0) && (wp % 8 == 0);
    w8_tiled<true><<<p.grid, kTileThreads, 0, st>>>(
        x, w, sc, bias, out, part, M, K, N, p.tiles_per_split, vec, x_bf16,
        out_bf16, bias_code);
  } else {
    const int vec = (N % 8 == 0) && (wp % 8 == 0);
    w8_tiled<false><<<p.grid, kTileThreads, 0, st>>>(
        x, w, sc, bias, out, part, M, K, N, p.tiles_per_split, vec, x_bf16,
        out_bf16, bias_code);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t want = total / 256 + 1;
  const int blocks = static_cast<int>(want < 4 * kSms ? want : 4 * kSms);
  w8_reduce<<<blocks, 256, 0, st>>>(part, bias, out, p.splits, M, N,
                                    out_bf16, bias_code);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 elements of scratch the launch of an (M, K) x (K, N) product
// needs for its K parts (0 where K is not split); nk names the (N, K)
// weight layout.
long long apx_w8_workspace(int M, int K, int N, int nk) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  const Plan p = plan(M, K, N, nk != 0);
  return p.splits > 1 ? static_cast<long long>(p.splits) * M * N : 0;
}

// x: (M, K) row-major, fp32 (x_bf16 0) or bf16 (1); wq: (K, N) int8
// row-major; scale: (N,) fp32; bias: (N,) fp32 (bias_bf16 0) or bf16 (1);
// out: (M, N) fp32 (out_bf16 0) or bf16 (1); work: apx_w8_workspace
// floats, or null where that is 0. Launches on `stream`; returns
// cudaGetLastError().
int apx_w8_matmul(const void* x, const void* wq, const void* scale,
                  const void* bias, void* out, void* work, int M, int K,
                  int N, int x_bf16, int out_bf16, int bias_bf16,
                  void* stream) {
  return launch(x, wq, scale, bias, 1 + bias_bf16, out, work, M, K, N, false,
                x_bf16, out_bf16, stream);
}

// As apx_w8_matmul, with no bias.
int apx_w8_matmul_nobias(const void* x, const void* wq, const void* scale,
                         void* out, void* work, int M, int K, int N,
                         int x_bf16, int out_bf16, void* stream) {
  return launch(x, wq, scale, nullptr, 0, out, work, M, K, N, false, x_bf16,
                out_bf16, stream);
}

// As apx_w8_matmul_nobias with wq (N, K) int8 row-major: one output
// channel a row, as the tied word table is stored.
int apx_w8_matmul_nk(const void* x, const void* wq, const void* scale,
                     void* out, void* work, int M, int K, int N, int x_bf16,
                     int out_bf16, void* stream) {
  return launch(x, wq, scale, nullptr, 0, out, work, M, K, N, true, x_bf16,
                out_bf16, stream);
}

}  // extern "C"
