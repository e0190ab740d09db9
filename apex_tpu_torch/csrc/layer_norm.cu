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
// Design: apex's two-stage reduction. Stage 1: a 256-thread block owns
// a contiguous run of rows; thread t owns columns t, t + 256, ... (loads
// coalesce) and keeps their running dgamma / dbeta in registers while
// it walks the rows. Each row's c1 and c2 are a block reduction (warp
// shuffles, then the eight warp sums added in a fixed order); the next
// row's dy and x are loaded before that reduction's barrier so the
// loads overlap it. Each block then writes its column partials, one
// row of an (n_blocks, h) fp32 buffer. Stage 2: a second launch sums
// those rows per column, 32 row lanes per column added in a fixed
// order. No float atomics anywhere, so dgamma and dbeta are the same in
// every run. No column split is needed at any h up to 8192 (32 columns
// per thread).

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

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kColTile = 8;    // stage 2: columns per block
constexpr int kRowLanes = 32;  // stage 2: partial rows summed in parallel

// CPT: columns per thread, the smallest of 1, 2, 4, ..., 32 with
// CPT * 256 >= h.
template <typename TX, typename TW, int CPT>
__global__ void __launch_bounds__(kBwdThreads)
layer_norm_bwd_kernel(const TX* __restrict__ dy, const TX* __restrict__ x,
                      const TW* __restrict__ w,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, TX* __restrict__ dx,
                      float* __restrict__ part_w, float* __restrict__ part_b,
                      int rows, int h, int rms, int rows_per_block) {
  __shared__ float red[2][2][kBwdWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  const float fh = (float)h;
  float wv[CPT], gw[CPT], gb[CPT], dv[CPT], xv[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * kBwdThreads;
    wv[j] = (w != nullptr && c < h) ? ld(w, c) : 1.f;
    gw[j] = gb[j] = 0.f;
    dv[j] = xv[j] = 0.f;
    if (r0 < r1 && c < h) {
      dv[j] = ld(dy + (int64_t)r0 * h, c);
      xv[j] = ld(x + (int64_t)r0 * h, c);
    }
  }
  for (int row = r0; row < r1; ++row) {
    const float mu = mean != nullptr ? mean[row] : 0.f;
    const float rs = rstd[row];
    float xh[CPT], wd[CPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      xh[j] = (xv[j] - mu) * rs;
      wd[j] = dv[j] * wv[j];
      s1 += xh[j] * wd[j];
      s2 += wd[j];
      gw[j] += dv[j] * xh[j];
      gb[j] += dv[j];
    }
    // columns past h hold dy = x = 0: they add nothing above (xh may be
    // nonzero there, but wd and dy are 0)
    if (row + 1 < r1) {  // prefetch the next row across the barrier
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * kBwdThreads;
        if (c < h) {
          dv[j] = ld(dy + (int64_t)(row + 1) * h, c);
          xv[j] = ld(x + (int64_t)(row + 1) * h, c);
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const int buf = (row - r0) & 1;  // double buffer: one barrier a row
    if (lane == 0) {
      red[buf][0][warp] = s1;
      red[buf][1][warp] = s2;
    }
    __syncthreads();
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < kBwdWarps; ++i) {
      c1 += red[buf][0][i];
      c2 += red[buf][1][i];
    }
    c1 /= fh;
    c2 /= fh;
    TX* dxr = dx + (int64_t)row * h;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * kBwdThreads;
      if (c < h) {
        float g = wd[j] - xh[j] * c1;
        if (!rms) g -= c2;
        st(dxr, c, g * rs);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + j * kBwdThreads;
    if (c < h) {
      if (part_w != nullptr) part_w[(int64_t)blockIdx.x * h + c] = gw[j];
      if (part_b != nullptr) part_b[(int64_t)blockIdx.x * h + c] = gb[j];
    }
  }
}

template <typename TW, typename TB>
__global__ void __launch_bounds__(kColTile * kRowLanes)
layer_norm_bwd_colsum_kernel(const float* __restrict__ part_w,
                             const float* __restrict__ part_b,
                             TW* __restrict__ dw, TB* __restrict__ db,
                             int n_parts, int h) {
  __shared__ float s[2][kRowLanes][kColTile + 1];
  const int cx = threadIdx.x, ry = threadIdx.y;
  const int c = blockIdx.x * kColTile + cx;
  float aw = 0.f, ab = 0.f;
  if (c < h) {
    for (int r = ry; r < n_parts; r += kRowLanes) {
      if (part_w != nullptr) aw += part_w[(int64_t)r * h + c];
      if (part_b != nullptr) ab += part_b[(int64_t)r * h + c];
    }
  }
  s[0][ry][cx] = aw;
  s[1][ry][cx] = ab;
  __syncthreads();
  if (ry == 0 && c < h) {
    float tw = 0.f, tb = 0.f;
    for (int i = 0; i < kRowLanes; ++i) {
      tw += s[0][i][cx];
      tb += s[1][i][cx];
    }
    if (dw != nullptr) st(dw, c, tw);
    if (db != nullptr) st(db, c, tb);
  }
}

template <typename TX, typename TW, int CPT>
void launch_bwd(const void* dy, const void* x, const void* w,
                const float* mean, const float* rstd, void* dx,
                float* part_w, float* part_b, int rows, int h, int rms,
                int rpb, cudaStream_t s) {
  const int blocks = (rows + rpb - 1) / rpb;
  layer_norm_bwd_kernel<TX, TW, CPT><<<blocks, kBwdThreads, 0, s>>>(
      static_cast<const TX*>(dy), static_cast<const TX*>(x),
      static_cast<const TW*>(w), mean, rstd, static_cast<TX*>(dx), part_w,
      part_b, rows, h, rms, rpb);
}

template <typename TX, typename TW>
int dispatch_cpt(const void* dy, const void* x, const void* w,
                 const float* mean, const float* rstd, void* dx,
                 float* part_w, float* part_b, int rows, int h, int rms,
                 int rpb, cudaStream_t s) {
#define APX_LN_BWD(N)                                                     \
  if (h <= N * kBwdThreads) {                                             \
    launch_bwd<TX, TW, N>(dy, x, w, mean, rstd, dx, part_w, part_b, rows, \
                          h, rms, rpb, s);                                \
    return 0;                                                             \
  }
  APX_LN_BWD(1)
  APX_LN_BWD(2)
  APX_LN_BWD(4)
  APX_LN_BWD(8)
  APX_LN_BWD(16)
  APX_LN_BWD(32)
#undef APX_LN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TW, typename TB>
void launch_colsum(const float* part_w, const float* part_b, void* dw,
                   void* db, int n_parts, int h, cudaStream_t s) {
  const dim3 block(kColTile, kRowLanes);
  layer_norm_bwd_colsum_kernel<TW, TB>
      <<<(h + kColTile - 1) / kColTile, block, 0, s>>>(
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
  int e;
  if (x_dtype == kBF16)
    e = w_dtype == kBF16
            ? dispatch_cpt<__nv_bfloat16, __nv_bfloat16>(
                  dy, x, w, m, r, dx, pw, pb, rows, h, rms, rows_per_block, s)
            : dispatch_cpt<__nv_bfloat16, float>(
                  dy, x, w, m, r, dx, pw, pb, rows, h, rms, rows_per_block, s);
  else
    e = w_dtype == kBF16
            ? dispatch_cpt<float, __nv_bfloat16>(
                  dy, x, w, m, r, dx, pw, pb, rows, h, rms, rows_per_block, s)
            : dispatch_cpt<float, float>(dy, x, w, m, r, dx, pw, pb, rows, h,
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
