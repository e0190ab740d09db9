// LayerNorm / RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/normalization/fused_layer_norm.py
// :: _fwd_kernel (launched by _fwd_call). Same contract: per row of
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

}  // extern "C"
