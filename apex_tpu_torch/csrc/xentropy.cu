// Softmax cross entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels apex_tpu/contrib/xentropy.py :: _fwd_kernel
// (launched by _fwd_call) and _bwd_kernel (launched by _bwd_call). Same
// contract, per row of logits x (n, v) with an int64 label:
//   lse  = log(sum_j exp(x_j))                      (natural log, fp32)
//   loss = lse - (1 - eps) * x[label] - eps * sum_j x_j / v
//   dx   = (exp(x - lse) - (1 - eps) * [j == label] - eps / v) * dloss
// with label < 0 an ignored row: loss 0 and dx 0 (its lse is still
// written). x[label] is 0 for a label >= v, as the JAX one-hot sum
// gives. Arithmetic in fp32; dx is stored in x's dtype.
//
// What bounds it on an H100: bytes. The forward reads x once (an
// online max and sum, one exp per element) and writes two floats a row;
// the backward reads x once and writes dx once. At BERT's (8192, 30522)
// fp32 that is 1 GB each way, against a few operations per element.
//
// Design. Forward: one 256-thread block per row sweeps the vocabulary
// once with coalesced loads; each thread keeps a running max m and sum
// l (rescaled only when the max grows) and, for eps > 0, a plain sum of
// x; the block then merges the (m, l) pairs by warp shuffles and a
// fixed-order pass over the eight warps, so every run gives the same
// bits. Backward: a 2-d grid, rows by 1024-column tiles, each thread
// writing four coalesced columns; nothing is reduced.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 4;

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

// Merges the running (max, sum) pair (m2, l2) into (m, l); an empty
// pair has m = -inf.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                     float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out, int v,
                float one_minus_eps, float eps, int smooth) {
  __shared__ float sm[kWarps], sl[kWarps], ss[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * v;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = -INFINITY, l = 0.f, xs = 0.f;
  for (int c = tid; c < v; c += kThreads) {
    const float xv = ld(xr, c);
    if (xv > m) {
      l = l * expf(m - xv) + 1.f;
      m = xv;
    } else {
      l += expf(xv - m);
    }
    xs += xv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, l, o));
    xs += __shfl_xor_sync(0xffffffffu, xs, o);
  }
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
    ss[warp] = xs;
  }
  __syncthreads();
  if (tid != 0) return;
  m = sm[0];
  l = sl[0];
  xs = ss[0];
  for (int i = 1; i < kWarps; ++i) {
    merge(m, l, sm[i], sl[i]);
    xs += ss[i];
  }
  const float lse = m + logf(l);
  const int64_t label = labels[row];
  const float xy = (label >= 0 && label < v) ? ld(xr, label) : 0.f;
  float out = lse - one_minus_eps * xy;
  if (smooth) out -= eps * xs / (float)v;
  loss[row] = label < 0 ? 0.f : out;
  lse_out[row] = lse;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ dloss,
                T* __restrict__ dx, int v, float one_minus_eps,
                float eps_over_v, int smooth) {
  const int64_t row = blockIdx.x;
  const int64_t label = labels[row];
  const float l = lse[row], dl = dloss[row];
  const int c0 = blockIdx.y * kThreads * kColsPerThread + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int c = c0 + j * kThreads;
    if (c >= v) break;
    float g = 0.f;
    if (label >= 0) {
      float target = c == label ? one_minus_eps : 0.f;
      if (smooth) target += eps_over_v;
      g = (expf(ld(x + row * v, c) - l) - target) * dl;
    }
    st(dx + row * v, c, g);
  }
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n, v) row-major, dtype 0 fp32 / 1 bf16; labels: (n,) int64; loss,
// lse: (n,) fp32. one_minus_eps and eps as fp32 (eps = label
// smoothing). Launches on `stream`; returns cudaGetLastError().
int apx_xentropy_fwd(const void* x, const void* labels, void* loss,
                     void* lse, int n, int v, int dtype, float one_minus_eps,
                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  const int smooth = eps > 0.f;
  if (dtype == kBF16)
    xent_fwd_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, lo, ls, v, one_minus_eps,
        eps, smooth);
  else
    xent_fwd_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(x), lab, lo, ls, v, one_minus_eps, eps,
        smooth);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (n, v) in dtype; labels (n,) int64; lse, dloss: (n,) fp32.
// eps_over_v = eps / v as fp32; smooth = eps > 0.
int apx_xentropy_bwd(const void* x, const void* labels, const void* lse,
                     const void* dloss, void* dx, int n, int v, int dtype,
                     float one_minus_eps, float eps_over_v, int smooth,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n, (v + kThreads * kColsPerThread - 1) /
                         (kThreads * kColsPerThread));
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  if (dtype == kBF16)
    xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), lab, ls, dl,
        static_cast<__nv_bfloat16*>(dx), v, one_minus_eps, eps_over_v,
        smooth);
  else
    xent_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), lab, ls, dl, static_cast<float*>(dx), v,
        one_minus_eps, eps_over_v, smooth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
