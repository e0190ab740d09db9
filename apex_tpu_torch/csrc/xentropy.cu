// Softmax cross entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels apex_tpu/contrib/xentropy.py :: _fwd_kernel
// (launched by _fwd_call) and _bwd_kernel (launched by _bwd_call). Same
// contract, per row of logits x (n, v) with an int64 label:
//   lse  = log(sum_j exp(x_j))                      (natural log, fp32)
//   loss = lse - (1 - eps) * x[label] - eps * sum_j x_j / v
//   dx   = (exp(x - lse) - (1 - eps) * [j == label] - eps / v) * dloss
// with label < 0 an ignored row: loss 0 and dx 0 (its lse is still
// written). Arithmetic in fp32; dx is stored in x's dtype. A label >= v
// is outside the contract: here x[label] counts as 0 and dx has no
// one-hot column. The JAX package gives the same only for a label at or
// past its padded width round_up(v, bv), bv = min(2048, round_up(v,
// 128)); for a label in [v, round_up(v, bv)) its loss is about 1e30, as
// its padded columns hold -1e30 (apex_tpu/utils/pallas.py :: NEG_INF).
//
// What bounds it on an H100: bytes. The forward reads x once (an
// online max and sum, one exp per element) and writes two floats a row;
// the backward reads x once and writes dx once, 2 n v sizeof(x) + 16 n
// bytes. At BERT's (8192, 30522) fp32 that is 1 GB each way, at GPT's
// (8192, 50304) bf16 0.82 GB, against a few operations per element.
//
// Design. Forward: one 256-thread block per row sweeps the vocabulary
// once with coalesced loads; each thread keeps a running max m and sum
// l (rescaled only when the max grows) and, for eps > 0, a plain sum of
// x; the block then merges the (m, l) pairs by warp shuffles and a
// fixed-order pass over the eight warps, so every run gives the same
// bits.
//
// Backward, built for the bytes: a persistent grid (the SM count times
// the blocks an SM holds) whose blocks walk the rows in a fixed stride,
// with no barrier, so a warp that ends a row starts the next at once.
// Each thread reads a row's label, lse and dloss once, a row ahead (in
// flight while the row before streams); a row with label < 0 is a
// stream of zero stores. x is read in 16-byte streaming loads (8 bf16
// or 4 fp32), four vectors a thread in flight before any exp, and dx
// written in 16-byte streaming stores (bf16 packed in pairs, rounded to
// nearest even); column indices inside a row are 32-bit. The common
// element is (exp(x - lse) - eps / v) * dloss; the one vector a row
// holding the label column takes (1 - eps) + eps / v there, so the hot
// loop has one compare a vector and no per-element select. These are
// the parent design's operations in its order (the same expf), so dx
// keeps its bits. A row's vectors start on a 256-byte block of x: rows
// that do not (every row at v 30522 fp32 but one in 32, any row at an
// odd v in bf16) take a scalar head up to that block and a scalar tail
// past the last vector, at most 134 elements, on the block's last
// threads, loaded beside the first vectors. Walking the flat (n v)
// buffer instead would cost a division by v a vector and lose the
// per-row state. With 16-byte alignment alone each warp's 512 bytes
// straddled the 32-byte sectors and 256-byte blocks of its neighbours',
// and (8192, 30522) fp32 and (8192, 50257) bf16 ran 10-15 % slower than
// now; with 128-byte lines, 3-4 % slower. Where x and dx are not
// 16-byte aligned alike (x a view at an odd offset) every element is its
// own access. On an H100 80GB HBM3 at 700 W it reaches 82-84 % of the
// byte bound at (8192, 50304) bf16 and (8192, 30522) fp32, where a copy_
// of the same bytes reaches 90 % (examples/kernel_ab.py); the
// parent's 2-d grid of 1024-column tiles (409,600 blocks at GPT's shape,
// 2-byte accesses, a 64-bit address an element) reached 45 % and 61 %.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1 };
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Backward: kBwdUnroll vectors of VEC elements a thread in flight; a
// row's vectors start on a kBwdAlign-byte boundary of x.
constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 4;
constexpr unsigned kBwdAlign = 256;
static_assert(kBwdAlign % 16 == 0 && kBwdAlign / 2 + 8 <= kBwdThreads,
              "a row's scalar head and tail fit one block");

// 16 bytes of x, read once: a streaming (evict-first) load, 0.1-0.5 %
// faster on an H100 than ld.global.nc.L1::no_allocate with a 256-byte L2
// prefetch.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  return __ldcs(static_cast<const uint4*>(p));
}

// 16 bytes of dx, written once: a streaming (evict-first) store.
__device__ __forceinline__ void st_stream16(void* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// VEC elements of a row as one access: 16 bytes (4 fp32 or 8 bf16), or
// one element where x and dx are not 16-byte aligned alike.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  uint4 raw;
  __device__ __forceinline__ void load(const float* p) { raw = ld_stream16(p); }
  __device__ __forceinline__ float get(int j) const {
    return __uint_as_float(j == 0 ? raw.x : j == 1 ? raw.y : j == 2 ? raw.z
                                                                 : raw.w);
  }
  __device__ __forceinline__ static void store(float* p, const float* g) {
    st_stream16(p, make_uint4(__float_as_uint(g[0]), __float_as_uint(g[1]),
                              __float_as_uint(g[2]), __float_as_uint(g[3])));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = ld_stream16(p);
  }
  // element j of the 8: the low or high half of word j / 2, widened
  // exactly (a bf16 is the high 16 bits of its fp32 value)
  __device__ __forceinline__ float get(int j) const {
    const uint32_t w = j < 2 ? raw.x : j < 4 ? raw.y : j < 6 ? raw.z : raw.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* g) {
    st_stream16(p, make_uint4(pack_bf16(g[0], g[1]), pack_bf16(g[2], g[3]),
                              pack_bf16(g[4], g[5]), pack_bf16(g[6], g[7])));
  }
};

template <typename T>
struct Vec<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = ld(p, 0); }
  __device__ __forceinline__ float get(int) const { return v; }
  __device__ __forceinline__ static void store(T* p, const float* g) {
    st(p, 0, g[0]);
  }
};

template <typename T, int VEC>
__device__ __forceinline__ void store_zeros(T* p) {
  float z[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) z[j] = 0.f;
  Vec<T, VEC>::store(p, z);
}

// dx = (exp(x - lse) - target) * dloss, target = t0 = eps / v (0 without
// smoothing) off the label column and t1 = (1 - eps) + t0 on it.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ dloss,
                T* __restrict__ dx, int n, int v, float one_minus_eps,
                float eps_over_v, int smooth) {
  const int tid = threadIdx.x;
  const float t0 = smooth ? eps_over_v : 0.f;
  const float t1 = smooth ? one_minus_eps + eps_over_v : one_minus_eps;
  int row = blockIdx.x;
  if (row >= n) return;
  int64_t label = labels[row];
  float l = lse[row], dl = dloss[row];
  while (row < n) {
    // the next row's state, in flight while this row streams
    const int next = row + gridDim.x;
    int64_t label_next = -1;
    float l_next = 0.f, dl_next = 0.f;
    if (next < n) {
      label_next = labels[next];
      l_next = lse[next];
      dl_next = dloss[next];
    }
    const T* xr = x + static_cast<int64_t>(row) * v;
    T* dr = dx + static_cast<int64_t>(row) * v;
    // the row's first element on a kBwdAlign-byte boundary
    int head = 0;
    if (VEC > 1) {
      const unsigned off =
          static_cast<unsigned>(reinterpret_cast<uintptr_t>(xr)) %
          kBwdAlign;
      head = static_cast<int>((kBwdAlign - off) % kBwdAlign / sizeof(T));
      head = head < v ? head : v;
    }
    const int nvec = (v - head) / VEC;
    const int tail0 = head + nvec * VEC;
    const T* xh = xr + head;
    T* dh = dr + head;
    // the scalar head [0, head) and tail [tail0, v), on the block's last
    // threads: column sc, or -1
    const int k = kBwdThreads - 1 - tid;
    const int sc = k < head ? k : k - head < v - tail0 ? tail0 + k - head
                                                       : -1;
    if (label < 0) {
      if (sc >= 0) st(dr, sc, 0.f);
      for (int i = tid; i < nvec; i += kBwdThreads)
        store_zeros<T, VEC>(dh + i * VEC);
    } else {
      // the label's column, or none (a label >= v matches no column)
      const unsigned lab = label < v ? static_cast<unsigned>(label) : ~0u;
      const float xs = sc >= 0 ? ld(xr, sc) : 0.f;   // beside the vectors
      for (int i0 = tid; i0 < nvec; i0 += kBwdUnroll * kBwdThreads) {
        Vec<T, VEC> in[kBwdUnroll];
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          const int i = i0 + u * kBwdThreads;
          if (i < nvec) in[u].load(xh + i * VEC);
        }
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          const int i = i0 + u * kBwdThreads;
          if (i >= nvec) break;
          const int c = head + i * VEC;
          float g[VEC];
          if (lab - static_cast<unsigned>(c) < static_cast<unsigned>(VEC)) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float t = lab == static_cast<unsigned>(c + j) ? t1 : t0;
              g[j] = (expf(in[u].get(j) - l) - t) * dl;
            }
          } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              g[j] = (expf(in[u].get(j) - l) - t0) * dl;
          }
          Vec<T, VEC>::store(dh + i * VEC, g);
        }
      }
      if (sc >= 0) {
        const float t = static_cast<unsigned>(sc) == lab ? t1 : t0;
        st(dr, sc, (expf(xs - l) - t) * dl);
      }
    }
    row = next;
    label = label_next;
    l = l_next;
    dl = dl_next;
  }
}

// Blocks of xent_bwd_kernel<T, VEC> the card holds at once: its SM
// count times the blocks an SM takes, read once a device.
template <typename T, int VEC>
int bwd_grid() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 132, per_sm = 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, xent_bwd_kernel<T, VEC>, kBwdThreads, 0) != cudaSuccess ||
      per_sm <= 0)
    per_sm = 1;
  const int g = sms * per_sm;
  if (dev >= 0 && dev < 64) cached[dev] = g;
  return g;
}

template <typename T, int VEC>
void launch_bwd(const void* x, const int64_t* lab, const float* ls,
                const float* dl, void* dx, int n, int v, float one_minus_eps,
                float eps_over_v, int smooth, cudaStream_t s) {
  const int g = bwd_grid<T, VEC>();
  xent_bwd_kernel<T, VEC><<<n < g ? n : g, kBwdThreads, 0, s>>>(
      static_cast<const T*>(x), lab, ls, dl, static_cast<T*>(dx), n, v,
      one_minus_eps, eps_over_v, smooth);
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
// eps_over_v = eps / v as fp32; smooth = eps > 0. 16-byte vectors where x
// and dx sit alike on 16-byte boundaries (as two fresh allocations do),
// else one element a vector.
int apx_xentropy_bwd(const void* x, const void* labels, const void* lse,
                     const void* dloss, void* dx, int n, int v, int dtype,
                     float one_minus_eps, float eps_over_v, int smooth,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  const bool alike = ((reinterpret_cast<uintptr_t>(x) -
                       reinterpret_cast<uintptr_t>(dx)) & 15u) == 0;
  if (dtype == kBF16) {
    if (alike)
      launch_bwd<__nv_bfloat16, 8>(x, lab, ls, dl, dx, n, v, one_minus_eps,
                                   eps_over_v, smooth, s);
    else
      launch_bwd<__nv_bfloat16, 1>(x, lab, ls, dl, dx, n, v, one_minus_eps,
                                   eps_over_v, smooth, s);
  } else {
    if (alike)
      launch_bwd<float, 4>(x, lab, ls, dl, dx, n, v, one_minus_eps,
                           eps_over_v, smooth, s);
    else
      launch_bwd<float, 1>(x, lab, ls, dl, dx, n, v, one_minus_eps,
                           eps_over_v, smooth, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
