// Flat-buffer kernels over packed (rows, 128) buffers, for Hopper (sm_90a):
// Adam / AdamW (below), then scale, axpby, the L2 partials and LAMB's
// stage 1 (further down, each with its own note).
//
// apx_flat_adam replaces the TPU kernel
// apex_tpu/multi_tensor_apply/kernels.py :: _adam_kernel (launched by
// flat_adam). Same contract, per element, in the
// JAX kernel's order of operations, every step rounded to fp32 (the
// __f*_rn intrinsics keep nvcc from contracting a multiply and an add into
// an FMA, so the result is bit for bit the plain PyTorch version's):
//   g    = g * grad_scale
//   g_l2 = g + ((1 - adam_w) * wd) * p
//   m    = b1 * m + (1 - b1) * g_l2                 (m fp32 or bf16 in memory)
//   v    = b2 * v + ((1 - b2) * g_l2) * g_l2
//   u    = (m / c1) / (sqrt(v / c2) + eps) + (adam_w * wd) * p
//   p    = p - lr * u
// with the nine hyperparameters (lr, b1, b2, eps, wd, c1, c2, adam_w,
// grad_scale) read from one fp32 vector on the device, as the JAX kernel
// reads them from SMEM: c1 and c2 come from the device step counter, so
// nothing in a step waits on the host. A bf16 m is accumulated in fp32 and
// stored round-to-nearest-even; v stays fp32. The optional cast-out writes
// bf16(p) from registers. With the device flag found_inf set (apex's
// noop_flag), the kernel writes the old p, m and v (and bf16 of the old p)
// instead, so a skipped step costs no select pass afterwards.
//
// What bounds it on an H100: bytes. Four reads and three writes of 4 bytes
// an element in fp32 mode (28 B), 26 B with a bf16 m and the cast-out,
// against a dozen operations: BERT-Large's 336M parameters move 9.4 GB,
// 2.8 ms at 3.35 TB/s.
//
// Design: grid-stride elementwise, four elements a thread a step (16-byte
// loads of g, p and v; 16 or 8 bytes of m), no shared memory. A buffer of
// (rows, 128) always holds a multiple of four elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct alignas(8) Bf16x4 {
  __nv_bfloat16 v[4];
};

__device__ __forceinline__ void load4(const float* m, int64_t i, float* out) {
  const float4 a = reinterpret_cast<const float4*>(m)[i];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* m, int64_t i,
                                      float* out) {
  const Bf16x4 a = reinterpret_cast<const Bf16x4*>(m)[i];
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = __bfloat162float(a.v[e]);
}
__device__ __forceinline__ void store4(float* m, int64_t i, const float* in) {
  reinterpret_cast<float4*>(m)[i] = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* m, int64_t i,
                                       const float* in) {
  Bf16x4 a;
#pragma unroll
  for (int e = 0; e < 4; ++e) a.v[e] = __float2bfloat16_rn(in[e]);
  reinterpret_cast<Bf16x4*>(m)[i] = a;
}

template <typename MT>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ g, const float* __restrict__ p,
            const MT* __restrict__ m, const float* __restrict__ v,
            float* __restrict__ p_out, MT* __restrict__ m_out,
            float* __restrict__ v_out, __nv_bfloat16* __restrict__ pc_out,
            const float* __restrict__ hp, const uint8_t* __restrict__ found,
            int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (found != nullptr && *found != 0) {  // skipped step: the old values
    for (int64_t i = first; i < n4; i += stride) {
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      reinterpret_cast<float4*>(p_out)[i] = pv;
      if (sizeof(MT) == 4)
        reinterpret_cast<float4*>(m_out)[i] =
            reinterpret_cast<const float4*>(m)[i];
      else
        reinterpret_cast<uint2*>(m_out)[i] =
            reinterpret_cast<const uint2*>(m)[i];
      reinterpret_cast<float4*>(v_out)[i] =
          reinterpret_cast<const float4*>(v)[i];
      if (pc_out != nullptr) {
        const float pp[4] = {pv.x, pv.y, pv.z, pv.w};
        store4(pc_out, i, pp);
      }
    }
    return;
  }
  const float lr = hp[0], b1 = hp[1], b2 = hp[2], eps = hp[3], wd = hp[4];
  const float c1 = hp[5], c2 = hp[6], aw = hp[7], gs = hp[8];
  const float l2 = __fmul_rn(__fsub_rn(1.f, aw), wd);  // (1 - adam_w) * wd
  const float dw = __fmul_rn(aw, wd);                   // adam_w * wd
  const float ob1 = __fsub_rn(1.f, b1), ob2 = __fsub_rn(1.f, b2);
  for (int64_t i = first; i < n4; i += stride) {
    float gv[4], pv[4], mv[4], vv[4];
    load4(g, i, gv);
    load4(p, i, pv);
    load4(m, i, mv);
    load4(v, i, vv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gg = __fmul_rn(gv[e], gs);
      const float gl = __fadd_rn(gg, __fmul_rn(l2, pv[e]));
      mv[e] = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(ob1, gl));
      vv[e] = __fadd_rn(__fmul_rn(b2, vv[e]), __fmul_rn(__fmul_rn(ob2, gl), gl));
      const float u = __fadd_rn(
          __fdiv_rn(__fdiv_rn(mv[e], c1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(vv[e], c2)), eps)),
          __fmul_rn(dw, pv[e]));
      pv[e] = __fsub_rn(pv[e], __fmul_rn(lr, u));
    }
    store4(p_out, i, pv);
    store4(m_out, i, mv);
    store4(v_out, i, vv);
    if (pc_out != nullptr) store4(pc_out, i, pv);
  }
}

// ---------------------------------------------------------------------------
// scale and axpby, each with an all-finite flag.
//
// Replace _scale_kernel (flat_scale) and _axpby_kernel (flat_axpby) of
// apex_tpu/multi_tensor_apply/kernels.py:
//   scale:  out = cast(x * s),                     flag on x (the incoming
//           values, as apex's overflow_buf: a scaled value may shrink back
//           into range)
//   axpby:  out = cast(a * x + b * y),             flag on the fp32 result
// with a * x and b * y rounded separately, then added (no FMA), as the JAX
// kernel computes them. x, y and out are fp32 or bf16 each. The flag is one
// device byte the wrapper zeroes; a warp that saw a non-finite value writes
// 1, so any order of writes gives the same flag.
//
// Bound on an H100: bytes (8 B an element for fp32 scale, 12 B for axpby,
// against two or three operations). Grid-stride, four elements a thread a
// step, as apx_flat_adam.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool not_finite(float x) {  // inf or NaN
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ void flag_if(bool bad, uint8_t* found) {
  if (__any_sync(0xffffffffu, bad) && (threadIdx.x & 31) == 0) *found = 1;
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const XT* __restrict__ x, OT* __restrict__ out,
             const float* __restrict__ sp, uint8_t* __restrict__ found,
             int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const float s = *sp;
  bool bad = false;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    float xv[4];
    load4(x, i, xv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bad |= not_finite(xv[e]);
      xv[e] = __fmul_rn(xv[e], s);
    }
    store4(out, i, xv);
  }
  flag_if(bad, found);
}

template <typename XT, typename YT, typename OT>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const XT* __restrict__ x, const YT* __restrict__ y,
             OT* __restrict__ out, const float* __restrict__ ab,
             uint8_t* __restrict__ found, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const float a = ab[0], b = ab[1];
  bool bad = false;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    float xv[4], yv[4];
    load4(x, i, xv);
    load4(y, i, yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[e] = __fadd_rn(__fmul_rn(a, xv[e]), __fmul_rn(b, yv[e]));
      bad |= not_finite(xv[e]);
    }
    store4(out, i, xv);
  }
  flag_if(bad, found);
}

// ---------------------------------------------------------------------------
// L2 partials and LAMB stage 1.
//
// apx_flat_l2norm_partials replaces _l2_kernel (flat_l2norm_partials): one
// fp32 sum of squares for each (8, 128) sub-tile of 1,024 elements, the
// partials LAMB's global grad-norm pre-pass sums. apx_flat_lamb_stage1
// replaces _lamb_stage1_kernel (flat_lamb): per element, in the JAX
// kernel's order of fp32 operations (__f*_rn: no FMA contraction, so m, v
// and u are bit for bit the plain PyTorch version's),
//   g    = g * (grad_scale / clip)
//   g_l2 = g + ((1 - adam_w) * wd) * p
//   m    = b1 * m + beta3 * g_l2                    (m fp32 or bf16 in memory)
//   v    = b2 * v + ((1 - b2) * g_l2) * g_l2
//   u    = (m / c1) / (sqrt(v / c2) + eps) + (adam_w * wd) * p
// with the nine hyperparameters (b1, b2, eps, wd, c1, c2, adam_w, beta3,
// grad_scale / clip) read from one fp32 vector on the device, plus each
// sub-tile's sums of p^2 and u^2, the partials of stage 2's per-tensor
// norms (tensor spans are whole sub-tiles, so a partial belongs to one
// tensor). With the device flag found_inf set the kernel writes the old m
// and v, u = 0 and zero partials: stage 2's p - (lr * ratio) * u then gives
// the old p exactly, so a skipped step needs no select pass.
//
// Fixed reduction order, no atomics, so a repeat gives the same bits: one
// warp owns a sub-tile; lane l reads float4 j * 32 + l (j = 0..7,
// coalesced), keeps its own sum over its 32 elements in that order
// (__fmaf_rn), and the warp adds the 32 sums in a xor butterfly.
//
// Bound on an H100: bytes. The partials read 4 B an element; stage 1 reads
// g, p, m, v and writes m, v, u: 28 B an element with an fp32 m, 24 B with
// a bf16 m, against about twenty operations.
// ---------------------------------------------------------------------------

constexpr int kSub4 = 256;                   // float4s in one sub-tile
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;  // the same bits in every lane: a + b == b + a
}

__global__ void __launch_bounds__(kThreads)
l2_partials_kernel(const float* __restrict__ x, float* __restrict__ parts,
                   int64_t n4, int64_t n_sub) {
  const int lane = threadIdx.x & 31;
  const int64_t sub = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (sub >= n_sub) return;  // the whole warp
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int64_t i = sub * kSub4 + j * 32 + lane;
    if (i < n4) {  // sub-tiles past the end (padding) sum to 0
      const float4 a = reinterpret_cast<const float4*>(x)[i];
      acc = __fmaf_rn(a.x, a.x, acc);
      acc = __fmaf_rn(a.y, a.y, acc);
      acc = __fmaf_rn(a.z, a.z, acc);
      acc = __fmaf_rn(a.w, a.w, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) parts[sub] = acc;
}

template <typename MT>
__global__ void __launch_bounds__(kThreads)
lamb_stage1_kernel(const float* __restrict__ g, const float* __restrict__ p,
                   const MT* __restrict__ m, const float* __restrict__ v,
                   MT* __restrict__ m_out, float* __restrict__ v_out,
                   float* __restrict__ u_out, float* __restrict__ p_parts,
                   float* __restrict__ u_parts, const float* __restrict__ hp,
                   const uint8_t* __restrict__ found, int64_t n4,
                   int64_t n_sub) {
  const int lane = threadIdx.x & 31;
  const int64_t sub = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  if (sub >= n_sub) return;  // the whole warp
  if (found != nullptr && *found != 0) {  // skipped step
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = sub * kSub4 + j * 32 + lane;
      if (i < n4) {
        if (sizeof(MT) == 4)
          reinterpret_cast<float4*>(m_out)[i] =
              reinterpret_cast<const float4*>(m)[i];
        else
          reinterpret_cast<uint2*>(m_out)[i] =
              reinterpret_cast<const uint2*>(m)[i];
        reinterpret_cast<float4*>(v_out)[i] =
            reinterpret_cast<const float4*>(v)[i];
        reinterpret_cast<float4*>(u_out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (lane == 0) p_parts[sub] = u_parts[sub] = 0.f;
    return;
  }
  const float b1 = hp[0], b2 = hp[1], eps = hp[2], wd = hp[3];
  const float c1 = hp[4], c2 = hp[5], aw = hp[6], beta3 = hp[7];
  const float gsc = hp[8];
  const float l2 = __fmul_rn(__fsub_rn(1.f, aw), wd);  // (1 - adam_w) * wd
  const float dw = __fmul_rn(aw, wd);                   // adam_w * wd
  const float ob2 = __fsub_rn(1.f, b2);
  float pacc = 0.f, uacc = 0.f;
#pragma unroll 2
  for (int j = 0; j < 8; ++j) {
    const int64_t i = sub * kSub4 + j * 32 + lane;
    if (i >= n4) continue;
    float gv[4], pv[4], mv[4], vv[4], uv[4];
    load4(g, i, gv);
    load4(p, i, pv);
    load4(m, i, mv);
    load4(v, i, vv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gl = __fadd_rn(__fmul_rn(gv[e], gsc), __fmul_rn(l2, pv[e]));
      mv[e] = __fadd_rn(__fmul_rn(b1, mv[e]), __fmul_rn(beta3, gl));
      vv[e] = __fadd_rn(__fmul_rn(b2, vv[e]), __fmul_rn(__fmul_rn(ob2, gl), gl));
      uv[e] = __fadd_rn(
          __fdiv_rn(__fdiv_rn(mv[e], c1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(vv[e], c2)), eps)),
          __fmul_rn(dw, pv[e]));
      pacc = __fmaf_rn(pv[e], pv[e], pacc);
      uacc = __fmaf_rn(uv[e], uv[e], uacc);
    }
    store4(m_out, i, mv);
    store4(v_out, i, vv);
    store4(u_out, i, uv);
  }
  pacc = warp_sum(pacc);
  uacc = warp_sum(uacc);
  if (lane == 0) {
    p_parts[sub] = pacc;
    u_parts[sub] = uacc;
  }
}

int64_t grid_stride_blocks(int64_t n4) {
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

template <typename XT>
void launch_scale(const void* x, void* out, int out_bf16, const float* s,
                  uint8_t* f, int64_t n4, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const int64_t blocks = grid_stride_blocks(n4);
  if (out_bf16)
    scale_kernel<XT, __nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        xp, static_cast<__nv_bfloat16*>(out), s, f, n4);
  else
    scale_kernel<XT, float><<<blocks, kThreads, 0, st>>>(
        xp, static_cast<float*>(out), s, f, n4);
}

template <typename XT, typename YT>
void launch_axpby(const void* x, const void* y, void* out, int out_bf16,
                  const float* ab, uint8_t* f, int64_t n4, cudaStream_t st) {
  const XT* xp = static_cast<const XT*>(x);
  const YT* yp = static_cast<const YT*>(y);
  const int64_t blocks = grid_stride_blocks(n4);
  if (out_bf16)
    axpby_kernel<XT, YT, __nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        xp, yp, static_cast<__nv_bfloat16*>(out), ab, f, n4);
  else
    axpby_kernel<XT, YT, float><<<blocks, kThreads, 0, st>>>(
        xp, yp, static_cast<float*>(out), ab, f, n4);
}

template <typename XT>
void launch_axpby_y(const void* x, const void* y, int y_bf16, void* out,
                    int out_bf16, const float* ab, uint8_t* f, int64_t n4,
                    cudaStream_t st) {
  if (y_bf16)
    launch_axpby<XT, __nv_bfloat16>(x, y, out, out_bf16, ab, f, n4, st);
  else
    launch_axpby<XT, float>(x, y, out, out_bf16, ab, f, n4, st);
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g, p, v, p_out, v_out: n fp32 elements (n a multiple of 4, 16-byte
// aligned); m, m_out: fp32 (m_bf16 = 0) or bf16 (1); pc_out: bf16 or null;
// hp: the nine fp32 hyperparameters on the device; found_inf: a device bool
// or null. Launches on `stream`; returns cudaGetLastError().
int apx_flat_adam(const void* g, const void* p, const void* m, const void* v,
                  void* p_out, void* m_out, void* v_out, void* pc_out,
                  const void* hp, const void* found_inf, long long n,
                  int m_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n4 = n / 4;
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const float* gp = static_cast<const float*>(g);
  const float* pp = static_cast<const float*>(p);
  const float* vp = static_cast<const float*>(v);
  float* po = static_cast<float*>(p_out);
  float* vo = static_cast<float*>(v_out);
  __nv_bfloat16* pc = static_cast<__nv_bfloat16*>(pc_out);
  const float* h = static_cast<const float*>(hp);
  const uint8_t* f = static_cast<const uint8_t*>(found_inf);
  if (m_bf16)
    adam_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        gp, pp, static_cast<const __nv_bfloat16*>(m), vp, po,
        static_cast<__nv_bfloat16*>(m_out), vo, pc, h, f, n4);
  else
    adam_kernel<float><<<blocks, kThreads, 0, s>>>(
        gp, pp, static_cast<const float*>(m), vp, po,
        static_cast<float*>(m_out), vo, pc, h, f, n4);
  return static_cast<int>(cudaGetLastError());
}

// x, out: n elements (n a multiple of 4, 16-byte aligned), each fp32 (0)
// or bf16 (1); s: one fp32 on the device; found: one zeroed device byte.
int apx_flat_scale(const void* x, void* out, const void* s, void* found,
                   long long n, int x_bf16, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  uint8_t* f = static_cast<uint8_t*>(found);
  if (x_bf16)
    launch_scale<__nv_bfloat16>(x, out, out_bf16, sp, f, n / 4, st);
  else
    launch_scale<float>(x, out, out_bf16, sp, f, n / 4, st);
  return static_cast<int>(cudaGetLastError());
}

// As apx_flat_scale, with y beside x and ab = (a, b) on the device.
int apx_flat_axpby(const void* x, const void* y, void* out, const void* ab,
                   void* found, long long n, int x_bf16, int y_bf16,
                   int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* abp = static_cast<const float*>(ab);
  uint8_t* f = static_cast<uint8_t*>(found);
  if (x_bf16)
    launch_axpby_y<__nv_bfloat16>(x, y, y_bf16, out, out_bf16, abp, f,
                                  n / 4, st);
  else
    launch_axpby_y<float>(x, y, y_bf16, out, out_bf16, abp, f, n / 4, st);
  return static_cast<int>(cudaGetLastError());
}

// x: n fp32 elements (n a multiple of 4, 16-byte aligned); parts: n_sub
// fp32 partials, one a 1,024 elements (those past n are 0).
int apx_flat_l2norm_partials(const void* x, void* parts, long long n,
                             long long n_sub, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n_sub + kWarpsPerBlock - 1) / kWarpsPerBlock;
  l2_partials_kernel<<<blocks < 1 ? 1 : blocks, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(parts), n / 4, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// g, p, v, v_out, u_out: n fp32 elements (n a multiple of 1,024, 16-byte
// aligned); m, m_out: fp32 (m_bf16 = 0) or bf16 (1); p_parts, u_parts:
// n / 1024 fp32 partials; hp: the nine fp32 hyperparameters on the device;
// found_inf: a device bool or null.
int apx_flat_lamb_stage1(const void* g, const void* p, const void* m,
                         const void* v, void* m_out, void* v_out, void* u_out,
                         void* p_parts, void* u_parts, const void* hp,
                         const void* found_inf, long long n, int m_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_sub = n / (4 * kSub4);
  int64_t blocks = (n_sub + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks < 1) blocks = 1;
  const float* gp = static_cast<const float*>(g);
  const float* pp = static_cast<const float*>(p);
  const float* vp = static_cast<const float*>(v);
  float* vo = static_cast<float*>(v_out);
  float* uo = static_cast<float*>(u_out);
  float* pq = static_cast<float*>(p_parts);
  float* uq = static_cast<float*>(u_parts);
  const float* h = static_cast<const float*>(hp);
  const uint8_t* f = static_cast<const uint8_t*>(found_inf);
  if (m_bf16)
    lamb_stage1_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        gp, pp, static_cast<const __nv_bfloat16*>(m), vp,
        static_cast<__nv_bfloat16*>(m_out), vo, uo, pq, uq, h, f, n / 4,
        n_sub);
  else
    lamb_stage1_kernel<float><<<blocks, kThreads, 0, st>>>(
        gp, pp, static_cast<const float*>(m), vp, static_cast<float*>(m_out),
        vo, uo, pq, uq, h, f, n / 4, n_sub);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
