// Flat Adam / AdamW step over packed (rows, 128) buffers, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel apex_tpu/multi_tensor_apply/kernels.py ::
// _adam_kernel (launched by flat_adam). Same contract, per element, in the
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

}  // extern "C"
