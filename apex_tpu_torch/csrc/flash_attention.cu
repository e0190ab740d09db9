// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/transformer/functional/
// flash_attention.py :: _fwd_kernel (launched by _fwd_call). Same
// contract: q (pre-scaled by softmax_scale * log2(e) in fp32 and
// rounded once to the storage dtype, as _prescale_q does), k, v in
// (batch, heads, seq, d) with any strides and unit stride over d;
// base-2 online softmax with running m, l and the output accumulator in
// fp32; scores masked to -1e30 by the optional (batch, s_k) key mask
// (1 = attend), the causal mask (k <= q) and the sequence end; p
// rounded to the value dtype before the PV product (_P_BF16); dropout
// after normalisation from the same _hash_keep integer mix over the
// global (head, q, k) position, so keep masks equal the plain
// version's bit for bit. Fully masked rows give o = 0 and lse = +inf.
// Outputs o in q's dtype and the base-2 logsumexp (b*h, s_q) in fp32.
//
// What bounds it on an H100: at d = 64 the work is ~4*d flops per
// (q, k) pair against 4 * s * d * 2 bytes of q, k, v, o per head, so a
// tensor-core kernel would be bound by bytes at s = 1024. This first
// kernel runs the products on the CUDA cores in fp32, so it is bound
// by those operations and by shared-memory traffic, not by device
// memory; tensor-core (mma/wgmma) tiles are later work.
//
// Design: one 128-thread block per (batch*head, 32-row q tile), looping
// over 32-key k tiles (the TPU grid's sequential k dimension becomes the
// loop; nothing carries between blocks). Each warp owns 8 q rows. For
// scores, lane j owns key j of the tile and dots it with the warp's 8 q
// rows, reading k as float4 from a padded shared row (conflict-free) and
// q as broadcast float4. Row max and sum are warp shuffles. For PV,
// lane j owns dims j, j+32, ... and reads p from shared memory as
// broadcast float4, four keys at a time. Causal blocks stop at the last
// k tile their last row can see: skipped tiles are fully masked and
// would leave m, l and the accumulator unchanged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { kF32 = 0, kBF16 = 1 };
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;            // q rows per block
constexpr int kBK = 32;            // keys per tile: one per lane
constexpr int kRQ = kBQ / kWarps;  // q rows per warp
constexpr float kNeg = -1e30f;     // masked score (the TPU kernel's NEG_INF)

template <typename T>
struct Io;
template <>
struct Io<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};
template <>
struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// _hash_keep: splitmix32-style mix of the global (head, q, k) position
// and the two seed words; keeps the position when the hash clears the
// threshold min(rate * 2^32, 2^32 - 1).
__device__ __forceinline__ bool hash_keep(uint32_t q, uint32_t k,
                                          uint32_t head, uint32_t lo,
                                          uint32_t hi, uint32_t thresh) {
  uint32_t x = (q * 0x9E3779B9u) ^ (k * 0x85EBCA6Bu);
  x ^= lo + head * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= hi + (x >> 15);
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // (B, Sk) int32 or null
  void* o;
  float* lse;       // (B*H, Sq)
  int H, Sq, Sk, D;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int causal;
  float scale;      // softmax_scale * log2(e)
  int dropout;
  float drop_scale; // 1 / (1 - rate), already in the value dtype
  uint32_t thresh, seed_lo, seed_hi;
};

template <int DM>
constexpr int smem_floats() {
  return kBQ * DM + kBK * (DM + 4) + kBK * DM + kWarps * kRQ * kBK;
}

// DM: head dim rounded up to 32, 64 or 128 (zero-padded in shared
// memory, which leaves the scores exact).
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int KS = DM + 4;  // padded k row: conflict-free float4 reads
  constexpr int ND = DM / 32; // output dims per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * DM;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * DM;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * kRQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  // q tile, pre-scaled in fp32 and rounded once to the storage dtype
  for (int i = tid; i < kBQ * DM; i += kThreads) {
    const int r = i / DM, d = i % DM;
    float val = 0.f;
    if (q0 + r < p.Sq && d < p.D)
      val = Io<T>::round(Io<T>::load(qg + (q0 + r) * p.q_ss + d) * p.scale);
    Qs[i] = val;
  }

  float m[kRQ], l[kRQ], acc[kRQ][ND];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  }

  int n_kt = (p.Sk + kBK - 1) / kBK;
  if (p.causal) {
    const int q_last = min(q0 + kBQ, p.Sq) - 1;
    n_kt = min(n_kt, q_last / kBK + 1);
  }
  float* Pw = Ps + warp * kRQ * kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and Qs is ready)
    for (int i = tid; i < kBK * DM; i += kThreads) {
      const int r = i / DM, d = i % DM;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < p.Sk && d < p.D) {
        kv = Io<T>::load(kg + (k0 + r) * p.k_ss + d);
        vv = Io<T>::load(vg + (k0 + r) * p.v_ss + d);
      }
      Ks[r * KS + d] = kv;
      Vs[i] = vv;
    }
    __syncthreads();

    const int kpos = k0 + lane;
    bool kvalid = kpos < p.Sk;
    if (kvalid && p.mask != nullptr)
      kvalid = p.mask[(int64_t)b * p.Sk + kpos] != 0;

    float s[kRQ];
#pragma unroll
    for (int r = 0; r < kRQ; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * KS);
#pragma unroll
    for (int d4 = 0; d4 < DM / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(Qs + (row0 + r) * DM)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int qpos = q0 + row0 + r;
      const bool valid = kvalid && (!p.causal || kpos <= qpos);
      const float sv = valid ? s[r] : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = exp2f(m[r] - m_new);
      float pr = valid ? exp2f(sv - m_new) : 0.f;
      // l sums the fp32 tile, before the cast and before dropout
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
      pr = Io<T>::round(pr);
      if (p.dropout) {
        const bool keep = hash_keep((uint32_t)qpos, (uint32_t)kpos,
                                    (uint32_t)bh, p.seed_lo, p.seed_hi,
                                    p.thresh);
        pr = keep ? Io<T>::round(pr * p.drop_scale) : 0.f;
      }
      Pw[r * kBK + lane] = pr;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][ND];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < ND; ++c)
          vv[jj][c] = Vs[(j + jj) * DM + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 pp = reinterpret_cast<const float4*>(Pw + r * kBK)[j / 4];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          float a = acc[r][c];
          a = fmaf(pp.x, vv[0][c], a);
          a = fmaf(pp.y, vv[1][c], a);
          a = fmaf(pp.z, vv[2][c], a);
          a = fmaf(pp.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.Sq) continue;
    const float lr = l[r];
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D)
        Io<T>::store(og + qpos * p.o_ss + d, lr > 0.f ? acc[r][c] / lr : 0.f);
    }
    if (lane == 0)
      p.lse[(int64_t)bh * p.Sq + qpos] =
          lr > 0.f ? m[r] + log2f(lr) : INFINITY;
  }
}

template <typename T, int DM>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  const int smem = smem_floats<DM>() * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(BH, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, DM><<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int BH, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, BH, stream);
  if (p.D <= 64) return launch<T, 64>(p, BH, stream);
  if (p.D <= 128) return launch<T, 128>(p, BH, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* apx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v: (B, H, S, D) with element strides (sb, sh, ss) and unit
// stride over D; o likewise; lse: (B*H, Sq) fp32 contiguous; mask:
// (B, Sk) int32 contiguous or null. dtype: 0 fp32, 1 bf16 (q, k, v, o
// alike). scale = softmax_scale * log2(e). Launches on `stream` and
// returns the launch's CUDA error (0 on success).
int apx_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int B, int H, int Sq, int Sk, int D, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int dtype, int causal,
    float scale, int dropout, float drop_scale, unsigned int thresh,
    unsigned int seed_lo, unsigned int seed_hi, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const int*>(mask);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal;
  p.scale = scale;
  p.dropout = dropout;
  p.drop_scale = drop_scale;
  p.thresh = thresh;
  p.seed_lo = seed_lo;
  p.seed_hi = seed_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == kBF16
                            ? dispatch_d<__nv_bfloat16>(p, B * H, s)
                            : dispatch_d<float>(p, B * H, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
