// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Forward. Replaces the TPU kernel apex_tpu/transformer/functional/
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
//
// Backward. Replaces _dq_kernel and _dkv_kernel (launched by
// _bwd_call), with their numerics: scores recomputed from the prescaled
// q, p = exp2(s - lse) from the forward's base-2 lse (0 where masked,
// and on fully masked rows, whose lse is +inf), dp = do . v, the
// dropout keep mask from the same hash applied to dp (divided by
// 1 - rate) and to p (p rounded to the value dtype, times the rounded
// 1 / (1 - rate), rounded again), ds = p * (dp - delta) with delta =
// rowsum(do * o) computed by the caller, and p and ds rounded to the
// value dtype before their products (_P_BF16). Both kernels accumulate
// in fp32 and round the tile once; dq is then multiplied by
// softmax_scale and dk by ln 2 and rounded again, as _bwd_call does
// outside its kernels. Bound on an H100 like the forward: the products
// run on the CUDA cores in fp32.
//
// dq kernel: one block per (batch*head, 32-row q tile) loops over the
// 32-key tiles (the TPU grid's sequential k dimension), the forward's
// layout: each warp owns 8 q rows, lane j owns key j for s and dp, and
// lane j owns dims j, j+32, ... for dq += ds . k. dk/dv kernel: one
// block per (batch*head, 32-key tile) loops over the q tiles (q
// innermost, as in _dkv_kernel): each warp owns 8 keys, lane j owns q
// row j for s and dp, and dims j, j+32, ... for dv += p_drop^T . do
// and dk += ds^T . q~. Under causal masking the dq loop stops at the
// last k tile its rows can see and the dk/dv loop starts at the first q
// tile that can see its keys. q, k, v, o, do are read through strides
// (BERT's q, k, v are views of one fused projection); dq, dk, dv are
// written through strides too.

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

// -- backward ---------------------------------------------------------------

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;      // (B, Sk) int32 or null
  const void* dout;
  const float* lse;     // (B*H, Sq), base 2
  const float* delta;   // (B*H, Sq), rowsum(do * o)
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk, D;
  // element strides (batch, head, seq) of q, k, v, do, dq, dk, dv
  int64_t st[7][3];
  int causal;
  float scale;          // softmax_scale * log2(e): the q prescale
  float dq_scale;       // softmax_scale
  int dropout;
  float drop_scale;     // 1 / (1 - rate), already in the value dtype
  float keep_prob;      // 1 - rate, in fp32
  uint32_t thresh, seed_lo, seed_hi;
};

enum { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV };
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const BwdParams& p,
                                       int which, int b, int h) {
  return static_cast<const T*>(base) + b * p.st[which][0] +
         h * p.st[which][1];
}

template <typename T>
__device__ __forceinline__ T* at_out(void* base, const BwdParams& p,
                                     int which, int b, int h) {
  return static_cast<T*>(base) + b * p.st[which][0] + h * p.st[which][1];
}

// Loads rows [r0, r0 + 32) of a (seq, D) slab into smem rows of `ld`
// floats, zero-filling past `S` and past D; `scale` != 0 prescales in
// fp32 and rounds once to T (the q prescale).
template <typename T, int DM>
__device__ __forceinline__ void load_tile(float* dst, int ld_s, const T* src,
                                          int64_t ss, int r0, int S, int D,
                                          float scale) {
  for (int i = threadIdx.x; i < 32 * DM; i += kThreads) {
    const int r = i / DM, d = i % DM;
    float val = 0.f;
    if (r0 + r < S && d < D) {
      val = Io<T>::load(src + (r0 + r) * ss + d);
      if (scale != 0.f) val = Io<T>::round(val * scale);
    }
    dst[r * ld_s + d] = val;
  }
}

template <int DM>
constexpr int dq_smem_floats() {
  return 2 * kBQ * DM + 2 * kBK * (DM + 4) + kWarps * kRQ * kBK;
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const BwdParams p) {
  constexpr int KS = DM + 4;
  constexpr int ND = DM / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // prescaled q, broadcast
  float* Os = Qs + kBQ * DM;                     // do, broadcast
  float* Ks = Os + kBQ * DM;                     // padded rows
  float* Vs = Ks + kBK * KS;                     // padded rows
  float* Ps = Vs + kBK * KS;                     // ds per warp

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * kRQ;
  const T* kg = at<T>(p.k, p, kK, b, h);
  const T* vg = at<T>(p.v, p, kV, b, h);

  load_tile<T, DM>(Qs, DM, at<T>(p.q, p, kQ, b, h), p.st[kQ][2], q0, p.Sq,
                   p.D, p.scale);
  load_tile<T, DM>(Os, DM, at<T>(p.dout, p, kDO, b, h), p.st[kDO][2], q0,
                   p.Sq, p.D, 0.f);
  float lse[kRQ], dl[kRQ], acc[kRQ][ND];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int qpos = q0 + row0 + r;
    const bool in = qpos < p.Sq;
    lse[r] = in ? p.lse[(int64_t)bh * p.Sq + qpos] : INFINITY;
    dl[r] = in ? p.delta[(int64_t)bh * p.Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[r][c] = 0.f;
  }

  int n_kt = (p.Sk + kBK - 1) / kBK;
  if (p.causal) n_kt = min(n_kt, (min(q0 + kBQ, p.Sq) - 1) / kBK + 1);
  float* Pw = Ps + warp * kRQ * kBK;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and Qs, Os ready)
    load_tile<T, DM>(Ks, KS, kg, p.st[kK][2], k0, p.Sk, p.D, 0.f);
    load_tile<T, DM>(Vs, KS, vg, p.st[kV][2], k0, p.Sk, p.D, 0.f);
    __syncthreads();

    const int kpos = k0 + lane;
    bool kvalid = kpos < p.Sk;
    if (kvalid && p.mask != nullptr)
      kvalid = p.mask[(int64_t)b * p.Sk + kpos] != 0;

    float s[kRQ], dp[kRQ];
#pragma unroll
    for (int r = 0; r < kRQ; ++r) s[r] = dp[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + lane * KS);
    const float4* v4 = reinterpret_cast<const float4*>(Vs + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < DM / 4; ++d4) {
      const float4 kk = k4[d4], vv = v4[d4];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(Qs + (row0 + r) * DM)[d4];
        const float4 oo =
            reinterpret_cast<const float4*>(Os + (row0 + r) * DM)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
        dp[r] = fmaf(oo.x, vv.x, dp[r]);
        dp[r] = fmaf(oo.y, vv.y, dp[r]);
        dp[r] = fmaf(oo.z, vv.z, dp[r]);
        dp[r] = fmaf(oo.w, vv.w, dp[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int qpos = q0 + row0 + r;
      const bool valid = kvalid && (!p.causal || kpos <= qpos);
      const float pr = valid ? exp2f(s[r] - lse[r]) : 0.f;
      float dpr = dp[r];
      if (p.dropout) {
        const bool keep = hash_keep((uint32_t)qpos, (uint32_t)kpos,
                                    (uint32_t)bh, p.seed_lo, p.seed_hi,
                                    p.thresh);
        dpr = keep ? dpr / p.keep_prob : 0.f;
      }
      Pw[r * kBK + lane] = Io<T>::round(pr * (dpr - dl[r]));
    }
    __syncwarp();

    // dq += ds . k: lane owns dims lane + 32 c; k rows read across lanes
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float kk[4][ND];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < ND; ++c)
          kk[jj][c] = Ks[(j + jj) * KS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 ds = reinterpret_cast<const float4*>(Pw + r * kBK)[j / 4];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          float a = acc[r][c];
          a = fmaf(ds.x, kk[0][c], a);
          a = fmaf(ds.y, kk[1][c], a);
          a = fmaf(ds.z, kk[2][c], a);
          a = fmaf(ds.w, kk[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();
  }

  T* dqg = at_out<T>(p.dq, p, kDQ, b, h);
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D)
        Io<T>::store(dqg + qpos * p.st[kDQ][2] + d,
                     Io<T>::round(acc[r][c]) * p.dq_scale);
    }
  }
}

template <int DM>
constexpr int dkv_smem_floats() {
  return 2 * kBK * DM + 2 * kBQ * (DM + 4) + 2 * kBQ +
         2 * kWarps * kRQ * kBQ;
}

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const BwdParams p) {
  constexpr int QS = DM + 4;
  constexpr int ND = DM / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // this block's keys
  float* Vs = Ks + kBK * DM;
  float* Qs = Vs + kBK * DM;   // prescaled q tile, padded rows
  float* Os = Qs + kBQ * QS;   // do tile, padded rows
  float* Ls = Os + kBQ * QS;   // lse of the q tile
  float* Ds = Ls + kBQ;        // delta of the q tile
  float* Pa = Ds + kBQ;        // p_drop per warp: (8 keys, 32 q rows)
  float* Sa = Pa + kWarps * kRQ * kBQ;  // ds per warp

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key0 = warp * kRQ;  // this warp's keys: k0 + key0 + r
  const T* qg = at<T>(p.q, p, kQ, b, h);
  const T* og = at<T>(p.dout, p, kDO, b, h);

  load_tile<T, DM>(Ks, DM, at<T>(p.k, p, kK, b, h), p.st[kK][2], k0, p.Sk,
                   p.D, 0.f);
  load_tile<T, DM>(Vs, DM, at<T>(p.v, p, kV, b, h), p.st[kV][2], k0, p.Sk,
                   p.D, 0.f);
  bool kvalid[kRQ];
  float adk[kRQ][ND], adv[kRQ][ND];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int kpos = k0 + key0 + r;
    kvalid[r] = kpos < p.Sk &&
                (p.mask == nullptr || p.mask[(int64_t)b * p.Sk + kpos] != 0);
#pragma unroll
    for (int c = 0; c < ND; ++c) adk[r][c] = adv[r][c] = 0.f;
  }

  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? k0 / kBQ : 0;  // earlier q tiles see no key here
  float* Pw = Pa + warp * kRQ * kBQ;
  float* Sw = Sa + warp * kRQ * kBQ;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous q tile is consumed (and Ks, Vs ready)
    load_tile<T, DM>(Qs, QS, qg, p.st[kQ][2], q0, p.Sq, p.D, p.scale);
    load_tile<T, DM>(Os, QS, og, p.st[kDO][2], q0, p.Sq, p.D, 0.f);
    if (threadIdx.x < kBQ) {
      const int qpos = q0 + threadIdx.x;
      const bool in = qpos < p.Sq;
      Ls[threadIdx.x] = in ? p.lse[(int64_t)bh * p.Sq + qpos] : INFINITY;
      Ds[threadIdx.x] = in ? p.delta[(int64_t)bh * p.Sq + qpos] : 0.f;
    }
    __syncthreads();

    const int qpos = q0 + lane;
    float s[kRQ], dp[kRQ];
#pragma unroll
    for (int r = 0; r < kRQ; ++r) s[r] = dp[r] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(Qs + lane * QS);
    const float4* o4 = reinterpret_cast<const float4*>(Os + lane * QS);
#pragma unroll 4
    for (int d4 = 0; d4 < DM / 4; ++d4) {
      const float4 qq = q4[d4], oo = o4[d4];
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 kk =
            reinterpret_cast<const float4*>(Ks + (key0 + r) * DM)[d4];
        const float4 vv =
            reinterpret_cast<const float4*>(Vs + (key0 + r) * DM)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
        dp[r] = fmaf(oo.x, vv.x, dp[r]);
        dp[r] = fmaf(oo.y, vv.y, dp[r]);
        dp[r] = fmaf(oo.z, vv.z, dp[r]);
        dp[r] = fmaf(oo.w, vv.w, dp[r]);
      }
    }

    const float lse = Ls[lane], dl = Ds[lane];
#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int kpos = k0 + key0 + r;
      const bool valid = kvalid[r] && (!p.causal || kpos <= qpos);
      const float pr = valid ? exp2f(s[r] - lse) : 0.f;
      float pd = Io<T>::round(pr);
      float dpr = dp[r];
      if (p.dropout) {
        const bool keep = hash_keep((uint32_t)qpos, (uint32_t)kpos,
                                    (uint32_t)bh, p.seed_lo, p.seed_hi,
                                    p.thresh);
        pd = keep ? Io<T>::round(pd * p.drop_scale) : 0.f;
        dpr = keep ? dpr / p.keep_prob : 0.f;
      }
      Pw[r * kBQ + lane] = pd;
      Sw[r * kBQ + lane] = Io<T>::round(pr * (dpr - dl));
    }
    __syncwarp();

    // dv += p_drop^T . do, dk += ds^T . q~: lane owns dims lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kBQ; j += 4) {
      float oo[4][ND], qq[4][ND];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          oo[jj][c] = Os[(j + jj) * QS + lane + 32 * c];
          qq[jj][c] = Qs[(j + jj) * QS + lane + 32 * c];
        }
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float4 pp = reinterpret_cast<const float4*>(Pw + r * kBQ)[j / 4];
        const float4 ds = reinterpret_cast<const float4*>(Sw + r * kBQ)[j / 4];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          float a = adv[r][c], e = adk[r][c];
          a = fmaf(pp.x, oo[0][c], a);
          a = fmaf(pp.y, oo[1][c], a);
          a = fmaf(pp.z, oo[2][c], a);
          a = fmaf(pp.w, oo[3][c], a);
          e = fmaf(ds.x, qq[0][c], e);
          e = fmaf(ds.y, qq[1][c], e);
          e = fmaf(ds.z, qq[2][c], e);
          e = fmaf(ds.w, qq[3][c], e);
          adv[r][c] = a;
          adk[r][c] = e;
        }
      }
    }
    __syncwarp();
  }

  T* dkg = at_out<T>(p.dk, p, kDK, b, h);
  T* dvg = at_out<T>(p.dv, p, kDV, b, h);
#pragma unroll
  for (int r = 0; r < kRQ; ++r) {
    const int kpos = k0 + key0 + r;
    if (kpos >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const int d = lane + 32 * c;
      if (d < p.D) {
        Io<T>::store(dvg + kpos * p.st[kDV][2] + d, adv[r][c]);
        Io<T>::store(dkg + kpos * p.st[kDK][2] + d,
                     Io<T>::round(adk[r][c]) * kLn2);
      }
    }
  }
}

template <typename T, int DM, bool DQ>
cudaError_t launch_bwd(const BwdParams& p, int BH, cudaStream_t stream) {
  const int smem =
      (DQ ? dq_smem_floats<DM>() : dkv_smem_floats<DM>()) * (int)sizeof(float);
  auto kernel = DQ ? flash_dq_kernel<T, DM> : flash_dkv_kernel<T, DM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = DQ ? (p.Sq + kBQ - 1) / kBQ : (p.Sk + kBK - 1) / kBK;
  kernel<<<dim3(BH, tiles), kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename T, bool DQ>
cudaError_t dispatch_bwd(const BwdParams& p, int BH, cudaStream_t stream) {
  if (p.D <= 32) return launch_bwd<T, 32, DQ>(p, BH, stream);
  if (p.D <= 64) return launch_bwd<T, 64, DQ>(p, BH, stream);
  if (p.D <= 128) return launch_bwd<T, 128, DQ>(p, BH, stream);
  return cudaErrorInvalidValue;
}

template <bool DQ>
int bwd_entry(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta, void* dq,
              void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
              const long long* strides, int dtype, int causal, float scale,
              float dq_scale, int dropout, float drop_scale, float keep_prob,
              unsigned int thresh, unsigned int seed_lo, unsigned int seed_hi,
              void* stream) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const int*>(mask);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.causal = causal;
  p.scale = scale;
  p.dq_scale = dq_scale;
  p.dropout = dropout;
  p.drop_scale = drop_scale;
  p.keep_prob = keep_prob;
  p.thresh = thresh;
  p.seed_lo = seed_lo;
  p.seed_hi = seed_hi;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == kBF16
                            ? dispatch_bwd<__nv_bfloat16, DQ>(p, B * H, s)
                            : dispatch_bwd<float, DQ>(p, B * H, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// Backward, one entry per kernel. q, k, v, do: (B, H, S, D) read
// through element strides; dq (dq entry) or dk, dv (dk/dv entry):
// (B, H, S, D) written through strides. strides: 21 values, (batch,
// head, seq) for q, k, v, do, dq, dk, dv in that order. lse, delta:
// (B*H, Sq) fp32 contiguous. scale = softmax_scale * log2(e) (the q
// prescale); dq_scale = softmax_scale; drop_scale = 1 / (1 - rate) in
// the value dtype; keep_prob = 1 - rate. Returns the launch's CUDA
// error (0 on success).
int apx_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int H, int Sq, int Sk, int D, const long long* strides, int dtype,
    int causal, float scale, float dq_scale, int dropout, float drop_scale,
    float keep_prob, unsigned int thresh, unsigned int seed_lo,
    unsigned int seed_hi, void* stream) {
  return bwd_entry<true>(q, k, v, mask, dout, lse, delta, dq, nullptr,
                         nullptr, B, H, Sq, Sk, D, strides, dtype, causal,
                         scale, dq_scale, dropout, drop_scale, keep_prob,
                         thresh, seed_lo, seed_hi, stream);
}

int apx_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* mask,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    int B, int H, int Sq, int Sk, int D, const long long* strides, int dtype,
    int causal, float scale, int dropout, float drop_scale, float keep_prob,
    unsigned int thresh, unsigned int seed_lo, unsigned int seed_hi,
    void* stream) {
  return bwd_entry<false>(q, k, v, mask, dout, lse, delta, nullptr, dk, dv,
                          B, H, Sq, Sk, D, strides, dtype, causal, scale, 1.f,
                          dropout, drop_scale, keep_prob, thresh, seed_lo,
                          seed_hi, stream);
}

}  // extern "C"
