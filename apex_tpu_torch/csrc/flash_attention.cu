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
// outside its kernels.
//
// Two designs, chosen at compile time by dtype.
//
// bf16 forward and dk/dv: tensor cores. The JAX kernels run their
// products on the MXU with bf16 operands and fp32 accumulation
// (dot_general with preferred_element_type=f32); here each product is
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators, operand
// fragments loaded from shared memory by ldmatrix (.trans for an
// operand laid out (seq, d) but consumed as K x N). mma.sync, not
// wgmma: at d = 64 a (q, k) pair costs 4d (forward) or 8d (dk/dv)
// operations against q, k, v, o (and do, dk, dv) read or written once,
// so at the BERT shape (b64 h16 s128) and at causal s1024 the least
// time is set by device-memory bytes, and mma.sync's lower peak is not
// what the kernels wait on. What bounds them as built is the
// instructions and latency of each tile on few warps: a block's few
// tiles (two at s = 128) leave its loads exposed, and a causal block's
// 16 tiles run one after another. So the design keeps the per-tile
// instruction count down and the SM full: tiles by 16-byte
// cp.async.cg copies into a double-buffered ring, the next tile in
// flight while the current one is consumed (a third buffer bought
// nothing); copy loops with static trip counts; the mask applied only
// to tiles that hold a masked key, cross the sequence end or cross a
// warp's diagonal (as the JAX kernels' _needs_mask), with the keys'
// validity as two ballot words a tile; exp2 as one ex2.approx.ftz
// (exp2f's instruction without its subnormal fix-ups: a p below 2^-126
// becomes 0, far below what the error models can see); p and ds kept
// in fp32 until the pack to bf16 that rounds them once; outputs staged
// through shared memory and written as 16-byte rows; three 128-thread
// blocks an SM at d <= 64 (168 registers a thread). Tiles live in
// shared memory as bf16 rows padded by 16 bytes (ldmatrix reads eight
// rows on distinct banks) with d zero-padded to 32, 64 or 128, which
// leaves the scores exact. Rows whose starts are all 16-byte aligned,
// with d a multiple of 8 (BERT's (b, s, 3, h, d) views, GPT's
// _split_qkv views, contiguous tensors), take the copies; other rows
// (d = 100: 200-byte rows) element loads into the same layout. The C
// entry picks the variant from the pointers, strides and d (a template
// parameter of the kernel).
//   Forward: one block per (batch*head, 64-row q tile), 16 rows a warp,
//   looping over 64-key tiles. S = q~ k^T stays in registers; its
//   accumulator is rescaled, packed to bf16 and reused in place as the A
//   fragment of P . V, so p never touches shared memory. Causal blocks
//   stop at the last tile their last row can see, and the grid starts
//   the longest causal blocks first.
//   dk/dv: one block per (batch*head, 64-key tile), 16 keys a warp,
//   looping over 32-row q tiles; q is prescaled in shared memory once
//   its copy has landed. Keys are the M dimension: S^T = K q~^T and
//   dP^T = V do^T, so P_drop^T and dS^T come out of the accumulators
//   already as the A fragments of dv += P_drop^T do and dk += dS^T q~.
//   Causal blocks start at the first q tile that can see their keys.
//
// fp32, and the dq kernel in both dtypes: CUDA cores. Tensor cores
// would take fp32 operands as TF32 (10 mantissa bits), which would break
// the fp32 forward's o_limit of 1e-5 (|o0| + 1) and the O0 parity the
// BERT and serving checks hold the fp32 path to; so fp32 keeps these
// kernels, bound by their fp32 operations and shared-memory traffic.
// The dq kernel is next in line for the tensor-core design. Forward:
// one 128-thread block per (batch*head, 32-row q tile), looping over
// 32-key tiles; each warp owns 8 q rows; for scores, lane j owns key j
// of the tile and dots it with the warp's 8 q rows, reading k as
// float4 from a padded shared row (conflict-free) and q as broadcast
// float4; row max and sum are warp shuffles; for PV, lane j owns dims
// j, j+32, ... and reads p from shared memory as broadcast float4. dq
// kernel: one block per (batch*head, 32-row q tile) loops over the
// 32-key tiles, the forward's layout, with lane j owning dims j, j+32,
// ... for dq += ds . k. dk/dv kernel: one block per (batch*head, 32-key
// tile) loops over the q tiles (q innermost, as in _dkv_kernel): each
// warp owns 8 keys, lane j owns q row j for s and dp, and dims j, j+32,
// ... for dv += p_drop^T . do and dk += ds^T . q~. Under causal masking
// the dq loop stops at the last k tile its rows can see and the dk/dv
// loop starts at the first q tile that can see its keys. q, k, v, o, do
// are read through strides (BERT's q, k, v are views of one fused
// projection); dq, dk, dv are written through strides too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { kF32 = 0, kBF16 = 1 };  // dtype codes of the C entries
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;            // q rows per block
constexpr int kBK = 32;            // keys per tile: one per lane
constexpr int kRQ = kBQ / kWarps;  // q rows per warp
constexpr float kNeg = -1e30f;     // masked score (the TPU kernel's NEG_INF)

// The grid: one block per (batch*head, tile of `rows` of n); CUDA caps
// gridDim.y at 65535 tiles.
inline cudaError_t tile_grid(int BH, int n, int rows, dim3* grid) {
  const int tiles = (n + rows - 1) / rows;
  if (tiles > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(BH, tiles);
  return cudaSuccess;
}

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
  int async_rows;   // bf16 tiles by 16-byte cp.async copies
  int o_rows16;     // o's rows all 16-byte aligned, D % 8 == 0
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
  dim3 grid;
  const cudaError_t g = tile_grid(BH, p.Sq, kBQ, &grid);
  if (g != cudaSuccess) return g;
  flash_fwd_kernel<T, DM><<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
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
  int async_rows;       // bf16 tiles by 16-byte cp.async copies
  int out_rows16;       // dk's and dv's rows all 16-byte aligned, D % 8 == 0
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
  void (*kernel)(BwdParams);
  if constexpr (DQ)
    kernel = flash_dq_kernel<T, DM>;
  else  // fp32 only: bf16 dk/dv is flash_dkv_tc_kernel
    kernel = flash_dkv_kernel<T, DM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid;
  const cudaError_t g = DQ ? tile_grid(BH, p.Sq, kBQ, &grid)
                           : tile_grid(BH, p.Sk, kBK, &grid);
  if (g != cudaSuccess) return g;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

// -- tensor-core kernels (bf16) ---------------------------------------------

constexpr int kTcRows = 64;   // q rows a forward block; keys a dk/dv block
constexpr int kTcKeys = 64;   // keys of a forward k tile
// q rows of a dk/dv q tile: 32 keeps S^T and dP^T (16 registers each)
// beside the dk and dv accumulators within the 168 registers that let
// three blocks share an SM at d <= 64 (a 64-row tile left two)
constexpr int kTcQRows = 32;
// tiles in flight in the K/V (forward) and q/do (dk/dv) rings: a third
// buffer bought no time on the H100 (the causal forward is bound by its
// instructions a tile, not by the copies' latency)
constexpr int kStages = 2;
constexpr int kPad = 8;       // bf16 padding a shared row: 16 bytes

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of a lane holds (row lane/4, cols 2(lane%4),
// +1) of matrix i, or with .trans (rows 2(lane%4), +1, col lane/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col). Fragment
// of lane (g = lane/4, t = lane%4): c[0..1] row g, cols 2t, 2t+1;
// c[2..3] row g+8; a[0] row g, cols 2t, 2t+1; a[1] row g+8; a[2], a[3]
// the same rows at cols 8+2t, 9+2t; b[0] rows 2t, 2t+1 of col g; b[1]
// rows 8+2t, 9+2t.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded (to nearest even) to bf16, the low column in
// the low half: the one rounding of p and ds before their products.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 16-row, 16-column slice of an accumulator held
// as n-tiles c[2j] and c[2j+1] (the accumulator's layout is the A
// operand's, two n-tiles to a k chunk).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared, bypassing L1; `full` false zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a (seq, D) bf16 slab with row stride ss into
// shared rows of DM + kPad elements, zero past S and past D (to DM).
// ASYNC: 16-byte cp.async copies (every row start 16-byte aligned, D a
// multiple of 8; the caller commits and waits); else element loads.
template <int R, int DM, bool ASYNC>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t ss, int r0, int S, int D) {
  constexpr int LD = DM + kPad;
  if constexpr (ASYNC) {
    constexpr int CH = DM / 8;
    static_assert(R * CH % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < R * CH / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r0 + r < S && c < D;
      cp_async16(smem_addr(dst + r * LD + c),
                 in ? src + (int64_t)(r0 + r) * ss + c : src, in);
    }
  } else {
    static_assert(R * DM % kThreads == 0, "whole rows of threads");
#pragma unroll 4
    for (int it = 0; it < R * DM / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / DM, c = i % DM;
      dst[r * LD + c] = r0 + r < S && c < D ? src[(int64_t)(r0 + r) * ss + c]
                                            : __float2bfloat16_rn(0.f);
    }
  }
}

// The q prescale in shared memory: times softmax_scale * log2(e) in
// fp32, rounded once to bf16.
template <int R, int DM>
__device__ __forceinline__ void prescale_rows(bf16* t, float scale) {
  constexpr int LD = DM + kPad, HALF = DM / 2;
  static_assert(R * HALF % kThreads == 0, "whole pairs a thread");
#pragma unroll
  for (int it = 0; it < R * HALF / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(
        t + (i / HALF) * LD + (i % HALF) * 2);
    const float2 f = __bfloat1622float2(*e);
    *e = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
}

// 2^x on the special-function unit (exp2f's instruction without its
// subnormal fix-ups): a result below 2^-126 is flushed to 0; o and the
// gradients cannot see a term that small against their error models.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Address of this lane's row for an x4 ldmatrix of a 16 x 16 slice at
// (row0, col0) of a shared tile with rows of LD elements. A operand (row
// major, m x k): matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7,
// 8-15), (8-15, 8-15). B operand from n-major rows (n x k, no .trans):
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15),
// i.e. b0, b1 of n-tile 0 then of n-tile 1. B operand from k-major rows
// (k x n, .trans): (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15), the same order.
template <int LD>
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int row0, int col0,
                                           int lane) {
  return smem_addr(t + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bn_addr(const bf16* t, int n0, int k0,
                                            int lane) {
  return smem_addr(t + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 +
                   ((lane >> 3) & 1) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bk_addr(const bf16* t, int k0, int n0,
                                            int lane) {
  return smem_addr(t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

template <int DM>
constexpr int fwd_tc_smem_bytes() {
  return (kTcRows + 2 * kStages * kTcKeys) * (DM + kPad) * 2 +
         kStages * (kTcKeys / 32) * 4;
}

// Rows [r0, r0 + 16) of a shared tile (rows of LD elements, bf16) out to
// a (seq, D) slab with row stride ss, rows past S skipped: 16-byte
// stores where every destination row start is 16-byte aligned and D a
// multiple of 8 (`vec`), element stores otherwise. One warp.
template <int DM>
__device__ __forceinline__ void store_rows16(bf16* dst, int64_t ss,
                                             const bf16* src, int r0, int S,
                                             int D, bool vec, int lane) {
  constexpr int LD = DM + kPad;
  if (vec) {
    constexpr int CH = DM / 8;
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int i = lane + it * 32;
      const int r = i / CH, c = (i % CH) * 8;
      if (r0 + r < S && c < D)
        *reinterpret_cast<uint4*>(dst + (int64_t)(r0 + r) * ss + c) =
            *reinterpret_cast<const uint4*>(src + r * LD + c);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < DM / 2; ++it) {
      const int i = lane + it * 32;
      const int r = i / DM, c = i % DM;
      if (r0 + r < S && c < D)
        dst[(int64_t)(r0 + r) * ss + c] = src[r * LD + c];
    }
  }
}

// A warp's 16 x DM accumulator rounded to bf16 into its 16 rows of a
// shared tile (rows of DM + kPad elements).
template <int DM>
__device__ __forceinline__ void acc_to_smem(bf16* t,
                                            const float (&acc)[DM / 8][4],
                                            int g, int t4) {
  constexpr int LD = DM + kPad;
#pragma unroll
  for (int n = 0; n < DM / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(t + (g + 8 * r) * LD + n * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
}

template <int DM, bool ASYNC>
__global__ void __launch_bounds__(kThreads, DM == 128 ? 2 : 3)
flash_fwd_tc_kernel(const Params p) {
  constexpr int LD = DM + kPad;
  constexpr int KC = DM / 16;      // k chunks of q~ k^T
  constexpr int NT = kTcKeys / 8;  // score n-tiles a warp: 32 values a lane
  constexpr int ND = DM / 8;       // output n-tiles
  static_assert(NT * 4 == 32, "one validity bit per score of a lane");
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  // K, V and the keys' validity (key mask and sequence end, one bit a
  // key): kStages buffers each
  bf16* Ks = Qs + kTcRows * LD;
  bf16* Vs = Ks + kStages * kTcKeys * LD;
  uint32_t* Mw = reinterpret_cast<uint32_t*>(Vs + kStages * kTcKeys * LD);

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // the last q tiles (the longest causal loops) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  int n_kt = (p.Sk + kTcKeys - 1) / kTcKeys;
  if (p.causal) n_kt = min(n_kt, (min(q0 + kTcRows, p.Sq) - 1) / kTcKeys + 1);

  auto issue = [&](int kt) {
    const int buf = kt % kStages, k0 = kt * kTcKeys;
    load_rows<kTcKeys, DM, ASYNC>(Ks + buf * kTcKeys * LD, kg, p.k_ss, k0,
                                  p.Sk, p.D);
    load_rows<kTcKeys, DM, ASYNC>(Vs + buf * kTcKeys * LD, vg, p.v_ss, k0,
                                  p.Sk, p.D);
    if (warp < kTcKeys / 32) {
      const int kpos = k0 + tid;
      const uint32_t bits = __ballot_sync(
          0xffffffffu,
          kpos < p.Sk &&
              (p.mask == nullptr || p.mask[(int64_t)b * p.Sk + kpos] != 0));
      if (lane == 0) Mw[buf * (kTcKeys / 32) + warp] = bits;
    }
  };
  // one commit group a tile (the first with q): tile kt lands once at
  // most kStages - 1 later groups are pending
  load_rows<kTcRows, DM, ASYNC>(Qs, qg, p.q_ss, q0, p.Sq, p.D);
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_kt) issue(kt);
    cp_async_commit();
  }

  const int row0 = q0 + warp * 16;  // this warp's first row
  const int row = row0 + g;         // this lane's rows: row, row + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qf[KC][4];

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + kStages - 1 < n_kt) issue(kt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (kt == 0) {
      prescale_rows<kTcRows, DM>(Qs, p.scale);
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qf[kc], a_addr<LD>(Qs, warp * 16, kc * 16, lane));
    }
    const int buf = kt % kStages, k0 = kt * kTcKeys;
    const bf16* Kb = Ks + buf * kTcKeys * LD;
    const bf16* Vb = Vs + buf * kTcKeys * LD;
    const uint32_t kbits[2] = {Mw[buf * 2], Mw[buf * 2 + 1]};

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t r[4];
        ldsm_x4(r, bn_addr<LD>(Kb, j * 16, kc * 16, lane));
        mma_bf16(s[2 * j], qf[kc], r[0], r[1]);
        mma_bf16(s[2 * j + 1], qf[kc], r[2], r[3]);
      }

    // The base-2 online softmax over rows row and row + 8, with the mask
    // applied only to tiles that hold a masked key or cross this warp's
    // diagonal (as _needs_mask): masked scores are -1e30 and their p 0.
    auto softmax = [&](auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
      uint32_t valid = 0xffffffffu;
      if constexpr (MASKED) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n * 8 + 2 * t4 + (i & 1);
            const bool ok = (kbits[col >> 5] >> (col & 31)) & 1u &&
                            (!p.causal || k0 + col <= row + (i >> 1) * 8);
            if (!ok) {
              valid &= ~(1u << (n * 4 + i));
              s[n][i] = kNeg;
            }
          }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];
      // p in fp32; l sums it before the cast to bf16 (the pack below, or
      // the dropout's rounding) and before dropout
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pr = exp2_ftz(s[n][i] - m[i >> 1]);
          if constexpr (MASKED) pr = (valid >> (n * 4 + i)) & 1u ? pr : 0.f;
          l[i >> 1] += pr;
          s[n][i] = pr;
        }
    };
    if ((kbits[0] & kbits[1]) != 0xffffffffu ||
        (p.causal && k0 + kTcKeys - 1 > row0))
      softmax(std::true_type());
    else
      softmax(std::false_type());
    if (p.dropout) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + n * 8 + 2 * t4 + (i & 1);
          const bool keep =
              hash_keep((uint32_t)(row + (i >> 1) * 8), (uint32_t)kpos,
                        (uint32_t)bh, p.seed_lo, p.seed_hi, p.thresh);
          s[n][i] = keep ? Io<bf16>::round(Io<bf16>::round(s[n][i]) *
                                           p.drop_scale)
                         : 0.f;
        }
    }

    // acc += p . v: the score accumulator, packed to bf16, is P's A
    // operand
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, bk_addr<LD>(Vb, kk * 16, j * 16, lane));
        mma_bf16(acc[2 * j], pa, r[0], r[1]);
        mma_bf16(acc[2 * j + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }

  // o = acc / l (0 on fully masked rows) through this warp's own rows of
  // the q tile, out in 16-byte rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        acc[n][2 * r + c] = l[r] > 0.f ? acc[n][2 * r + c] / l[r] : 0.f;
    const int qpos = row + r * 8;
    if (t4 == 0 && qpos < p.Sq)
      p.lse[(int64_t)bh * p.Sq + qpos] =
          l[r] > 0.f ? m[r] + log2f(l[r]) : INFINITY;
  }
  bf16* Qw = Qs + warp * 16 * LD;
  acc_to_smem<DM>(Qw, acc, g, t4);
  __syncwarp();
  store_rows16<DM>(static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh,
                   p.o_ss, Qw, row0, p.Sq, p.D, p.o_rows16, lane);
}

template <int DM, bool ASYNC>
cudaError_t launch_fwd_tc(const Params& p, int BH, cudaStream_t stream) {
  constexpr int smem = fwd_tc_smem_bytes<DM>();
  auto kernel = flash_fwd_tc_kernel<DM, ASYNC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid;
  const cudaError_t g = tile_grid(BH, p.Sq, kTcRows, &grid);
  if (g != cudaSuccess) return g;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <int DM>
cudaError_t launch_fwd_tc(const Params& p, int BH, cudaStream_t stream) {
  return p.async_rows ? launch_fwd_tc<DM, true>(p, BH, stream)
                      : launch_fwd_tc<DM, false>(p, BH, stream);
}

template <int DM>
constexpr int dkv_tc_smem_bytes() {
  return (2 * kTcRows + 2 * kStages * kTcQRows) * (DM + kPad) * 2 +
         2 * kStages * kTcQRows * 4;
}

template <int DM, bool ASYNC>
__global__ void __launch_bounds__(kThreads, DM == 128 ? 2 : 3)
flash_dkv_tc_kernel(const BwdParams p) {
  constexpr int LD = DM + kPad;
  constexpr int BQ = kTcQRows;
  constexpr int KC = DM / 16;  // k chunks of K q~^T and V do^T
  constexpr int NT = BQ / 8;   // n-tiles of S^T, dP^T
  constexpr int ND = DM / 8;   // n-tiles of dk, dv
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // this block's keys
  bf16* Vs = Ks + kTcRows * LD;
  // q (prescaled once landed), do, lse and delta: kStages buffers each
  bf16* Qs = Vs + kTcRows * LD;
  bf16* Os = Qs + kStages * BQ * LD;
  float* Ls = reinterpret_cast<float*>(Os + kStages * BQ * LD);
  float* Ds = Ls + kStages * BQ;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* qg = at<bf16>(p.q, p, kQ, b, h);
  const bf16* og = at<bf16>(p.dout, p, kDO, b, h);

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? k0 / BQ : 0;  // earlier q tiles see no key here
  auto issue = [&](int qt) {
    const int buf = (qt - qt0) % kStages, q0 = qt * BQ;
    load_rows<BQ, DM, ASYNC>(Qs + buf * BQ * LD, qg, p.st[kQ][2], q0, p.Sq,
                             p.D);
    load_rows<BQ, DM, ASYNC>(Os + buf * BQ * LD, og, p.st[kDO][2], q0, p.Sq,
                             p.D);
    if (tid < BQ) {
      const int qpos = q0 + tid;
      const bool in = qpos < p.Sq;
      Ls[buf * BQ + tid] = in ? p.lse[(int64_t)bh * p.Sq + qpos] : INFINITY;
      Ds[buf * BQ + tid] = in ? p.delta[(int64_t)bh * p.Sq + qpos] : 0.f;
    }
  };
  load_rows<kTcRows, DM, ASYNC>(Ks, at<bf16>(p.k, p, kK, b, h), p.st[kK][2],
                                k0, p.Sk, p.D);
  load_rows<kTcRows, DM, ASYNC>(Vs, at<bf16>(p.v, p, kV, b, h), p.st[kV][2],
                                k0, p.Sk, p.D);
  // one commit group a q tile (the first with K and V)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (qt0 + i < n_qt) issue(qt0 + i);
    cp_async_commit();
  }

  const int key0 = k0 + warp * 16;  // this warp's first key
  const int key = key0 + g;         // this lane's keys: key, key + 8
  bool kvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key + r * 8;
    kvalid[r] = kpos < p.Sk &&
                (p.mask == nullptr || p.mask[(int64_t)b * p.Sk + kpos] != 0);
  }
  const bool keys_valid = __all_sync(0xffffffffu, kvalid[0] && kvalid[1]);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    if (qt + kStages - 1 < n_qt) issue(qt + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int buf = (qt - qt0) % kStages, q0 = qt * BQ;
    bf16* Qb = Qs + buf * BQ * LD;
    const bf16* Ob = Os + buf * BQ * LD;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;
    prescale_rows<BQ, DM>(Qb, p.scale);
    __syncthreads();

    float st[NT][4], dpt[NT][4];  // S^T and dP^T: keys x q rows
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<LD>(Ks, warp * 16, kc * 16, lane));
      ldsm_x4(va, a_addr<LD>(Vs, warp * 16, kc * 16, lane));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t r[4];
        ldsm_x4(r, bn_addr<LD>(Qb, j * 16, kc * 16, lane));
        mma_bf16(st[2 * j], ka, r[0], r[1]);
        mma_bf16(st[2 * j + 1], ka, r[2], r[3]);
        ldsm_x4(r, bn_addr<LD>(Ob, j * 16, kc * 16, lane));
        mma_bf16(dpt[2 * j], va, r[0], r[1]);
        mma_bf16(dpt[2 * j + 1], va, r[2], r[3]);
      }
    }

    // p_drop^T into st, ds^T into dpt, in fp32 (the packs below round
    // them to bf16); the mask only where a key is masked, a row is past
    // the sequence end or the tile crosses this warp's diagonal
    auto grads = [&](auto masked) {
      constexpr bool MASKED = decltype(masked)::value;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = n * 8 + 2 * t4 + (i & 1), qpos = q0 + qc;
          const int kpos = key + (i >> 1) * 8;
          float pr = exp2_ftz(st[n][i] - Lb[qc]);
          if constexpr (MASKED)
            pr = kvalid[i >> 1] && qpos < p.Sq && (!p.causal || kpos <= qpos)
                     ? pr
                     : 0.f;
          float pd = pr, dpr = dpt[n][i];
          if (p.dropout) {
            const bool keep = hash_keep((uint32_t)qpos, (uint32_t)kpos,
                                        (uint32_t)bh, p.seed_lo, p.seed_hi,
                                        p.thresh);
            pd = keep ? Io<bf16>::round(Io<bf16>::round(pr) * p.drop_scale)
                      : 0.f;
            dpr = keep ? dpr / p.keep_prob : 0.f;
          }
          st[n][i] = pd;
          dpt[n][i] = pr * (dpr - Db[qc]);
        }
    };
    if (!keys_valid || q0 + BQ > p.Sq || (p.causal && key0 + 15 > q0))
      grads(std::true_type());
    else
      grads(std::false_type());

    // dv += p_drop^T . do, dk += ds^T . q~
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < ND / 2; ++j) {
        uint32_t r[4];
        ldsm_x4_t(r, bk_addr<LD>(Ob, kk * 16, j * 16, lane));
        mma_bf16(dv[2 * j], pa, r[0], r[1]);
        mma_bf16(dv[2 * j + 1], pa, r[2], r[3]);
        ldsm_x4_t(r, bk_addr<LD>(Qb, kk * 16, j * 16, lane));
        mma_bf16(dk[2 * j], sa, r[0], r[1]);
        mma_bf16(dk[2 * j + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();  // the K, V copies, where no q tile sees these keys
  __syncthreads();

  // dk rounded once, times ln 2, rounded again; both out through this
  // warp's own rows of the K and V tiles, in 16-byte rows
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = Io<bf16>::round(dk[n][i]) * kLn2;
  bf16* Kw = Ks + warp * 16 * LD;
  bf16* Vw = Vs + warp * 16 * LD;
  acc_to_smem<DM>(Kw, dk, g, t4);
  acc_to_smem<DM>(Vw, dv, g, t4);
  __syncwarp();
  store_rows16<DM>(at_out<bf16>(p.dk, p, kDK, b, h), p.st[kDK][2], Kw, key0,
                   p.Sk, p.D, p.out_rows16, lane);
  store_rows16<DM>(at_out<bf16>(p.dv, p, kDV, b, h), p.st[kDV][2], Vw, key0,
                   p.Sk, p.D, p.out_rows16, lane);
}

template <int DM, bool ASYNC>
cudaError_t launch_dkv_tc(const BwdParams& p, int BH, cudaStream_t stream) {
  constexpr int smem = dkv_tc_smem_bytes<DM>();
  auto kernel = flash_dkv_tc_kernel<DM, ASYNC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid;
  const cudaError_t g = tile_grid(BH, p.Sk, kTcRows, &grid);
  if (g != cudaSuccess) return g;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <int DM>
cudaError_t launch_dkv_tc(const BwdParams& p, int BH, cudaStream_t stream) {
  return p.async_rows ? launch_dkv_tc<DM, true>(p, BH, stream)
                      : launch_dkv_tc<DM, false>(p, BH, stream);
}

// -- dispatch: bf16 forward and dk/dv on the tensor cores -------------------

template <typename T>
cudaError_t dispatch_d(const Params& p, int BH, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.D <= 32) return launch_fwd_tc<32>(p, BH, stream);
    if (p.D <= 64) return launch_fwd_tc<64>(p, BH, stream);
    if (p.D <= 128) return launch_fwd_tc<128>(p, BH, stream);
  } else {
    if (p.D <= 32) return launch<T, 32>(p, BH, stream);
    if (p.D <= 64) return launch<T, 64>(p, BH, stream);
    if (p.D <= 128) return launch<T, 128>(p, BH, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool DQ>
cudaError_t dispatch_bwd(const BwdParams& p, int BH, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && !DQ) {
    if (p.D <= 32) return launch_dkv_tc<32>(p, BH, stream);
    if (p.D <= 64) return launch_dkv_tc<64>(p, BH, stream);
    if (p.D <= 128) return launch_dkv_tc<128>(p, BH, stream);
  } else {
    if (p.D <= 32) return launch_bwd<T, 32, DQ>(p, BH, stream);
    if (p.D <= 64) return launch_bwd<T, 64, DQ>(p, BH, stream);
    if (p.D <= 128) return launch_bwd<T, 128, DQ>(p, BH, stream);
  }
  return cudaErrorInvalidValue;
}

// Rows of a (batch, head, seq) slab of bf16 all start on 16-byte
// boundaries (with D % 8 == 0 they take whole 16-byte copies).
inline bool rows_aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         sh % 8 == 0 && ss % 8 == 0;
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
  const void* in[4] = {q, k, v, dout};
  p.async_rows = dtype == kBF16 && D % 8 == 0;
  for (int i = 0; i < 4; ++i)
    p.async_rows = p.async_rows &&
                   rows_aligned(in[i], p.st[i][0], p.st[i][1], p.st[i][2]);
  p.out_rows16 = D % 8 == 0 && rows_aligned(dk, p.st[kDK][0], p.st[kDK][1],
                                            p.st[kDK][2]) &&
                 rows_aligned(dv, p.st[kDV][0], p.st[kDV][1], p.st[kDV][2]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype != kF32
                            ? dispatch_bwd<bf16, DQ>(p, B * H, s)
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
// (B, Sk) int32 contiguous or null. dtype: 0 fp32, 1 bf16; q, k, v, o
// alike. bf16 tiles go by cp.async where every row of q, k and v starts
// on a 16-byte boundary and D % 8 == 0, by element loads otherwise.
// scale = softmax_scale * log2(e). Launches on `stream` and returns the
// launch's CUDA error (0 on success; cudaErrorInvalidConfiguration when
// the q tiles pass the grid's 65535).
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
  p.async_rows = dtype == kBF16 && D % 8 == 0 &&
                 rows_aligned(q, q_sb, q_sh, q_ss) &&
                 rows_aligned(k, k_sb, k_sh, k_ss) &&
                 rows_aligned(v, v_sb, v_sh, v_ss);
  p.o_rows16 = D % 8 == 0 && rows_aligned(o, o_sb, o_sh, o_ss);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype != kF32 ? dispatch_d<bf16>(p, B * H, s)
                                      : dispatch_d<float>(p, B * H, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Backward, one entry per kernel. q, k, v, do: (B, H, S, D) read
// through element strides; dq (dq entry) or dk, dv (dk/dv entry):
// (B, H, S, D) written through strides. strides: 21 values, (batch,
// head, seq) for q, k, v, do, dq, dk, dv in that order. lse, delta:
// (B*H, Sq) fp32 contiguous. dtype and the load variant as for the
// forward, over q, k, v and do. scale = softmax_scale * log2(e) (the q
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
