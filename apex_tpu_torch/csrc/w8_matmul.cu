// Weight-only int8 matmuls with the dequantization fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/quant/kernels.py:
//   _w8_matmul_kernel         y = x (M, K) @ (float(wq (K, N)) * scale (N,)) + bias
//   _w8_matmul_nobias_kernel  the same without the bias
//   _w8_matmul_nk_kernel      y = x (M, K) @ (float(wq (N, K)) * scale (N,)^T)^T
// Same contract: the int8 weights and fp32 per-output-channel scales
// stand for fp32 weights float(q) * s, the products are taken against x
// (fp32 or bf16) and accumulated in fp32, the bias (fp32 or bf16) added
// in fp32, and the sum rounded once to the output dtype (fp32 or bf16).
// Device memory sees only the int8 weights, the scales, x and y.
//
// What bounds it on an H100. Decode (M = the slot count, 8): bytes, the
// int8 weight read (3.1 MB for GPT-2 medium's qkv, 51.5 MB for the tied
// word table), a few operations per byte. Prefill (M = 128..1024):
// operations, 2 M K N of them, on the bf16 tensor cores for bf16 x.
//
// Design. The regime follows M, x's dtype and the layout alone; the
// Pallas block structure (whole M, whole K, N tiles) is not carried over:
// - M <= 8, KN layout, x fp32 or bf16 (w8_gemv_kn): one launch. A thread
//   owns 4 neighbouring columns (one 4-byte load a weight row) and a run
//   of R = 16 rows of K (8 where that gives fewer than 128 blocks); the 8
//   warps of a block take 8 runs of the same 128 columns, and the grid
//   splits K in chunks of 8 R rows. Every thread issues its R loads
//   before any arithmetic, so the whole matrix is in flight at once. x is
//   staged in shared memory as fp32 and read as a broadcast. Each weight
//   is dequantized (q * s, one fp32 rounding) and multiplied into x in
//   fp32. The warps' runs are summed in warp order through shared memory;
//   then each block writes its K part, and the last block of a column
//   strip to arrive (an integer counter after __threadfence) sums the
//   strip's parts in part order, adds the bias and casts. The counters
//   live in a zeroed buffer the caller keeps; the last block sets its
//   counter back to 0, so every launch (and every CUDA-graph replay)
//   finds them zero. No float atomics: two launches give the same bits.
// - M > 8, KN layout, bf16 x (w8_mma): mma.sync.m16n8k16 on the tensor
//   cores, bf16 operands and fp32 accumulators. A bf16 x times an int8 q
//   (|q| <= 127) is exact in fp32, and the per-channel scale factors out
//   of the k-sum: y = s_n * sum_k x_k q_kn, the sum in fp32, then one
//   fp32 multiply by s_n, the bias added in fp32, one cast. A block owns
//   a 64 x 64 output tile (4 warps, 32 x 32 each) and walks K in steps
//   of 64 through a 3-deep ring of 16-byte cp.async copies: x into padded
//   bf16 rows read by ldmatrix (the A operand); the int8 weights stay
//   int8 in shared memory (half the bytes of a bf16 tile, and no second
//   pass through it), are read by ldmatrix.trans as 16-bit pairs, and
//   each pair of a k-adjacent int8 is widened in registers to the bf16x2
//   B operand (exact; integer and fp32 add instructions, no conversion
//   instructions, which issue at a quarter of the ALU rate). The pairs
//   give even and odd columns as separate n8 tiles, so a lane's
//   accumulators hold four neighbouring columns, stored together.
//   Element loads and zero fill stand in for the copies where K is not a
//   multiple of 8, N not of 16, or x or wq does not start 16-byte
//   aligned. Where the grid would hold fewer tiles than SMs, K is split,
//   each part written to scratch, and the last block of a tile to arrive
//   sums the parts in part order, as in the gemv.
// - M <= 8, NK layout, bf16 x (w8_mma_nk, the tied logits head): the
//   same tensor-core product with the operands swapped, y^T = Wq . x^T:
//   16 output channels are the A rows, x's rows (zeros past M) the 8 B
//   columns, so an int8 row, already K-contiguous, is A's row-major
//   layout. The k order inside an m16n8k16 step is free as long as A and
//   B share it, so each lane reads 16 contiguous bytes of each of its two
//   rows (coalesced 16-byte loads, a stage of four ahead of their use),
//   widens them in registers as w8_mma does (bytes (0, 1) and (2, 3) of a
//   word as the pairs of one step), and takes x's bf16 pairs at the same
//   k from a copy staged once a block in shared memory. y = s_n * sum_k
//   x_k q_nk, one cast. K (1024) is not split: the 3144 tiles of the
//   (50304, 1024) word table fill the card, so there are no parts, no
//   counters and no scratch. A block of 8 warps takes a contiguous run
//   of tiles, two blocks an SM.
// - fp32 x at M > 8 and the NK layout at M > 8 keep the CUDA-core tile,
//   and the NK layout at M <= 8 with an fp32 x (or a K whose staged x
//   would pass 48 KB) the CUDA-core gemv: w8_tiled (a 64 x 128 fp32 tile
//   per block, 4 x 8 outputs a thread, K parts summed by w8_reduce in a
//   fixed order; an fp32 x is not exact in bf16, and TF32 operands would
//   break the error model) and w8_gemv_nk (a thread owns one output
//   channel and reads its K-contiguous row in 16-byte loads, eight in
//   flight; x staged in shared memory 512 columns at a time, read as a
//   broadcast).
// Loads are vectorised where the row length and the base address allow
// it, byte by byte else, so any M, K and N is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSmallM = 8;  // rows of the gemv regime
// w8_gemv_kn
constexpr int kGvCols = 4;                    // columns a thread
constexpr int kGvWarps = 8;
constexpr int kGvThreads = 32 * kGvWarps;
constexpr int kGvBlockN = 32 * kGvCols;       // 128 columns a block
constexpr int kGvMinBlocks = 128;             // R is halved (16 to 8) below this
// w8_gemv_nk (fp32 x)
constexpr int kNkThreads = 128;
constexpr int kNkChunk = 512;
constexpr int kNkVec = 8;
// w8_mma_nk (bf16 x): a warp a 16-channel tile at a time, each lane 16
// bytes of each of its two rows a 64-wide chunk of K, four chunks (256
// bytes of a row) a stage, two stages in registers
constexpr int kNcWarps = 8;
constexpr int kNcThreads = 32 * kNcWarps;
constexpr int kNcBlocksPerSm = 2;
constexpr int kNcChunks = 4;
constexpr int kNcStageK = 64 * kNcChunks;
// x staged as kSmallM bf16 rows of K rounded up to 16, plus 8 (the pad
// that puts a lane pair's rows in different banks), in the default 48 KB
constexpr int kNcMaxK = (49152 / (2 * kSmallM) - 8) / 16 * 16;
// w8_tiled (fp32 CUDA cores)
constexpr int BM = 64, BN = 128, BK = 16, kTileThreads = 256;
// w8_mma (bf16 tensor cores): K steps of 64
constexpr int kTcBK = 64;
constexpr int kTcMinSteps = 4;      // K steps a part keeps, at least

// The tile: 64 x 64 outputs a block of four warps (2 x 2, each 32 x 32:
// two m16 tiles by four n8 tiles, its columns one run of 32), a 3-deep
// copy ring, four blocks an SM. Of the shapes tried on the H100 (64-256
// rows by 64-256 columns, K steps of 32 or 64, 2-6 stages) the fastest
// at the prefill buckets up to M 512; at M 1024 taller tiles took up to
// 30 % less time at N 3072 and 4096 and more at N 1024.
constexpr int kTcBM = 64, kTcBN = 64, kTcWN = 2, kTcStages = 3;
constexpr int kTcThreads = 128, kTcMinBlocks = 4;
constexpr int kTcMT = 2, kTcNT = 4;          // m16 and n8 tiles a warp
constexpr int kTcLdA = kTcBK + 8;            // bf16 a padded x row
constexpr int kTcLdW = kTcBN + 16;           // bytes a padded int8 row
constexpr int kTcSmemA = kTcBM * kTcLdA * 2;  // one x step, bytes
constexpr int kTcSmemW = kTcBK * kTcLdW;      // one int8 weight step
constexpr int kTcSmem = kTcStages * (kTcSmemA + kTcSmemW);
constexpr int kTcXCopies = kTcBM * (kTcBK / 8) / kTcThreads;
constexpr int kTcWCopies = kTcBK * (kTcBN / 16) / kTcThreads;
static_assert(kTcMT * 16 * (kTcThreads / 32 / kTcWN) == kTcBM &&
                  kTcNT * 8 * kTcWN == kTcBN && kTcNT % 4 == 0,
              "whole mma tiles a warp, its columns in runs of 32");
static_assert(kTcXCopies * kTcThreads == kTcBM * (kTcBK / 8) &&
                  kTcWCopies * kTcThreads == kTcBK * (kTcBN / 16),
              "whole 16-byte copies a thread");
static_assert(kTcSmem <= 48 * 1024, "the default dynamic shared memory");

constexpr int kSms = 132;

typedef __nv_bfloat16 bf16;

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

// Byte c of a word of four int8 values as an fp32 value, exactly and
// without a conversion instruction (those issue at a quarter of the
// ALUs' rate): wx is the word with every byte's sign bit flipped (w ^
// 0x80808080), so byte c is q + 128; placed under the exponent of 2^23
// it reads 2^23 + q + 128, and one subtraction leaves q.
__device__ __forceinline__ float s8f(uint32_t wx, int c) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540u | c)) -
         8388736.f;
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

// Four bytes at row[0..4), the ones at or past `valid` read as 0.
__device__ __forceinline__ uint32_t load4(const int8_t* row, int valid,
                                          bool vec) {
  if (vec && valid >= 4) return *reinterpret_cast<const uint32_t*>(row);
  uint32_t w = 0u;
  for (int c = 0; c < 4 && c < valid; ++c)
    w |= static_cast<uint32_t>(static_cast<uint8_t>(row[c])) << (8 * c);
  return w;
}

// The last block to arrive at counters[slot] of `parts` blocks: true in
// every thread of that block only. Each block has written its part
// before the call; the fence makes the parts visible to the last one,
// which sets the counter back to 0 for the next launch.
__device__ __forceinline__ bool last_to_arrive(int* counters, int slot,
                                               int parts) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&counters[slot], 1) == parts - 1;
    if (last) counters[slot] = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// M <= 8, KN layout: one launch. Block (strip, part) covers the strip's
// 128 columns over rows [part * 8R, (part + 1) * 8R) of K; warp w the
// run of R rows from part * 8R + w R, lane l the columns 4l .. 4l + 3.
// partial: (parts, M, strips * 128) fp32, used when gridDim.y > 1.
template <int R>
__global__ void __launch_bounds__(kGvThreads)
w8_gemv_kn(const void* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, const void* __restrict__ bias,
           void* __restrict__ out, float* __restrict__ partial,
           int* __restrict__ counters, int M, int K, int N, int vec,
           int x_bf16, int out_bf16, int bias_code) {
  constexpr int CHUNK = kGvWarps * R;  // rows of K a block
  __shared__ __align__(16) float xs[CHUNK][kSmallM];
  __shared__ __align__(16) float red[kGvWarps][kSmallM][kGvBlockN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.y, parts = gridDim.y;
  const int k0 = part * CHUNK, nb = blockIdx.x * kGvBlockN;
  const int n0 = nb + lane * kGvCols;
  // the weights first: every load in flight before any arithmetic
  const int kb = k0 + warp * R;
  uint32_t w[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int k = kb + j;
    w[j] = (k < K && n0 < N)
               ? load4(wq + static_cast<int64_t>(k) * N + n0, N - n0, vec)
               : 0u;
  }
  float sc[kGvCols];
#pragma unroll
  for (int c = 0; c < kGvCols; ++c)
    sc[c] = n0 + c < N ? scale[n0 + c] : 0.f;
  for (int i = tid; i < CHUNK * kSmallM; i += kGvThreads) {
    const int kk = i % CHUNK, m = i / CHUNK, k = k0 + kk;
    xs[kk][m] =
        (m < M && k < K) ? ld_x(x, static_cast<int64_t>(m) * K + k, x_bf16)
                         : 0.f;
  }
  __syncthreads();
  float acc[kSmallM][kGvCols];
#pragma unroll
  for (int m = 0; m < kSmallM; ++m)
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) acc[m][c] = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int kk = warp * R + j;
    const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
    const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
    const float xv[kSmallM] = {xa.x, xa.y, xa.z, xa.w,
                               xb.x, xb.y, xb.z, xb.w};
    const uint32_t wx = w[j] ^ 0x80808080u;
#pragma unroll
    for (int c = 0; c < kGvCols; ++c) {
      const float wv = __fmul_rn(s8f(wx, c), sc[c]);
#pragma unroll
      for (int m = 0; m < kSmallM; ++m)
        acc[m][c] = fmaf(xv[m], wv, acc[m][c]);
    }
  }
#pragma unroll
  for (int m = 0; m < kSmallM; ++m)
    if (m < M)
      *reinterpret_cast<float4*>(&red[warp][m][lane * kGvCols]) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  // from here thread (m, g) owns row m, columns 4g .. 4g + 3 of the strip
  const int m = tid >> 5, c4 = lane * kGvCols, n = nb + c4;
  const bool live = m < M;
  float v[kGvCols] = {0.f, 0.f, 0.f, 0.f};
  if (live) {  // the warps' runs, in warp order
    float4 s = *reinterpret_cast<const float4*>(&red[0][m][c4]);
#pragma unroll
    for (int i = 1; i < kGvWarps; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(&red[i][m][c4]);
      s = make_float4(__fadd_rn(s.x, t.x), __fadd_rn(s.y, t.y),
                      __fadd_rn(s.z, t.z), __fadd_rn(s.w, t.w));
    }
    v[0] = s.x, v[1] = s.y, v[2] = s.z, v[3] = s.w;
  }
  if (parts > 1) {
    const int64_t ld = static_cast<int64_t>(gridDim.x) * kGvBlockN;
    const int64_t at = static_cast<int64_t>(m) * ld + n;
    if (live)
      *reinterpret_cast<float4*>(partial + part * M * ld + at) =
          make_float4(v[0], v[1], v[2], v[3]);
    if (!last_to_arrive(counters, blockIdx.x, parts) || !live) return;
    float4 s = __ldcg(reinterpret_cast<const float4*>(partial + at));
#pragma unroll 8
    for (int p = 1; p < parts; ++p) {
      const float4 t =
          __ldcg(reinterpret_cast<const float4*>(partial + p * M * ld + at));
      s = make_float4(__fadd_rn(s.x, t.x), __fadd_rn(s.y, t.y),
                      __fadd_rn(s.z, t.z), __fadd_rn(s.w, t.w));
    }
    v[0] = s.x, v[1] = s.y, v[2] = s.z, v[3] = s.w;
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < kGvCols; ++c)
    if (n + c < N)
      store_out(out, static_cast<int64_t>(m) * N + n + c,
                add_bias(v[c], bias, n + c, bias_code), out_bf16);
}

// -- tensor-core building blocks (as in flash_attention.cu) ------------------

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

// Address of this lane's row for an x4 ldmatrix of a 16 x 16 slice at
// (row0, col0) of a shared tile with rows of LD elements. A operand (row
// major, m x k): matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7,
// 8-15), (8-15, 8-15).
template <int LD>
__device__ __forceinline__ uint32_t a_addr(const bf16* t, int row0, int col0,
                                           int lane) {
  return smem_addr(t + (row0 + (lane & 15)) * LD + col0 + (lane >> 4) * 8);
}


// Two int8 weights, bytes c and c + 2 of a word of an ldmatrix.trans
// fragment (wx: the word with every sign bit flipped), as the bf16x2 B
// operand register (k, k + 1): each exact in fp32 (s8f), whose low 16
// bits are then 0, so the high halves are the bf16 values.
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t wx, int c) {
  return __byte_perm(__float_as_uint(s8f(wx, c)),
                     __float_as_uint(s8f(wx, c + 2)), 0x7632u);
}

// M > 8, KN layout, bf16 x, on the tensor cores. Block (x, y, z) owns
// output tile (rows kTcBM y.., columns kTcBN x..) over K steps [z * per,
// (z + 1) * per); warp w the sub-tile (w / kTcWN, w % kTcWN). The int8
// weight step stays int8 in shared memory (rows of kTcBN bytes, padded): an ldmatrix.x4.trans of its 16-bit pairs gives a
// lane, for k rows 2t, 2t + 1 (and + 8) of a 32-column run, the bytes
// of columns 2g and 2g + 1, so byte pairs (0, 2) are the B operand of the
// run's even columns and (1, 3) of its odd ones: its n8 tiles are (even
// 0-15, odd 0-15, even 16-31, odd 16-31), and lane t's two accumulator
// columns of the four tiles are the run's columns 4t .. 4t + 3 (stored
// together). ASYNC: 16-byte cp.async copies (K % 8 == 0, N % 16 == 0, x
// and wq 16-byte aligned), else element loads. partial: (parts, kTcBM
// gridDim.y, kTcBN gridDim.x) fp32, used when gridDim.z > 1; quad: N % 4
// == 0, so four neighbouring outputs go out in one store.
template <bool ASYNC>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
w8_mma(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
       const float* __restrict__ scale, const void* __restrict__ bias,
       void* __restrict__ out, float* __restrict__ partial,
       int* __restrict__ counters, int M, int K, int N, int per, int out_bf16,
       int bias_code, int quad) {
  constexpr int S = kTcStages, MT = kTcMT, NT = kTcNT;
  constexpr int LDA = kTcLdA, LDW = kTcLdW, BN = kTcBN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + S * kTcSmemA);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kTcWN, wn = warp % kTcWN;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * per;
  const int steps = min(per, cdiv(K, kTcBK) - kt0);

  auto load_step = [&](int kt, int slot) {
    const int kbase = kt * kTcBK;
    bf16* a = As + slot * (kTcSmemA / 2);
#pragma unroll
    for (int it = 0; it < kTcXCopies; ++it) {  // x: kTcBM rows x kTcBK / 8
      const int i = tid + it * kTcThreads;
      const int r = i / (kTcBK / 8), c = (i % (kTcBK / 8)) * 8;
      const int m = m0 + r, k = kbase + c;
      bf16* dst = a + r * LDA + c;
      if constexpr (ASYNC) {
        const bool in = m < M && k < K;
        cp_async16(smem_addr(dst), in ? x + static_cast<int64_t>(m) * K + k
                                      : x, in);
      } else {
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = m < M && k + e < K
                     ? reinterpret_cast<const uint16_t*>(
                           x)[static_cast<int64_t>(m) * K + k + e]
                     : 0u;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                       h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
#pragma unroll
    for (int it = 0; it < kTcWCopies; ++it) {  // w: kTcBK rows x kTcBN / 16
      const int i = tid + it * kTcThreads;
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const int k = kbase + r, n = n0 + c;
      int8_t* dst = Ws + slot * kTcSmemW + r * LDW + c;
      if constexpr (ASYNC) {
        const bool in = k < K && n < N;
        cp_async16(smem_addr(dst), in ? wq + static_cast<int64_t>(k) * N + n
                                      : wq, in);
      } else {
        uint32_t q[4] = {0u, 0u, 0u, 0u};
        if (k < K)
          for (int e = 0; e < 16 && n + e < N; ++e)
            q[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             wq[static_cast<int64_t>(k) * N + n + e]))
                         << (8 * (e & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load_step(kt0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    const int slot = i % S;
    cp_async_wait<S - 2>();  // this thread's copies of step i
    // step i visible to all; every warp is done with step i - 1, whose
    // ring slot the next copies take
    __syncthreads();
    if (i + S - 1 < steps) load_step(kt0 + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    const bf16* a = As + slot * (kTcSmemA / 2);
    const int8_t* w = Ws + slot * kTcSmemW;
#pragma unroll
    for (int kc = 0; kc < kTcBK / 16; ++kc) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], a_addr<LDA>(a, (wm * MT + mt) * 16, kc * 16, lane));
#pragma unroll
      for (int j = 0; j < NT / 4; ++j) {  // a run of 32 columns
        uint32_t r[4];
        ldsm_x4_t(r, smem_addr(w + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LDW +
                               (wn * NT / 4 + j) * 32 + (lane >> 4) * 16));
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns 16 h .. 16 h + 15
          const uint32_t lo = r[2 * h] ^ 0x80808080u;      // k 2t, 2t + 1
          const uint32_t hi = r[2 * h + 1] ^ 0x80808080u;  // k + 8
          bfr[4 * j + 2 * h][0] = s8x2_bf16(lo, 0);        // even columns
          bfr[4 * j + 2 * h][1] = s8x2_bf16(hi, 0);
          bfr[4 * j + 2 * h + 1][0] = s8x2_bf16(lo, 1);    // odd columns
          bfr[4 * j + 2 * h + 1][1] = s8x2_bf16(hi, 1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // lane (g, t): rows g and g + 8 of each m16 tile; of each run of 16
  // columns (an even and an odd n8 tile) the columns 4t .. 4t + 3:
  // (even c0, odd c0, even c1, odd c1) of the two accumulators
  const int g = lane >> 2, t4 = lane & 3;
  const int rb = m0 + wm * MT * 16 + g, cb = n0 + wn * NT * 8 + 4 * t4;
  auto quad_of = [&](int mt, int q, int h) {
    return make_float4(acc[mt][2 * q][2 * h], acc[mt][2 * q + 1][2 * h],
                       acc[mt][2 * q][2 * h + 1],
                       acc[mt][2 * q + 1][2 * h + 1]);
  };
  if (gridDim.z > 1) {
    const int64_t ld = static_cast<int64_t>(gridDim.x) * BN;
    const int64_t stride = static_cast<int64_t>(gridDim.y) * kTcBM * ld;
    float* mine = partial + blockIdx.z * stride;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < NT / 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rb + mt * 16 + 8 * h < M)  // rows past M stay unwritten
            *reinterpret_cast<float4*>(
                mine + (rb + mt * 16 + 8 * h) * ld + cb + q * 16) =
                quad_of(mt, q, h);
    if (!last_to_arrive(counters, blockIdx.y * gridDim.x + blockIdx.x,
                        gridDim.z))
      return;
    for (int p = 0; p < static_cast<int>(gridDim.z); ++p) {  // part order
      const float* src = partial + p * stride;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NT / 2; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rb + mt * 16 + 8 * h >= M) continue;
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                src + (rb + mt * 16 + 8 * h) * ld + cb + q * 16));
            float(&e0)[4] = acc[mt][2 * q];
            float(&e1)[4] = acc[mt][2 * q + 1];
            const bool first = p == 0;
            e0[2 * h] = first ? v.x : __fadd_rn(e0[2 * h], v.x);
            e1[2 * h] = first ? v.y : __fadd_rn(e1[2 * h], v.y);
            e0[2 * h + 1] = first ? v.z : __fadd_rn(e0[2 * h + 1], v.z);
            e1[2 * h + 1] = first ? v.w : __fadd_rn(e1[2 * h + 1], v.w);
          }
    }
  }
  // y = acc * s_n + b_n in fp32, one cast
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) {
    const int n = cb + q * 16;
    if (n >= N) continue;
    float sc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[c] = n + c < N ? scale[n + c] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rb + mt * 16 + 8 * h;
        if (m >= M) continue;
        const float4 a4 = quad_of(mt, q, h);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          y[c] = n + c < N ? add_bias(__fmul_rn(av[c], sc[c]), bias, n + c,
                                      bias_code)
                           : 0.f;
        const int64_t o = static_cast<int64_t>(m) * N + n;
        if (quad && out_bf16) {
          const __nv_bfloat162 p0 = __floats2bfloat162_rn(y[0], y[1]);
          const __nv_bfloat162 p1 = __floats2bfloat162_rn(y[2], y[3]);
          *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                         *reinterpret_cast<const uint32_t*>(&p1));
        } else if (quad) {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
              make_float4(y[0], y[1], y[2], y[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) store_out(out, o + c, y[c], out_bf16);
        }
      }
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

// Two int8 weights, bytes c and c + 1 of a word (wx: the word with every
// sign bit flipped), as one bf16x2 register, the lower k in the low half:
// each exact in fp32 (s8f), whose low 16 bits are then 0.
__device__ __forceinline__ uint32_t s8x2_bf16_next(uint32_t wx, int c) {
  return __byte_perm(__float_as_uint(s8f(wx, c)),
                     __float_as_uint(s8f(wx, c + 1)), 0x7632u);
}

// 16 bytes of a stream read once: no L1 allocation, and the L2 fetches
// the 256-byte block around them, which the stage's next loads of the row
// find there (2-4 % faster on the H100 than 32-byte fetches).
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// M <= 8, NK layout, bf16 x, on the tensor cores: y^T (N x M) = Wq (N x
// K) . x^T, with mma.m16n8k16 bf16 -> fp32, 16 output channels as the A
// rows and x's rows as the 8 B columns (rows past M read as zero). Block
// b owns the 16-channel tiles [b T / G, (b + 1) T / G) of the T tiles (G
// blocks, two an SM), its warp w the tiles w, w + 8, ... of that range.
// The k order inside a step is free as long as A and B share it: in each
// 64-wide chunk c of K, lane (g, t) reads 16 contiguous bytes of its rows
// g and g + 8, k = 64 c + 16 t .. + 15, and word j of them (k = 64 c +
// 16 t + 4 j .. + 3) gives its A registers of k16 step j: bytes (0, 1)
// as logical k (2t, 2t + 1), bytes (2, 3) as (2t + 8, 2t + 9). The B
// registers are the bf16 pairs of x at the same k, read from x staged
// once a block in shared memory. The int8 bytes are widened without a
// conversion instruction (s8f: a byte permute and one fp32 add, then a
// permute into bf16x2), the products are exact in fp32, and the scale is
// applied once to the sum: y = s_n * sum_k x_k q_nk. A stage is four
// chunks: its 8 loads a lane are issued a stage ahead of their use. VEC:
// K % 16 == 0 and wq 16-byte aligned (16-byte loads), else byte loads
// giving the same words; x_vec: x 16-byte aligned and K % 8 == 0.
template <bool VEC>
__global__ void __launch_bounds__(kNcThreads, kNcBlocksPerSm)
w8_mma_nk(const bf16* __restrict__ x, const int8_t* __restrict__ wq,
          const float* __restrict__ scale, void* __restrict__ out, int M,
          int K, int N, int x_vec, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
  const int k16 = cdiv(K, 16) * 16, ld = k16 + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = cdiv(N, 16);
  const int first =
      static_cast<int>(static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x);
  const int last = static_cast<int>(
      static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x);
  const int mine =
      last - first > warp ? cdiv(last - first - warp, kNcWarps) : 0;
  const int per = cdiv(K, kNcStageK);  // stages a tile
  const int stages = mine * per;

  auto load = [&](uint4 (&w)[2][kNcChunks], int s) {
    const int tile = first + warp + (s / per) * kNcWarps;
    const int kb = (s % per) * kNcStageK + 16 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = tile * 16 + g + 8 * r;
      const int8_t* row = wq + static_cast<int64_t>(n) * K;
#pragma unroll
      for (int c = 0; c < kNcChunks; ++c) {
        const int k = kb + 64 * c;
        if constexpr (VEC) {
          w[r][c] = n < N && k < K ? ld_stream16(row + k)
                                   : make_uint4(0u, 0u, 0u, 0u);
        } else {
          uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (n < N && k + e < K)
              q[e >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                               row[k + e])) << (8 * (e & 3));
          w[r][c] = make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
  };

  // two stages in registers: the next one's loads are in flight while
  // this one is computed
  uint4 wa[2][kNcChunks], wb[2][kNcChunks];
  if (stages > 0) load(wa, 0);
  // x into shared memory: rows past M and columns past K zero
  const uint16_t* xh = reinterpret_cast<const uint16_t*>(x);
  if (x_vec) {
    const int per_row = k16 / 8;
    for (int i = tid; i < kSmallM * per_row; i += kNcThreads) {
      const int m = i / per_row, k = (i % per_row) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K)
        v = *reinterpret_cast<const uint4*>(xh + static_cast<int64_t>(m) * K +
                                            k);
      *reinterpret_cast<uint4*>(xs + m * ld + k) = v;
    }
  } else {
    for (int i = tid; i < kSmallM * k16; i += kNcThreads) {
      const int m = i / k16, k = i % k16;
      xs[m * ld + k] =
          m < M && k < K ? xh[static_cast<int64_t>(m) * K + k] : 0u;
    }
  }
  __syncthreads();  // the block's only barrier: every warp reaches it

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float sc[2] = {0.f, 0.f};
  const uint16_t* xrow = xs + g * ld;
  auto compute = [&](const uint4 (&w)[2][kNcChunks], int s) {
    const int tile = first + warp + (s / per) * kNcWarps;
    const bool closes = s % per == per - 1;
    if (closes) {  // the tile's scales, ahead of the epilogue
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = tile * 16 + g + 8 * r;
        sc[r] = n < N ? __ldg(scale + n) : 0.f;
      }
    }
    const int kb = (s % per) * kNcStageK + 16 * t;
#pragma unroll
    for (int c = 0; c < kNcChunks; ++c) {
      const int k = kb + 64 * c;
      uint4 b0 = make_uint4(0u, 0u, 0u, 0u), b1 = b0;
      if (k < K) {
        b0 = *reinterpret_cast<const uint4*>(xrow + k);
        b1 = *reinterpret_cast<const uint4*>(xrow + k + 8);
      }
      const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w,
                              b1.x, b1.y, b1.z, b1.w};
      constexpr uint32_t f = 0x80808080u;  // every byte's sign bit
      const uint32_t lo[4] = {w[0][c].x ^ f, w[0][c].y ^ f, w[0][c].z ^ f,
                              w[0][c].w ^ f};
      const uint32_t hi[4] = {w[1][c].x ^ f, w[1][c].y ^ f, w[1][c].z ^ f,
                              w[1][c].w ^ f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a[4] = {s8x2_bf16_next(lo[j], 0),
                               s8x2_bf16_next(hi[j], 0),
                               s8x2_bf16_next(lo[j], 2),
                               s8x2_bf16_next(hi[j], 2)};
        mma_bf16(acc, a, bw[2 * j], bw[2 * j + 1]);
      }
    }
    if (!closes) return;
    // acc: rows g, g + 8 (channels), columns 2t, 2t + 1 (rows of x)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = tile * 16 + g + 8 * r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 2 * t + e;
        if (n < N && m < M)
          store_out(out, static_cast<int64_t>(m) * N + n,
                    __fmul_rn(acc[2 * r + e], sc[r]), out_bf16);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.f;
  };

  for (int s = 0; s < stages; s += 2) {
    if (s + 1 < stages) load(wb, s + 1);
    compute(wa, s);
    if (s + 2 < stages) load(wa, s + 2);
    if (s + 1 < stages) compute(wb, s + 1);
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

enum Kind { kGemvNk, kMmaNk, kGemvKn, kTiled, kMma };

// The card's SM count, read once a device.
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int n = kSms;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = kSms;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

struct Plan {
  Kind kind;
  dim3 grid;
  int splits;
  int per;        // w8_tiled, w8_mma: K steps a part; w8_gemv_kn: R
  long long work;  // fp32 scratch elements for the K parts
  int counters;   // arrival counters (w8_gemv_kn, w8_mma)
};

Plan plan(int M, int K, int N, bool nk, bool x_bf16) {
  if (M <= kSmallM && nk && x_bf16 && K <= kNcMaxK) {
    const int tiles = cdiv(N, 16), blocks = kNcBlocksPerSm * sm_count();
    return {kMmaNk, dim3(tiles < blocks ? tiles : blocks), 1, 0, 0, 0};
  }
  if (M <= kSmallM && nk)
    return {kGemvNk, dim3(cdiv(N, kNkThreads)), 1, 0, 0, 0};
  if (M <= kSmallM) {
    const int strips = cdiv(N, kGvBlockN);
    int r = 16;  // 32 rows a thread ran 1.7x slower in the H100 decode tick
    while (r > 8 && strips * cdiv(K, kGvWarps * r) < kGvMinBlocks) r /= 2;
    const int s = cdiv(K, kGvWarps * r);
    const long long work =
        s > 1 ? static_cast<long long>(s) * M * strips * kGvBlockN : 0;
    return {kGemvKn, dim3(strips, s), s, r, work, s > 1 ? strips : 0};
  }
  if (!nk && x_bf16) {
    const int tx = cdiv(N, kTcBN), ty = cdiv(M, kTcBM);
    const int kt = cdiv(K, kTcBK);
    int per = kt;
    if (tx * ty < kSms) {
      int want = cdiv(kSms, tx * ty);
      if (want > kt / kTcMinSteps) want = kt / kTcMinSteps;
      if (want < 1) want = 1;
      per = cdiv(kt, want);
    }
    const int s = cdiv(kt, per);
    const long long work = s > 1 ? static_cast<long long>(s) * ty * kTcBM *
                                       tx * kTcBN
                                 : 0;
    return {kMma, dim3(tx, ty, s), s, per, work, s > 1 ? tx * ty : 0};
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
  return {kTiled, dim3(cdiv(N, BN), cdiv(M, BM), s), s, per,
          s > 1 ? static_cast<long long>(s) * M * N : 0, 0};
}

int launch(const void* x, const void* wq, const void* scale,
           const void* bias, int bias_code, void* out, void* work,
           void* counters, int M, int K, int N, bool nk, int x_bf16,
           int out_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(M, K, N, nk, x_bf16 != 0);
  float* part = static_cast<float*>(work);
  int* cnt = static_cast<int*>(counters);
  if ((p.work > 0 && part == nullptr) || (p.counters > 0 && cnt == nullptr))
    return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(wq);
  switch (p.kind) {
    case kGemvNk: {
      const int vec = (K % 16 == 0) && (wp % 16 == 0);
      w8_gemv_nk<<<p.grid, kNkThreads, 0, st>>>(x, w, sc, out, M, K, N, vec,
                                                x_bf16, out_bf16);
      break;
    }
    case kMmaNk: {
      const int vec = K % 16 == 0 && wp % 16 == 0;
      const int xv = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
      const size_t bytes = 2 * kSmallM * (cdiv(K, 16) * 16 + 8);
      const bf16* xb = static_cast<const bf16*>(x);
      if (vec)
        w8_mma_nk<true><<<p.grid, kNcThreads, bytes, st>>>(
            xb, w, sc, out, M, K, N, xv, out_bf16);
      else
        w8_mma_nk<false><<<p.grid, kNcThreads, bytes, st>>>(
            xb, w, sc, out, M, K, N, xv, out_bf16);
      break;
    }
    case kGemvKn: {
      const int vec = (N % 4 == 0) && (wp % 4 == 0);
      if (p.per == 16)
        w8_gemv_kn<16><<<p.grid, kGvThreads, 0, st>>>(
            x, w, sc, bias, out, part, cnt, M, K, N, vec, x_bf16, out_bf16,
            bias_code);
      else
        w8_gemv_kn<8><<<p.grid, kGvThreads, 0, st>>>(
            x, w, sc, bias, out, part, cnt, M, K, N, vec, x_bf16, out_bf16,
            bias_code);
      break;
    }
    case kMma: {
      const bool async = K % 8 == 0 && N % 16 == 0 && wp % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0;
      const bf16* xb = static_cast<const bf16*>(x);
      if (async)
        w8_mma<true><<<p.grid, kTcThreads, kTcSmem, st>>>(
            xb, w, sc, bias, out, part, cnt, M, K, N, p.per, out_bf16,
            bias_code, N % 4 == 0);
      else
        w8_mma<false><<<p.grid, kTcThreads, kTcSmem, st>>>(
            xb, w, sc, bias, out, part, cnt, M, K, N, p.per, out_bf16,
            bias_code, N % 4 == 0);
      break;
    }
    case kTiled: {
      const int vec = (nk ? K % 8 == 0 : N % 8 == 0) && (wp % 8 == 0);
      if (nk)
        w8_tiled<true><<<p.grid, kTileThreads, 0, st>>>(
            x, w, sc, bias, out, part, M, K, N, p.per, vec, x_bf16, out_bf16,
            bias_code);
      else
        w8_tiled<false><<<p.grid, kTileThreads, 0, st>>>(
            x, w, sc, bias, out, part, M, K, N, p.per, vec, x_bf16, out_bf16,
            bias_code);
      break;
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.kind != kTiled || p.splits == 1)
    return static_cast<int>(err);
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
// weight layout, x_bf16 a bf16 x (the plan follows x's dtype).
long long apx_w8_workspace(int M, int K, int N, int nk, int x_bf16) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  return plan(M, K, N, nk != 0, x_bf16 != 0).work;
}

// int32 arrival counters the launch needs (0 where K is not split);
// they must be zero at the launch and are zero again after it.
long long apx_w8_counters(int M, int K, int N, int nk, int x_bf16) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  return plan(M, K, N, nk != 0, x_bf16 != 0).counters;
}

// x: (M, K) row-major, fp32 (x_bf16 0) or bf16 (1); wq: (K, N) int8
// row-major; scale: (N,) fp32; bias: (N,) fp32 (bias_bf16 0) or bf16 (1);
// out: (M, N) fp32 (out_bf16 0) or bf16 (1); work: apx_w8_workspace
// floats, counters: apx_w8_counters zeroed ints (each null where that
// is 0). Launches on `stream`; returns cudaGetLastError().
int apx_w8_matmul(const void* x, const void* wq, const void* scale,
                  const void* bias, void* out, void* work, void* counters,
                  int M, int K, int N, int x_bf16, int out_bf16,
                  int bias_bf16, void* stream) {
  return launch(x, wq, scale, bias, 1 + bias_bf16, out, work, counters, M, K,
                N, false, x_bf16, out_bf16, stream);
}

// As apx_w8_matmul, with no bias.
int apx_w8_matmul_nobias(const void* x, const void* wq, const void* scale,
                         void* out, void* work, void* counters, int M, int K,
                         int N, int x_bf16, int out_bf16, void* stream) {
  return launch(x, wq, scale, nullptr, 0, out, work, counters, M, K, N, false,
                x_bf16, out_bf16, stream);
}

// As apx_w8_matmul_nobias with wq (N, K) int8 row-major: one output
// channel a row, as the tied word table is stored.
int apx_w8_matmul_nk(const void* x, const void* wq, const void* scale,
                     void* out, void* work, int M, int K, int N, int x_bf16,
                     int out_bf16, void* stream) {
  return launch(x, wq, scale, nullptr, 0, out, work, nullptr, M, K, N, true,
                x_bf16, out_bf16, stream);
}

}  // extern "C"
