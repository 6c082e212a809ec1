// Fused causal self-attention for the TRAIN step: forward and backward.
//
// Replaces three TPU kernel pairs of mmtg_tpu/ops/train_attention.py:
//   mha_train_packed      (_fwd_kernel_packed / _bwd_kernel_packed),
//   mha_train_packed_seg  (_fwd_kernel_packed_seg / _bwd_kernel_packed_seg),
//   mha_train             (_fwd_kernel / _bwd_kernel).
// They are one computation with two options, both run-time fields of Dims:
// where a head's q, k and v sit in the slab, and what masks a score.
//
// What it computes, for every batch row b and head h of the standard GPT-2
// c_attn slab qkv [B, T, 3*H*hd] (q all heads | k all heads | v all heads),
// or of the head-major slab [B, T, H*384] (per head q | k | v, each 128 wide,
// the true head width zero-padded; context [B, T, H*128]):
//   q, k, v = slab slices + qkv_bias slices, rounded to the slab's type
//   s       = (q . k^T) * scale + m(b, i, j) + (j > i ? -1e30 : 0)       (f32)
//             m = key_bias[b, j]                       with a [B, T] f32 key bias
//             m = seg[b, i] == seg[b, j] ? 0 : -1e30   with [B, T] int32 segment ids
//   p       = softmax_j(s)                                               (f32)
//   pd      = keep(b,h,i,j) ? p * inv_keep : 0        (only when rate > 0)
//   ctx     = (pd rounded to the slab's type) . v, f32 accumulate
// and, given d(ctx) = do, the gradient in the slab's own layout:
//   dv  = pd^T . do            dpd = do . v^T
//   dp  = keep ? dpd * inv_keep : 0
//   ds  = p * (dp - D_i) * scale, rounded to the slab's type,
//         D_i = sum_j dp_ij p_ij
//   dq  = ds . k               dk = ds^T . q
//   dqb[c] = sum_{b,t} dqkv[b,t,c], summed in f32 from the unrounded dq/dk/dv.
// keep() is a counter-based hash of (seed, (b*H + h)*T + i, j) (see keep_bit
// below and dropout_keep_mask in ops/train_attention.py, which computes the
// same bits with torch integer ops), so forward, backward and a recomputed
// forward agree whatever the launch grid.
//
// What bounds it on the H100, by its inputs and outputs: bytes. At B = 64, T =
// 256, H = 12, hd = 64 in bf16 the forward must read the 75.5 MB slab and
// write a 25.2 MB context (100.7 MB, 30 us at 3.35 TB/s) for 6.5 GFLOP of
// causal products (7 us at the bf16 tensor-core peak); the backward must read
// the slab and do and write dqkv (176 MB, 53 us) for 16 GFLOP. These kernels
// also read the saved ctx and log-sum-exp (26 MB more): their own choice, not
// part of the bound. The [T, T] probabilities stay on chip in both
// directions: that is the point of the kernel.
//
// The file holds two designs, chosen by the slab's type at the C entry points
// and by nothing else (no run-time switch, no fallback from one to the other).
// Both use tiles of 64 rows, skip key tiles past the causal diagonal, and
// split the backward into a dq kernel (block = query tile, walks key tiles)
// and a dk/dv kernel (block = key tile, walks query tiles), so that dq, dk and
// dv need no atomics and dqkv is bit-reproducible; both recompute p = exp(s -
// lse) and the same keep bits; D_i is taken as sum_d do_id ctx_id (equal to
// sum_j dp_ij p_ij; ctx is the saved output), computed by the dq kernel and
// handed on in a [B, H, T] buffer. Only dqb uses atomics (f32), so its last
// bits change from run to run.
//
// bf16: tensor cores (second half of the file).
//   What holds it back is neither the products nor the bytes but instruction
//   issue on the scores: mask, exponential and above all the dropout hash (two
//   multiplies, three xor-shifts, a compare) are about 20 instructions an
//   element, 600-700 issue slots a thread and tile pair, against 250 clocks
//   of tensor-core time. So the design keeps everything else off the
//   instruction stream and the scores in registers:
//   * one warpgroup (128 threads) owns a 64-row tile; every product is
//     wgmma.mma_async m64n64k16 with f32 sums in registers. The SECOND product
//     of each pair takes its A operand from registers: the accumulator layout
//     of s IS the A-fragment layout, so probabilities and ds are rounded to
//     bf16, packed and multiplied without touching shared memory. The dk/dv
//     kernel computes the TRANSPOSED scores (k . q^T, v . do^T) for the same
//     reason: pd^T and ds^T are then the A fragments of dv += pd^T . do and dk
//     += ds^T . q.
//   * operands sit in shared memory as bf16 tiles in the 128-byte swizzle that
//     wgmma reads without bank conflicts, one layout for both directions (rows
//     as M / N: depth along the columns; rows as depth: the transpose flag).
//     They arrive by cp.async, 16 bytes a thread, and the projection bias is
//     added in place afterwards by the thread that copied the chunk (one bf16
//     add, which rounds as the plain version's f32 add does).
//   * forward: ONE sweep over the key tiles with an online softmax (running
//     maximum and sum per row in registers, a row's 64 scores sit in the four
//     threads of a quad; o is rescaled when the maximum moves; one divide at
//     the end; lse = m + log l). The dropped-out UN-NORMALISED probabilities
//     are what is rounded to bf16 and multiplied with v: ctx agrees with the
//     plain version to one bf16 step of its own value (1.6e-2 where |ctx| lies
//     between 2 and 4), not bit for bit. Shared memory does not grow with T.
//   * a ring of two tile pairs: the next live pair travels while the tensor
//     cores and the score arithmetic work on this one. What hides the memory
//     latency (about as long as a tile pair's work under load) is several
//     blocks an SM, so tiles are small (8 KB at 64 lanes): 4 blocks an SM in
//     the forward. A deeper ring was measured and loses to the block it costs.
//   * scores live in the base-2 domain (ex2.approx), the mask source and the
//     dropout setting are template flags (a kernel holds only its own code:
//     the unrolled element loop is 10 KB of instructions, and two variants of
//     it in one loop body ran clearly slower), the causal test runs on
//     the diagonal tile only.
//   * at 128 lanes a head (the head-major slab, or hd > 64) the same kernels
//     run with two [64, 64] sub-tiles a tile: 8 depth steps for the first
//     products, a [64, 128] accumulator for the second. The dk/dv kernel then
//     holds 192 accumulator registers a thread and sits at the 255 limit.
//   * segment ids: per element a select beside the key-bias path, per tile
//     pair the id-range test below; with an online softmax a skipped pair
//     costs nothing at all.
//
// f32: CUDA-core FMAs (first half of the file; unchanged from the first port).
//   Full-precision products (TF32 would lose the 1e-5 agreement with the plain
//   version that the f32 checks rely on), so what bounds it is the FMA rate
//   and the shared-memory loads that feed it (8 loads for 16 FMAs).
//   * a block of 256 threads owns one (b, h, 64-row tile); thread (ty, tx) =
//     (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16 j of every
//     64-wide product, operands sit in shared memory as f32 with an odd
//     leading dimension (no bank conflicts), sums are FMAs in registers.
//   * forward: the block keeps the score row block of at most 512 keys,
//     [64, min(T, 512)], in shared memory (199 KB at 128 lanes), soft-maxes it
//     with one warp per 8 rows, then multiplies by V tile by tile. Rows of more
//     than 512 keys (T up to 1024) take the keys in chunks of 512: one sweep
//     keeps a running max and sum per row, a second recomputes each chunk's
//     scores and multiplies its probabilities by V. It is the parity path: the
//     recomputation costs FMAs, not agreement.
//
// Segment ids (both designs): the block keeps its batch row's ids in shared
// memory and tests equality beside the causal test, per element; no [T, T]
// bias matrix exists anywhere. It also takes the least and the greatest id of
// every 64-row tile and skips a (query tile, key tile) pair whose id ranges do
// not overlap: no id of one can equal an id of the other, so every score of
// the pair is masked. That test holds for arbitrary ids; it skips most when
// ids ascend along the row, as a packer writes them.
// Semantics note: a key tile past the causal diagonal, or skipped by the
// segment test, is skipped, not added as -1e30; a masked score inside a
// visited tile is -1e30, so its p is exactly 0 in all kernels (in the online
// softmax a row whose scores so far are all masked carries p = 1 until its
// first live score rescales that to exactly 0). The two differ only for a
// query row whose every key j <= i is masked: a key bias never does that in
// the model (key 0 is always live) and segment ids never can (a row always
// sees itself).
// Known limits, left to later work: the bf16 kernels run at 0.6-0.7
// instructions a clock and scheduler with 8-16 warps an SM (a producer warp
// with TMA, two query tiles a block sharing their key tiles, or persistence
// would raise that); the 128-lane backward is register-bound at two blocks
// an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;      // query / key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 (or 4 x 8) outputs each
constexpr int kLdT = kTile + 1;
constexpr float kNegInf = -1e30f;
constexpr int kFwdCols = 512;  // keys whose f32 scores the forward holds at once

__host__ __device__ constexpr int fwd_cols(int T) { return T < kFwdCols ? T : kFwdCols; }

__device__ __forceinline__ float ldf(const float* p) { return *p; }

// x rounded to the element type E, as f32
template <typename E>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }

__device__ __forceinline__ void stf(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- dropout bits ---------------------------------------------------------
// murmur3's 32-bit finaliser: a bijection of uint32 with full avalanche.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}
// row = (b*H + h)*T + i. One key per (seed, row); a Weyl sequence over j.
__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t row) {
  return fmix32(row ^ fmix32(seed + 0x9E3779B9u));
}
__device__ __forceinline__ bool keep_bit(uint32_t rkey, uint32_t j, uint32_t thr) {
  return fmix32(rkey + j * 0x9E3779B9u) >= thr;
}

// ---- 64-row tiles in shared memory ---------------------------------------
// dst[r * (HDP + 1) + d] = src[r * row_stride + d] (+ bias[d], rounded to E)
// for 64 rows and d < hd; columns hd..HDP-1 are zero.
template <typename E, int HDP>
__device__ __forceinline__ void load_tile(float* dst, const E* src, size_t row_stride,
                                          const E* bias, int hd, int tid) {
  for (int idx = tid; idx < kTile * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    float v = 0.0f;
    if (d < hd) {
      v = ldf(src + static_cast<size_t>(r) * row_stride + d);
      if (bias != nullptr) v = rnd<E>(v + ldf(bias + d));
    }
    dst[r * (HDP + 1) + d] = v;
  }
}

// acc[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k]
template <int KD>
__device__ __forceinline__ void gemm_nt(float (&acc)[4][4], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < 64} A[ty + 16 i][k] * B[k][tx + 16 j]
template <int NJ>
__device__ __forceinline__ void gemm_nn(float (&acc)[4][NJ], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < 64} A[k][ty + 16 i] * B[k][tx + 16 j]
template <int NJ>
__device__ __forceinline__ void gemm_tn(float (&acc)[4][NJ], const float* A, int lda,
                                        const float* B, int ldb, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Column sums of a thread-distributed [64, HDP] f32 tile, added atomically to
// dst[0..hd). red is [16 * HDP] floats of shared memory.
template <int NJ>
__device__ __forceinline__ void column_sums_to(float* dst, const float (&acc)[4][NJ],
                                               float* red, int hd, int ty, int tx,
                                               int tid) {
  constexpr int HDP = 16 * NJ;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    red[ty * HDP + tx + 16 * j] = acc[0][j] + acc[1][j] + acc[2][j] + acc[3][j];
  __syncthreads();
  for (int c = tid; c < hd; c += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += red[r * HDP + c];
    atomicAdd(dst + c, s);
  }
  __syncthreads();
}

struct Dims {
  int B, T, H, hd;
  int S;        // row stride of the slab and of dqkv; length of qkv_bias and dqb
  int hs, ps;   // part p (q, k, v = 0, 1, 2) of head h starts at column h*hs + p*ps
  int CS, chs;  // row stride of ctx and d(ctx); head h starts at column h*chs
  int seg;      // the mask rows are int32 segment ids (else f32 key biases)
  float scale, inv_keep;
  uint32_t thr;
  int dropout;
};

__device__ __forceinline__ int col(const Dims& dm, int h, int part) {
  return h * dm.hs + part * dm.ps;
}

// ---- the mask -------------------------------------------------------------
// A block keeps its batch row's [T] mask words (key biases as f32 bits, or
// segment ids) in shared memory as int32.
__device__ __forceinline__ void load_mask_row(int* mrow, const void* mask, int b, int T, int n,
                                              int tid) {
  const int* src = static_cast<const int*>(mask) + static_cast<size_t>(b) * T;
  for (int j = tid; j < n; j += kThreads) mrow[j] = src[j];
}

// The additive mask term of score (i, j) from the two mask words.
__device__ __forceinline__ float mask_term(int seg, int wi, int wj) {
  if (seg) return wi == wj ? 0.0f : kNegInf;
  return __int_as_float(wj);
}

// lo[t], hi[t] = least and greatest segment id of the 64-row tile t, t0 <= t <= t1.
__device__ __forceinline__ void seg_tile_ranges(const int* mrow, int t0, int t1, int* lo, int* hi,
                                                int tid) {
  const int warp = tid / 32, lane = tid % 32;
  for (int t = t0 + warp; t <= t1; t += blockDim.x / 32) {
    const int a = mrow[t * kTile + lane], c = mrow[t * kTile + 32 + lane];
    int mn = min(a, c), mx = max(a, c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      lo[t] = mn;
      hi[t] = mx;
    }
  }
}

// May any query of tile qt attend any key of tile kt? (The causal order of
// the tiles is the caller's loop bound.)
__device__ __forceinline__ bool tile_live(int seg, const int* lo, const int* hi, int qt, int kt) {
  return !seg || (hi[kt] >= lo[qt] && lo[kt] <= hi[qt]);
}

// ---- forward --------------------------------------------------------------
template <typename E, int HDP>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const E* __restrict__ qkv, const E* __restrict__ qkv_bias,
               const void* __restrict__ mask, const int* __restrict__ seed_ptr,
               E* __restrict__ ctx, float* __restrict__ lse, Dims dm) {
  constexpr int LD = HDP + 1;
  constexpr int NJ = HDP / 16;
  extern __shared__ float smem[];
  const int T = dm.T, H = dm.H, hd = dm.hd;
  const int cw = fwd_cols(T);       // keys whose scores are held at once
  const int lds = cw + 1;
  float* Qs = smem;                 // [64, LD]
  float* KVs = Qs + kTile * LD;     // [64, LD]   K tile, then V tile
  float* Ss = KVs + kTile * LD;     // [64, cw + 1] scores, then probabilities
  int* mrow = reinterpret_cast<int*>(Ss + kTile * lds);  // [T] mask words of this batch row
  int* tlo = mrow + T;              // [T / 64] segment-id ranges of the tiles
  int* thi = tlo + T / kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S;
  const E* slab = qkv + static_cast<size_t>(b) * T * S;
  const int kv_len = (qt + 1) * kTile;
  const int n_chunks = (kv_len + cw - 1) / cw;

  load_mask_row(mrow, mask, b, T, kv_len, tid);
  load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S + col(dm, h, 0), S,
                    qkv_bias + col(dm, h, 0), hd, tid);
  __syncthreads();
  if (dm.seg) {
    seg_tile_ranges(mrow, 0, qt, tlo, thi, tid);
    __syncthreads();
  }

  // raw scores of the keys [c0, c0 + cw) into Ss (column j - c0)
  auto scores = [&](int c0) {
    const int c1 = min(c0 + cw, kv_len);
    for (int kc = c0 / kTile; kc < c1 / kTile; ++kc) {
      if (!tile_live(dm.seg, tlo, thi, qt, kc)) continue;  // its scores are never read
      load_tile<E, HDP>(KVs, slab + static_cast<size_t>(kc) * kTile * S + col(dm, h, 1), S,
                        qkv_bias + col(dm, h, 1), hd, tid);
      __syncthreads();
      float acc[4][4] = {};
      gemm_nt<HDP>(acc, Qs, LD, KVs, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[(ty + 16 * i) * lds + kc * kTile - c0 + tx + 16 * j] = acc[i][j];
      __syncthreads();
    }
  };
  // the masked, scaled score of (ig, j) from its raw score
  auto masked = [&](float raw, int ig, int wi, int j) {
    if (dm.seg) {
      // a select, not an add: a skipped tile's scores were never written
      return (mrow[j] == wi && j <= ig) ? raw * dm.scale : kNegInf;
    }
    float x = raw * dm.scale + __int_as_float(mrow[j]);
    return x + ((j > ig) ? kNegInf : 0.0f);
  };

  // softmax (+ dropout): warp w owns rows 8w .. 8w + 7. It walks the whole
  // row, skipped tiles too: walking the live tiles only was measured and is
  // slower (the loop nest costs more than the columns it leaves out). Rows
  // longer than cw keys (T > 512) take two sweeps: the first keeps a running
  // max and sum per row over the chunks, the second recomputes each chunk's
  // scores and multiplies its probabilities by V. With one chunk the first
  // sweep's exponentials stay in Ss and the arithmetic is that of a single
  // [64, T] block.
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  float rm[8], rl[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rm[i] = -INFINITY;
    rl[i] = 0.0f;
  }
  for (int c0 = 0; c0 < kv_len; c0 += cw) {
    scores(c0);
    const int n = min(cw, kv_len - c0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      const int ig = qt * kTile + r;
      const int wi = mrow[ig];
      float* row = Ss + r * lds;
      float m = -INFINITY;
      for (int jl = lane; jl < n; jl += 32) {
        const float x = masked(row[jl], ig, wi, c0 + jl);
        row[jl] = x;
        m = fmaxf(m, x);
      }
      const float m_new = fmaxf(rm[i], warp_max(m));
      float sum = 0.0f;
      for (int jl = lane; jl < n; jl += 32) {
        const float e = expf(row[jl] - m_new);
        row[jl] = e;
        sum += e;
      }
      // rl is 0 and rm -inf on the first chunk: l = 0 * 0 + sum, exactly
      rl[i] = rl[i] * expf(rm[i] - m_new) + warp_sum(sum);
      rm[i] = m_new;
    }
    __syncthreads();
  }

  float out[4][NJ] = {};
  for (int c0 = 0; c0 < kv_len; c0 += cw) {
    const int n = min(cw, kv_len - c0);
    if (n_chunks > 1) scores(c0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      const int ig = qt * kTile + r;
      const int wi = mrow[ig];
      float* row = Ss + r * lds;
      const uint32_t grow = static_cast<uint32_t>((b * H + h) * T + ig);
      const uint32_t rkey = row_key(seed, grow);
      for (int jl = lane; jl < n; jl += 32) {
        const int j = c0 + jl;
        const float e = n_chunks > 1 ? expf(masked(row[jl], ig, wi, j) - rm[i]) : row[jl];
        float p = e / rl[i];
        if (dm.dropout) p = keep_bit(rkey, static_cast<uint32_t>(j), dm.thr) ? p * dm.inv_keep : 0.0f;
        row[jl] = rnd<E>(p);
      }
      if (c0 == 0 && lane == 0)
        lse[(static_cast<size_t>(b) * H + h) * T + ig] = rm[i] + logf(rl[i]);
    }
    __syncthreads();
    for (int kc = c0 / kTile; kc < (c0 + n) / kTile; ++kc) {
      if (!tile_live(dm.seg, tlo, thi, qt, kc)) continue;  // its probabilities are all 0
      load_tile<E, HDP>(KVs, slab + static_cast<size_t>(kc) * kTile * S + col(dm, h, 2), S,
                        qkv_bias + col(dm, h, 2), hd, tid);
      __syncthreads();
      gemm_nn<NJ>(out, Ss + kc * kTile - c0, lds, KVs, LD, ty, tx);
      __syncthreads();
    }
  }
  E* dst = ctx + (static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile) * dm.CS + h * dm.chs;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) stf(dst + static_cast<size_t>(ty + 16 * i) * dm.CS + d, out[i][j]);
    }
}

// p, pd*?, ds for one (query i, key j) element of the backward, shared by the
// two backward kernels. Returns ds (unrounded, scaled); *pd_out gets the
// dropped-out probability.
__device__ __forceinline__ float bwd_element(float s_dot, float dpd, float kb, int ig, int jg,
                                             float lse_i, float d_i, uint32_t rkey,
                                             const Dims& dm, float* pd_out) {
  float x = s_dot * dm.scale + kb;
  x += (jg > ig) ? kNegInf : 0.0f;
  const float p = expf(x - lse_i);
  float pd = p, dp = dpd;
  if (dm.dropout) {
    const bool keep = keep_bit(rkey, static_cast<uint32_t>(jg), dm.thr);
    pd = keep ? p * dm.inv_keep : 0.0f;
    dp = keep ? dpd * dm.inv_keep : 0.0f;
  }
  *pd_out = pd;
  return (p * (dp - d_i)) * dm.scale;
}

// ---- backward, dq: one block per (b, h, QUERY tile) -------------------------
template <typename E, int HDP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const E* __restrict__ qkv, const E* __restrict__ qkv_bias,
                  const void* __restrict__ mask, const int* __restrict__ seed_ptr,
                  const E* __restrict__ ctx, const E* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  E* __restrict__ dqkv, float* __restrict__ dqb, Dims dm) {
  constexpr int LD = HDP + 1;
  constexpr int NJ = HDP / 16;
  extern __shared__ float smem[];
  const int T = dm.T, H = dm.H, hd = dm.hd;
  float* Qs = smem;                 // [64, LD]
  float* dOs = Qs + kTile * LD;     // [64, LD]
  float* Ks = dOs + kTile * LD;     // [64, LD]
  float* Vs = Ks + kTile * LD;      // [64, LD]
  float* dSs = Vs + kTile * LD;     // [64, 65]; later the column-sum scratch
  float* rowD = dSs + kTile * LD;   // [64]   (dSs sized as a [64, LD] tile)
  float* rowL = rowD + kTile;       // [64]
  int* mrow = reinterpret_cast<int*>(rowL + kTile);  // [T] mask words of this batch row
  int* tlo = mrow + T;              // [T / 64]
  int* thi = tlo + T / kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S, CS = dm.CS;
  const E* slab = qkv + static_cast<size_t>(b) * T * S;
  const size_t row0 = static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * T + static_cast<size_t>(qt) * kTile;

  load_mask_row(mrow, mask, b, T, (qt + 1) * kTile, tid);
  load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S + col(dm, h, 0), S,
                    qkv_bias + col(dm, h, 0), hd, tid);
  load_tile<E, HDP>(dOs, dout + row0 * CS + h * dm.chs, CS, static_cast<const E*>(nullptr), hd,
                    tid);
  {  // D_i = sum_d do_id * ctx_id, one warp per 8 rows
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const E* c = ctx + (row0 + r) * CS + h * dm.chs;
      const E* g = dout + (row0 + r) * CS + h * dm.chs;
      float s = 0.0f;
      for (int d = lane; d < hd; d += 32) s = fmaf(ldf(g + d), ldf(c + d), s);
      s = warp_sum(s);
      if (lane == 0) {
        rowD[r] = s;
        dsum[stat0 + r] = s;
        rowL[r] = lse[stat0 + r];
      }
    }
  }
  __syncthreads();
  if (dm.seg) {
    seg_tile_ranges(mrow, 0, qt, tlo, thi, tid);
    __syncthreads();
  }

  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  uint32_t rkey[4];
  float li[4], di[4];
  int wi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    rkey[i] = row_key(seed, static_cast<uint32_t>((b * H + h) * T + qt * kTile + r));
    li[i] = rowL[r];
    di[i] = rowD[r];
    wi[i] = mrow[qt * kTile + r];
  }

  float dq[4][NJ] = {};
  for (int kc = 0; kc <= qt; ++kc) {
    if (!tile_live(dm.seg, tlo, thi, qt, kc)) continue;  // every p of the pair is 0
    load_tile<E, HDP>(Ks, slab + static_cast<size_t>(kc) * kTile * S + col(dm, h, 1), S,
                      qkv_bias + col(dm, h, 1), hd, tid);
    load_tile<E, HDP>(Vs, slab + static_cast<size_t>(kc) * kTile * S + col(dm, h, 2), S,
                      qkv_bias + col(dm, h, 2), hd, tid);
    __syncthreads();
    float s[4][4] = {}, dpd[4][4] = {};
    gemm_nt<HDP>(s, Qs, LD, Ks, LD, ty, tx);
    gemm_nt<HDP>(dpd, dOs, LD, Vs, LD, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jg = kc * kTile + tx + 16 * j;
      const int wj = mrow[jg];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pd;
        const float ds = bwd_element(s[i][j], dpd[i][j], mask_term(dm.seg, wi[i], wj),
                                     qt * kTile + ty + 16 * i, jg, li[i], di[i], rkey[i], dm,
                                     &pd);
        dSs[(ty + 16 * i) * kLdT + tx + 16 * j] = rnd<E>(ds);
      }
    }
    __syncthreads();
    gemm_nn<NJ>(dq, dSs, kLdT, Ks, LD, ty, tx);
    __syncthreads();
  }

  E* dst = dqkv + row0 * S + col(dm, h, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) stf(dst + static_cast<size_t>(ty + 16 * i) * S + d, dq[i][j]);
    }
  column_sums_to<NJ>(dqb + col(dm, h, 0), dq, dSs, hd, ty, tx, tid);
}

// ---- backward, dk and dv: one block per (b, h, KEY tile) --------------------
template <typename E, int HDP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkdv_kernel(const E* __restrict__ qkv, const E* __restrict__ qkv_bias,
                    const void* __restrict__ mask, const int* __restrict__ seed_ptr,
                    const E* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, E* __restrict__ dqkv,
                    float* __restrict__ dqb, Dims dm) {
  constexpr int LD = HDP + 1;
  constexpr int NJ = HDP / 16;
  extern __shared__ float smem[];
  const int T = dm.T, H = dm.H, hd = dm.hd;
  float* Ks = smem;                 // [64, LD]  this block's keys
  float* Vs = Ks + kTile * LD;      // [64, LD]
  float* Qs = Vs + kTile * LD;      // [64, LD]  the current query tile
  float* dOs = Qs + kTile * LD;     // [64, LD]
  float* Ps = dOs + kTile * LD;     // [64, 65]  pd[i][j]; later column-sum scratch
  float* dSs = Ps + kTile * LD;     // [64, 65]  ds[i][j]   (both sized [64, LD])
  float* rowD = dSs + kTile * LD;   // [64]
  float* rowL = rowD + kTile;       // [64]
  int* mrow = reinterpret_cast<int*>(rowL + kTile);  // [T] mask words of this batch row
  int* tlo = mrow + T;              // [T / 64]
  int* thi = tlo + T / kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x;  // key tile 0 walks every query tile: first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S, CS = dm.CS;
  const E* slab = qkv + static_cast<size_t>(b) * T * S;
  const int n_tiles = T / kTile;

  load_mask_row(mrow, mask, b, T, T, tid);
  load_tile<E, HDP>(Ks, slab + static_cast<size_t>(kt) * kTile * S + col(dm, h, 1), S,
                    qkv_bias + col(dm, h, 1), hd, tid);
  load_tile<E, HDP>(Vs, slab + static_cast<size_t>(kt) * kTile * S + col(dm, h, 2), S,
                    qkv_bias + col(dm, h, 2), hd, tid);
  __syncthreads();
  if (dm.seg) {
    seg_tile_ranges(mrow, kt, n_tiles - 1, tlo, thi, tid);
    __syncthreads();
  }
  int wj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wj[j] = mrow[kt * kTile + tx + 16 * j];
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  float dk[4][NJ] = {}, dv[4][NJ] = {};
  for (int qt = kt; qt < n_tiles; ++qt) {
    if (!tile_live(dm.seg, tlo, thi, qt, kt)) continue;  // every p of the pair is 0
    const size_t row0 = static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile;
    const size_t stat0 = (static_cast<size_t>(b) * H + h) * T + static_cast<size_t>(qt) * kTile;
    load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S + col(dm, h, 0), S,
                      qkv_bias + col(dm, h, 0), hd, tid);
    load_tile<E, HDP>(dOs, dout + row0 * CS + h * dm.chs, CS, static_cast<const E*>(nullptr), hd,
                      tid);
    if (tid < kTile) {
      rowD[tid] = dsum[stat0 + tid];
      rowL[tid] = lse[stat0 + tid];
    }
    __syncthreads();
    float s[4][4] = {}, dpd[4][4] = {};
    gemm_nt<HDP>(s, Qs, LD, Ks, LD, ty, tx);      // rows: queries, cols: keys
    gemm_nt<HDP>(dpd, dOs, LD, Vs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int ig = qt * kTile + r;
      const uint32_t rkey = row_key(seed, static_cast<uint32_t>((b * H + h) * T + ig));
      const float li = rowL[r], di = rowD[r];
      const int wi = mrow[ig];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd;
        const float ds = bwd_element(s[i][j], dpd[i][j], mask_term(dm.seg, wi, wj[j]), ig,
                                     kt * kTile + tx + 16 * j, li, di, rkey, dm, &pd);
        Ps[r * kLdT + tx + 16 * j] = rnd<E>(pd);
        dSs[r * kLdT + tx + 16 * j] = rnd<E>(ds);
      }
    }
    __syncthreads();
    gemm_tn<NJ>(dv, Ps, kLdT, dOs, LD, ty, tx);   // rows: keys, cols: d
    gemm_tn<NJ>(dk, dSs, kLdT, Qs, LD, ty, tx);
    __syncthreads();
  }

  E* dst = dqkv + (static_cast<size_t>(b) * T + static_cast<size_t>(kt) * kTile) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        stf(dst + static_cast<size_t>(ty + 16 * i) * S + col(dm, h, 1) + d, dk[i][j]);
        stf(dst + static_cast<size_t>(ty + 16 * i) * S + col(dm, h, 2) + d, dv[i][j]);
      }
    }
  column_sums_to<NJ>(dqb + col(dm, h, 1), dk, Ps, hd, ty, tx, tid);
  column_sums_to<NJ>(dqb + col(dm, h, 2), dv, Ps, hd, ty, tx, tid);
}

// ===========================================================================
// bf16: the tensor-core kernels (wgmma, one warpgroup a block)
// ===========================================================================
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kWG = 128;                    // threads of one warpgroup
constexpr int kSubBytes = kTile * 64 * 2;   // one [64, 64] bf16 sub-tile
constexpr int kAtomBytes = 8 * 128;         // 8 rows of 128 bytes: the swizzle's period

// A tile is [64, HDP] bf16 as HDP / 64 sub-tiles of [64 rows, 128 bytes], each
// 1024-byte aligned and 128-byte swizzled: the 16-byte chunk c of row r sits
// at r * 128 + ((c ^ (r & 7)) << 4). wgmma reads that layout through a
// descriptor either way round: rows as M / N with the columns as depth
// ("K-major": q . k^T and its like), or rows as depth with the columns as N
// ("MN-major", the instruction's transpose flag: p . v and its like).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned char* align_tiles(unsigned char* p) {
  return p + ((kAtomBytes - (smem_addr(p) & (kAtomBytes - 1))) & (kAtomBytes - 1));
}
__device__ __forceinline__ int chunk_offset(int r, int c) {
  return (c >> 3) * kSubBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// ---- asynchronous copies ----------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // src_bytes < 16: the rest of the 16 bytes is filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread become visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Queue the copy of 64 rows of `src` (row stride in elements) into a tile.
// Thread t copies chunk t % (HDP / 8) of rows t / (HDP / 8) + k * (1024 / HDP):
// one column chunk a thread, so its slice of the bias stays in registers.
// Chunks at or past column hd are zero-filled.
template <int HDP>
__device__ __forceinline__ void load_tile_async(unsigned char* tile, const bf16* src,
                                                size_t row_stride, int hd, int tid) {
  constexpr int CPR = HDP / 8;
  const int c = tid % CPR;
  const int bytes = c * 8 < hd ? 16 : 0;
  src += bytes ? c * 8 : 0;
  const uint32_t dst = smem_addr(tile);
#pragma unroll
  for (int k = 0; k < CPR / 2; ++k) {
    const int r = tid / CPR + k * (kWG / CPR);
    cp_async16(dst + chunk_offset(r, c), src + static_cast<size_t>(r) * row_stride, bytes);
  }
}

// The 8 bias values of this thread's column chunk (zeros past column hd).
template <int HDP>
__device__ __forceinline__ uint4 bias_chunk(const bf16* bias, int hd, int tid) {
  const int c = tid % (HDP / 8);
  if (c * 8 >= hd) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(bias + c * 8);
}

// tile += bias, in place, on the chunks this thread copied (visible to it
// once its copies have completed). The bf16 add rounds the exact sum once,
// which equals the f32 add rounded to bf16 that the plain version does: f32's
// 24 bits are more than 2 * 8 + 2, so its rounding never moves a bf16 tie.
template <int HDP>
__device__ __forceinline__ void add_bias_tile(unsigned char* tile, uint4 bias, int hd, int tid) {
  constexpr int CPR = HDP / 8;
  const int c = tid % CPR;
  if (c * 8 >= hd) return;
  const bf162* bb = reinterpret_cast<const bf162*>(&bias);
#pragma unroll
  for (int i = 0; i < CPR / 2; ++i) {
    const int r = tid / CPR + i * (kWG / CPR);
    uint4* p = reinterpret_cast<uint4*>(tile + chunk_offset(r, c));
    uint4 v = *p;
    bf162* vv = reinterpret_cast<bf162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) vv[k] = __hadd2(vv[k], bb[k]);
    *p = v;
  }
}

// ---- wgmma ------------------------------------------------------------------
// Shared-memory operand descriptor: address >> 4, leading byte offset (unused
// for one 128-byte swizzled row of chunks) 1, stride between 8-row groups
// 1024 bytes, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (1ull << 62);
}
// rows as M / N, depth step ks = columns [16 ks, 16 ks + 16)
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int ks) {
  return make_desc(smem_addr(tile) + (ks >> 2) * kSubBytes + (ks & 3) * 32);
}
// rows as depth, step ks = rows [16 ks, 16 ks + 16); columns [64 nh, 64 nh + 64) as N
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int nh, int ks) {
  return make_desc(smem_addr(tile) + nh * kSubBytes + ks * 2 * kAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin register values on one side of an asynchronous product.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define MMTG_ACC32(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])
#define MMTG_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64, 64] (+)= a[64, 16] . b[64, 16]^T, both from shared memory, depth along
// the columns of both; accumulate == 0 overwrites d (it need not be set).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMTG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : MMTG_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d[64, 64] += a[64, 16] . b[16, 64], a from this thread's fragment registers,
// b from shared memory with the depth along its rows (transposed operand).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MMTG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : MMTG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[64, 64] = A . B^T over the tiles' HDP columns
template <int HDP>
__device__ __forceinline__ void product_nt(float (&acc)[32], const unsigned char* A,
                                           const unsigned char* B) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) wgmma_ss(acc, desc_k(A, ks), desc_k(B, ks), ks > 0);
}
// acc[64, HDP] += a[64, 64] . B, a in fragment registers (frag[ks] = its
// columns [16 ks, 16 ks + 16)), B a [64, HDP] tile
template <int HDP>
__device__ __forceinline__ void product_rn(float (&acc)[HDP / 64][32],
                                           const uint32_t (&frag)[4][4],
                                           const unsigned char* B) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nh = 0; nh < HDP / 64; ++nh) wgmma_rs(acc[nh], frag[ks], desc_mn(B, nh, ks));
}

// Accumulator layout of a [64, 64] product, thread = (warp, g = lane / 4,
// q4 = lane % 4): element e is row 16 warp + g + 8 ((e >> 1) & 1), column
// 8 (e >> 2) + 2 q4 + (e & 1). The same elements, rounded to bf16 and
// packed in pairs, are the A fragments of the next product: depth step ks
// takes elements 8 ks .. 8 ks + 7.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void to_fragments(uint32_t (&frag)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) frag[ks][i] = pack_bf16(x[8 * ks + 2 * i], x[8 * ks + 2 * i + 1]);
}

// ---- epilogues --------------------------------------------------------------
// An accumulator acc[64, HDP] leaves in two steps with one __syncthreads()
// between them. stage_acc: rounded to bf16 into a (free) tile and, with SUMS,
// each thread's two rows added and written as one of 32 partial rows to
// `scratch` (32 rows of HDP + 8 floats: the stride keeps the 8-byte stores off
// each other's banks). flush_acc: the tile goes to dst 16 bytes a thread
// (row stride in elements, columns below hd only) and, with SUMS, 128 / HDP
// threads a column add the partial rows (f32, unrounded) and add the sum
// atomically to sums_dst[0..hd).
template <int HDP, bool SUMS>
__device__ __forceinline__ void stage_acc(unsigned char* tile, float* scratch,
                                          const float (&acc)[HDP / 64][32], int tid) {
  const int warp = tid / 32, g = (tid % 32) / 4, q4 = tid % 4;
#pragma unroll
  for (int nh = 0; nh < HDP / 64; ++nh)
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint32_t*>(tile + chunk_offset(16 * warp + g + 8 * rr, 8 * nh + j8) +
                                     4 * q4) =
            pack_bf16(acc[nh][4 * j8 + 2 * rr], acc[nh][4 * j8 + 2 * rr + 1]);
      if (SUMS)
        *reinterpret_cast<float2*>(scratch + (8 * warp + g) * (HDP + 8) + 64 * nh + 8 * j8 +
                                   2 * q4) =
            make_float2(acc[nh][4 * j8] + acc[nh][4 * j8 + 2],
                        acc[nh][4 * j8 + 1] + acc[nh][4 * j8 + 3]);
    }
}

template <int HDP, bool SUMS>
__device__ __forceinline__ void flush_acc(const unsigned char* tile, const float* scratch,
                                          bf16* dst, size_t row_stride, float* sums_dst, int hd,
                                          int tid) {
  constexpr int CPR = HDP / 8;
  const int c = tid % CPR;
  if (c * 8 < hd) {
#pragma unroll
    for (int k = 0; k < CPR / 2; ++k) {
      const int r = tid / CPR + k * (kWG / CPR);
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + chunk_offset(r, c));
    }
  }
  if (SUMS) {
    constexpr int kRows = 32 * HDP / kWG;  // partial rows a thread adds
    const int col = tid % HDP, r0 = (tid / HDP) * kRows;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) s += scratch[(r0 + r) * (HDP + 8) + col];
    if (col < hd) atomicAdd(sums_dst + col, s);
  }
}

// Scores are kept in the base-2 domain, x2 = x * log2(e), so that a
// probability is one add and one ex2.approx (2 ulp; exp(-1e30) is still 0).
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A mask word for the base-2 domain: a key bias times log2(e); a segment id as
// it is.
template <bool SEG>
__device__ __forceinline__ int mask_word2(int w) {
  return SEG ? w : __float_as_int(__int_as_float(w) * kLog2e);
}
// load_mask_row in base-2 words (four loads a thread in flight at once: a block
// waits for memory once)
template <bool SEG>
__device__ __forceinline__ void load_mask_row2(int* mrow, const void* mask, int b, int T, int n,
                                               int tid) {
  const int* src = static_cast<const int*>(mask) + static_cast<size_t>(b) * T;
  for (int j0 = tid; j0 < n; j0 += 4 * kWG) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k * kWG;
      if (j < n) mrow[j] = mask_word2<SEG>(src[j]);
    }
  }
}
// the mask term of score (i, j) in the base-2 domain, from the two mask words
template <bool SEG>
__device__ __forceinline__ float mask_term2(int wi, int wj) {
  if (SEG) return wi == wj ? 0.0f : kNegInf;
  return __int_as_float(wj);
}

// bwd_element in the base-2 domain, without the causal test: s_dot . scale2 +
// kb2 is the score times log2(e), lse2 the row's log-sum-exp times log2(e).
// The caller zeroes the entries past the causal diagonal afterwards (only the
// diagonal tile has any).
template <bool DROP>
__device__ __forceinline__ float bwd_element2(float s_dot, float dpd, float scale2, float kb2,
                                              float lse2, float d_i, uint32_t rkey, uint32_t jg,
                                              const Dims& dm, float* pd_out) {
  const float p = ex2(fmaf(s_dot, scale2, kb2) - lse2);
  float pd = p, dp = dpd;
  if (DROP) {
    const bool keep = keep_bit(rkey, jg, dm.thr);
    pd = keep ? p * dm.inv_keep : 0.0f;
    dp = keep ? dpd * dm.inv_keep : 0.0f;
  }
  *pd_out = pd;
  return (p * (dp - d_i)) * dm.scale;
}

// the first live key tile at or after kc (qt + 1 if none) / query tile at or
// after qt (n_tiles if none)
template <bool SEG>
__device__ __forceinline__ int next_live_key(const int* lo, const int* hi, int qt, int kc) {
  while (kc <= qt && !tile_live(SEG, lo, hi, qt, kc)) ++kc;
  return kc;
}
template <bool SEG>
__device__ __forceinline__ int next_live_query(const int* lo, const int* hi, int qt, int kt,
                                               int n_tiles) {
  while (qt < n_tiles && !tile_live(SEG, lo, hi, qt, kt)) ++qt;
  return qt;
}

// ---- forward: one block per (b, h, QUERY tile), one sweep over the key tiles --
// (4 blocks an SM at 64 lanes: 128 registers a thread, measured without spills
// and 5% faster than the 160 the compiler takes when left alone)
template <int HDP, bool SEG, bool DROP>
__global__ void __launch_bounds__(kWG, HDP == 64 ? 4 : 1)
mha_fwd_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                  const void* __restrict__ mask, const int* __restrict__ seed_ptr,
                  bf16* __restrict__ ctx, float* __restrict__ lse, Dims dm) {
  constexpr int NH = HDP / 64;
  constexpr int kTileBytes = NH * kSubBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_tiles(smem_raw);  // [64, HDP]; at the end the output's staging
  unsigned char* ring = Qs + kTileBytes;      // 2 stages of K | V
  int* mrow = reinterpret_cast<int*>(ring + 4 * kTileBytes);  // [T] mask words
  int* tlo = mrow + dm.T;                     // [T / 64] segment-id ranges of the tiles
  int* thi = tlo + dm.T / kTile;

  const int T = dm.T, H = dm.H, hd = dm.hd;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, q4 = tid % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S;
  const bf16* slab = qkv + static_cast<size_t>(b) * T * S;
  const bf16* ksrc = slab + col(dm, h, 1);
  const bf16* vsrc = slab + col(dm, h, 2);
  const uint4 bq = bias_chunk<HDP>(qkv_bias + col(dm, h, 0), hd, tid);
  const uint4 bk = bias_chunk<HDP>(qkv_bias + col(dm, h, 1), hd, tid);
  const uint4 bv = bias_chunk<HDP>(qkv_bias + col(dm, h, 2), hd, tid);

  auto fill = [&](int kc, int stage) {
    unsigned char* Ks = ring + 2 * stage * kTileBytes;
    load_tile_async<HDP>(Ks, ksrc + static_cast<size_t>(kc) * kTile * S, S, hd, tid);
    load_tile_async<HDP>(Ks + kTileBytes, vsrc + static_cast<size_t>(kc) * kTile * S, S, hd, tid);
    cp_async_commit();
  };
  // The first copies are queued before anything is waited for. With segment
  // ids the first live key tile is known only after the ids are in.
  load_tile_async<HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S + col(dm, h, 0), S, hd, tid);
  int kc = 0;
  if (!SEG) fill(kc, 0);
  load_mask_row2<SEG>(mrow, mask, b, T, (qt + 1) * kTile, tid);
  __syncthreads();
  if (SEG) {
    seg_tile_ranges(mrow, 0, qt, tlo, thi, tid);
    __syncthreads();
    kc = next_live_key<SEG>(tlo, thi, qt, 0);  // the diagonal tile is always live
    fill(kc, 0);
  }

  // this thread's two query rows
  const int ig0 = qt * kTile + 16 * warp + g, ig1 = ig0 + 8;
  const int wi0 = mrow[ig0], wi1 = mrow[ig1];
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const uint32_t rkey0 = row_key(seed, static_cast<uint32_t>((b * H + h) * T + ig0));
  const uint32_t rkey1 = row_key(seed, static_cast<uint32_t>((b * H + h) * T + ig1));
  const float scale2 = dm.scale * kLog2e;
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima (base-2 domain)
  float l0 = 0.0f, l1 = 0.0f;            // running sums (this thread's columns)
  float o[NH][32];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nh][e] = 0.0f;

  int stage = 0;
  bool first = true;
  while (kc <= qt) {
    const int nx = next_live_key<SEG>(tlo, thi, qt, kc + 1);
    if (nx <= qt) {  // the next live tile travels while this one is worked on
      fill(nx, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unsigned char* Ks = ring + 2 * stage * kTileBytes;
    unsigned char* Vs = Ks + kTileBytes;
    if (first) add_bias_tile<HDP>(Qs, bq, hd, tid);
    first = false;
    add_bias_tile<HDP>(Ks, bk, hd, tid);
    add_bias_tile<HDP>(Vs, bv, hd, tid);
    fence_async_proxy();
    __syncthreads();

    float s[32];
    wgmma_fence();
    product_nt<HDP>(s, Qs, Ks);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // scores; only the diagonal tile has keys past the causal diagonal
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int wj = mrow[kc * kTile + 8 * j8 + 2 * q4 + c];
        s[4 * j8 + c] = fmaf(s[4 * j8 + c], scale2, mask_term2<SEG>(wi0, wj));
        s[4 * j8 + 2 + c] = fmaf(s[4 * j8 + 2 + c], scale2, mask_term2<SEG>(wi1, wj));
      }
    if (kc == qt) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int jg = kc * kTile + 8 * (e >> 2) + 2 * q4 + (e & 1);
        s[e] = (jg > ((e & 2) ? ig1 : ig0)) ? kNegInf : s[e];
      }
    }
    // the tile's row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (e & 2) {
        mx1 = fmaxf(mx1, s[e]);
      } else {
        mx0 = fmaxf(mx0, s[e]);
      }
    }
    // a row's 64 scores sit in the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a score is >= -3e30
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);       // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    // Un-normalised probabilities; the sum is taken before dropout. A row
    // whose scores so far are all masked has m near -1e30 and p = 1 here: the
    // first live score rescales that to exactly 0 (a = 2^(-1e30 - m) = 0),
    // as the masked entries of a visited tile are 0 in the plain version.
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t jg = static_cast<uint32_t>(kc * kTile + 8 * j8 + 2 * q4 + c);
        float p0 = ex2(s[4 * j8 + c] - m0), p1 = ex2(s[4 * j8 + 2 + c] - m1);
        sum0 += p0;
        sum1 += p1;
        if (DROP) {
          p0 = keep_bit(rkey0, jg, dm.thr) ? p0 * dm.inv_keep : 0.0f;
          p1 = keep_bit(rkey1, jg, dm.thr) ? p1 * dm.inv_keep : 0.0f;
        }
        s[4 * j8 + c] = p0;
        s[4 * j8 + 2 + c] = p1;
      }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nh][e] *= (e & 2) ? a1 : a0;

    // o += bf16(p) . V, the probabilities straight from their registers
    uint32_t frag[4][4];
    to_fragments(frag, s);
    fence_regs(frag);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) fence_regs(o[nh]);
    wgmma_fence();
    product_rn<HDP>(o, frag, Vs);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) fence_regs(o[nh]);
    __syncthreads();  // the stage may be refilled
    kc = nx;
    stage ^= 1;
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.0f / l0, r1 = 1.0f / l1;
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nh][e] *= (e & 2) ? r1 : r0;
  if (q4 == 0) {
    float* dst = lse + (static_cast<size_t>(b) * H + h) * T;
    dst[ig0] = m0 * kLn2 + logf(l0);
    dst[ig1] = m1 * kLn2 + logf(l1);
  }
  stage_acc<HDP, false>(Qs, nullptr, o, tid);
  __syncthreads();
  flush_acc<HDP, false>(
      Qs, nullptr,
      ctx + (static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile) * dm.CS + h * dm.chs,
      dm.CS, nullptr, hd, tid);
}

// ---- backward, dq: one block per (b, h, QUERY tile) -------------------------
template <int HDP, bool SEG, bool DROP>
__global__ void __launch_bounds__(kWG)
mha_bwd_dq_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                     const void* __restrict__ mask, const int* __restrict__ seed_ptr,
                     const bf16* __restrict__ ctx, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ dsum,
                     bf16* __restrict__ dqkv, float* __restrict__ dqb, Dims dm) {
  constexpr int NH = HDP / 64;
  constexpr int kTileBytes = NH * kSubBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align_tiles(smem_raw);  // [64, HDP]; at the end dq's staging
  unsigned char* dOs = Qs + kTileBytes;       // [64, HDP]
  unsigned char* ring = dOs + kTileBytes;     // 2 stages of K | V; at the end scratch
  float* rowD = reinterpret_cast<float*>(ring + 4 * kTileBytes);  // [64]
  int* mrow = reinterpret_cast<int*>(rowD + kTile);  // [T] mask words
  int* tlo = mrow + dm.T;
  int* thi = tlo + dm.T / kTile;

  const int T = dm.T, H = dm.H, hd = dm.hd;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, q4 = tid % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S, CS = dm.CS;
  const bf16* slab = qkv + static_cast<size_t>(b) * T * S;
  const bf16* ksrc = slab + col(dm, h, 1);
  const bf16* vsrc = slab + col(dm, h, 2);
  const size_t row0 = static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * T + static_cast<size_t>(qt) * kTile;
  const uint4 bq = bias_chunk<HDP>(qkv_bias + col(dm, h, 0), hd, tid);
  const uint4 bk = bias_chunk<HDP>(qkv_bias + col(dm, h, 1), hd, tid);
  const uint4 bv = bias_chunk<HDP>(qkv_bias + col(dm, h, 2), hd, tid);

  auto fill = [&](int kc, int stage) {
    unsigned char* Ks = ring + 2 * stage * kTileBytes;
    load_tile_async<HDP>(Ks, ksrc + static_cast<size_t>(kc) * kTile * S, S, hd, tid);
    load_tile_async<HDP>(Ks + kTileBytes, vsrc + static_cast<size_t>(kc) * kTile * S, S, hd, tid);
    cp_async_commit();
  };
  load_tile_async<HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S + col(dm, h, 0), S, hd, tid);
  load_tile_async<HDP>(dOs, dout + row0 * CS + h * dm.chs, CS, hd, tid);
  int kc = 0;
  if (!SEG) fill(kc, 0);
  // every load of the prologue is issued before the first wait
  float li[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) li[rr] = lse[stat0 + 16 * warp + g + 8 * rr] * kLog2e;
  load_mask_row2<SEG>(mrow, mask, b, T, (qt + 1) * kTile, tid);
  {  // D_i = sum_d do_id * ctx_id: two threads a row, 16 bytes a load
    const int r = tid / 2, half = tid % 2;
    const bf16* c = ctx + (row0 + r) * CS + h * dm.chs;
    const bf16* d = dout + (row0 + r) * CS + h * dm.chs;
    float sum = 0.0f;
#pragma unroll
    for (int k2 = 0; k2 < HDP / 16; ++k2) {
      const int ch = half + 2 * k2;
      if (ch >= hd / 8) continue;
      const uint4 cv = *reinterpret_cast<const uint4*>(c + 8 * ch);
      const uint4 dv = *reinterpret_cast<const uint4*>(d + 8 * ch);
      const bf162* cc = reinterpret_cast<const bf162*>(&cv);
      const bf162* dd = reinterpret_cast<const bf162*>(&dv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x = __bfloat1622float2(cc[k]), y = __bfloat1622float2(dd[k]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      rowD[r] = sum;
      dsum[stat0 + r] = sum;
    }
  }
  __syncthreads();
  if (SEG) {
    seg_tile_ranges(mrow, 0, qt, tlo, thi, tid);
    __syncthreads();
    kc = next_live_key<SEG>(tlo, thi, qt, 0);
    fill(kc, 0);
  }

  const float scale2 = dm.scale * kLog2e;
  const int ig[2] = {qt * kTile + 16 * warp + g, qt * kTile + 16 * warp + g + 8};
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  uint32_t rkey[2];
  float di[2];
  int wi[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rkey[rr] = row_key(seed, static_cast<uint32_t>((b * H + h) * T + ig[rr]));
    di[rr] = rowD[16 * warp + g + 8 * rr];
    wi[rr] = mrow[ig[rr]];
  }
  float dq[NH][32];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[nh][e] = 0.0f;

  int stage = 0;
  bool first = true;
  while (kc <= qt) {
    const int nx = next_live_key<SEG>(tlo, thi, qt, kc + 1);
    if (nx <= qt) {
      fill(nx, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unsigned char* Ks = ring + 2 * stage * kTileBytes;
    unsigned char* Vs = Ks + kTileBytes;
    if (first) add_bias_tile<HDP>(Qs, bq, hd, tid);
    first = false;
    add_bias_tile<HDP>(Ks, bk, hd, tid);
    add_bias_tile<HDP>(Vs, bv, hd, tid);
    fence_async_proxy();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
    product_nt<HDP>(s, Qs, Ks);    // rows: queries, columns: keys
    product_nt<HDP>(dp, dOs, Vs);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jg = kc * kTile + 8 * j8 + 2 * q4 + c;
        const int wj = mrow[jg];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * j8 + 2 * rr + c;
          float pd;
          s[e] = bwd_element2<DROP>(s[e], dp[e], scale2, mask_term2<SEG>(wi[rr], wj), li[rr],
                                    di[rr], rkey[rr], static_cast<uint32_t>(jg), dm, &pd);
        }
      }
    if (kc == qt) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int jg = kc * kTile + 8 * (e >> 2) + 2 * q4 + (e & 1);
        s[e] = (jg > ig[(e >> 1) & 1]) ? 0.0f : s[e];
      }
    }
    // dq += bf16(ds) . K, ds straight from its registers
    uint32_t frag[4][4];
    to_fragments(frag, s);
    fence_regs(frag);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) fence_regs(dq[nh]);
    wgmma_fence();
    product_rn<HDP>(dq, frag, Ks);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) fence_regs(dq[nh]);
    __syncthreads();  // the stage may be refilled
    kc = nx;
    stage ^= 1;
  }

  float* scratch = reinterpret_cast<float*>(ring);
  stage_acc<HDP, true>(Qs, scratch, dq, tid);
  __syncthreads();
  flush_acc<HDP, true>(Qs, scratch, dqkv + row0 * S + col(dm, h, 0), S, dqb + col(dm, h, 0), hd,
                       tid);
}

// ---- backward, dk and dv: one block per (b, h, KEY tile) --------------------
// The scores are computed TRANSPOSED (rows: keys, columns: queries), so that
// pd^T and ds^T come out of the accumulators as the A fragments of dv += pd^T .
// do and dk += ds^T . q. At HDP = 128 the two [64, 128] f32 accumulators and
// the two score accumulators take 192 of a thread's 255 registers.
template <int HDP, bool SEG, bool DROP>
__global__ void __launch_bounds__(kWG)
mha_bwd_dkdv_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qkv_bias,
                       const void* __restrict__ mask, const int* __restrict__ seed_ptr,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dsum, bf16* __restrict__ dqkv,
                       float* __restrict__ dqb, Dims dm) {
  constexpr int NH = HDP / 64;
  constexpr int kTileBytes = NH * kSubBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align_tiles(smem_raw);  // [64, HDP] this block's keys
  unsigned char* Vs = Ks + kTileBytes;        // [64, HDP]
  unsigned char* ring = Vs + kTileBytes;      // 2 stages of Q | dO; at the end scratch
  // [T] per query of this (b, h): lse * log2(e), D_i, dropout row key, mask word
  uint4* qrow = reinterpret_cast<uint4*>(ring + 4 * kTileBytes);
  int* mrow = reinterpret_cast<int*>(qrow + dm.T);            // [T] mask words
  int* tlo = mrow + dm.T;
  int* thi = tlo + dm.T / kTile;

  const int T = dm.T, H = dm.H, hd = dm.hd;
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, q4 = tid % 4;
  const int kt = blockIdx.x;  // key tile 0 walks every query tile: first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t S = dm.S, CS = dm.CS;
  const bf16* slab = qkv + static_cast<size_t>(b) * T * S;
  const bf16* qsrc = slab + col(dm, h, 0);
  const bf16* dosrc = dout + static_cast<size_t>(b) * T * CS + h * dm.chs;
  const int n_tiles = T / kTile;
  const uint4 bq = bias_chunk<HDP>(qkv_bias + col(dm, h, 0), hd, tid);
  const uint4 bk = bias_chunk<HDP>(qkv_bias + col(dm, h, 1), hd, tid);
  const uint4 bv = bias_chunk<HDP>(qkv_bias + col(dm, h, 2), hd, tid);

  auto fill = [&](int qt, int stage) {
    unsigned char* Qs = ring + 2 * stage * kTileBytes;
    load_tile_async<HDP>(Qs, qsrc + static_cast<size_t>(qt) * kTile * S, S, hd, tid);
    load_tile_async<HDP>(Qs + kTileBytes, dosrc + static_cast<size_t>(qt) * kTile * CS, CS, hd,
                         tid);
    cp_async_commit();
  };
  load_tile_async<HDP>(Ks, slab + static_cast<size_t>(kt) * kTile * S + col(dm, h, 1), S, hd, tid);
  load_tile_async<HDP>(Vs, slab + static_cast<size_t>(kt) * kTile * S + col(dm, h, 2), S, hd, tid);
  int qt = kt;
  if (!SEG) fill(qt, 0);
  {  // the row statistics and mask words of the queries at or after this key
     // tile; a thread's loads are issued together: the block waits for memory once
    const int* msrc = static_cast<const int*>(mask) + static_cast<size_t>(b) * T;
    const size_t stat = (static_cast<size_t>(b) * H + h) * T;
    const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
    for (int i0 = kt * kTile + tid; i0 < T; i0 += 4 * kWG) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * kWG;
        if (i < T) {
          const int w = mask_word2<SEG>(msrc[i]);
          mrow[i] = w;
          qrow[i] = make_uint4(
              __float_as_uint(lse[stat + i] * kLog2e), __float_as_uint(dsum[stat + i]),
              DROP ? row_key(seed, static_cast<uint32_t>((b * H + h) * T + i)) : 0u,
              static_cast<uint32_t>(w));
        }
      }
    }
  }
  __syncthreads();
  if (SEG) {
    seg_tile_ranges(mrow, kt, n_tiles - 1, tlo, thi, tid);
    __syncthreads();
    qt = next_live_query<SEG>(tlo, thi, kt, kt, n_tiles);  // the diagonal tile is live
    fill(qt, 0);
  }
  const float scale2 = dm.scale * kLog2e;

  // this thread's two key rows
  const int jg[2] = {kt * kTile + 16 * warp + g, kt * kTile + 16 * warp + g + 8};
  const int wj[2] = {mrow[jg[0]], mrow[jg[1]]};
  float dk[NH][32], dv[NH][32];
#pragma unroll
  for (int nh = 0; nh < NH; ++nh)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[nh][e] = dv[nh][e] = 0.0f;

  int stage = 0;
  bool first = true;
  while (qt < n_tiles) {
    const int nx = next_live_query<SEG>(tlo, thi, qt + 1, kt, n_tiles);
    if (nx < n_tiles) {
      fill(nx, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unsigned char* Qs = ring + 2 * stage * kTileBytes;
    unsigned char* dOs = Qs + kTileBytes;
    if (first) {
      add_bias_tile<HDP>(Ks, bk, hd, tid);
      add_bias_tile<HDP>(Vs, bv, hd, tid);
    }
    first = false;
    add_bias_tile<HDP>(Qs, bq, hd, tid);
    fence_async_proxy();
    __syncthreads();

    float s[32], dp[32];
    wgmma_fence();
    product_nt<HDP>(s, Ks, Qs);    // rows: keys, columns: queries
    product_nt<HDP>(dp, Vs, dOs);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ig = qt * kTile + 8 * j8 + 2 * q4 + c;
        const uint4 qi = qrow[ig];
        const int wi = static_cast<int>(qi.w);
        const float li = __uint_as_float(qi.x), di = __uint_as_float(qi.y);
        const uint32_t rkey = qi.z;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int e = 4 * j8 + 2 * rr + c;
          float pd;
          dp[e] = bwd_element2<DROP>(s[e], dp[e], scale2, mask_term2<SEG>(wi, wj[rr]), li, di,
                                     rkey, static_cast<uint32_t>(jg[rr]), dm, &pd);
          s[e] = pd;
        }
      }
    if (qt == kt) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const bool dead = jg[(e >> 1) & 1] > qt * kTile + 8 * (e >> 2) + 2 * q4 + (e & 1);
        s[e] = dead ? 0.0f : s[e];
        dp[e] = dead ? 0.0f : dp[e];
      }
    }
    uint32_t fp[4][4], fs[4][4];
    to_fragments(fp, s);
    to_fragments(fs, dp);
    fence_regs(fp);
    fence_regs(fs);
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      fence_regs(dv[nh]);
      fence_regs(dk[nh]);
    }
    wgmma_fence();
    product_rn<HDP>(dv, fp, dOs);  // dv += bf16(pd^T) . do
    product_rn<HDP>(dk, fs, Qs);   // dk += bf16(ds^T) . q
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      fence_regs(dv[nh]);
      fence_regs(dk[nh]);
    }
    __syncthreads();  // the stage may be refilled
    qt = nx;
    stage ^= 1;
  }

  bf16* dst = dqkv + (static_cast<size_t>(b) * T + static_cast<size_t>(kt) * kTile) * S;
  // dk is staged in the key tile (no longer read) and leaves while dv is
  // staged in the value tile; the partial sums go through the ring
  float* scratch_k = reinterpret_cast<float*>(ring);
  float* scratch_v = scratch_k + 32 * (HDP + 8);
  stage_acc<HDP, true>(Ks, scratch_k, dk, tid);
  __syncthreads();
  flush_acc<HDP, true>(Ks, scratch_k, dst + col(dm, h, 1), S, dqb + col(dm, h, 1), hd, tid);
  stage_acc<HDP, true>(Vs, scratch_v, dv, tid);
  __syncthreads();
  flush_acc<HDP, true>(Vs, scratch_v, dst + col(dm, h, 2), S, dqb + col(dm, h, 2), hd, tid);
}

// ---- launchers: f32---------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// shared-memory words of the mask row and the tiles' segment-id ranges
constexpr size_t mask_words(int T) { return static_cast<size_t>(T) + 2 * (T / kTile); }

template <typename E, int HDP>
int launch_fwd(const void* qkv, const void* qkv_bias, const void* mask, const void* seed,
               void* ctx, void* lse, Dims dm, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(kTile) * (HDP + 1) +
                       static_cast<size_t>(kTile) * (fwd_cols(dm.T) + 1) + mask_words(dm.T)) *
                      sizeof(float);
  cudaError_t err = allow_smem(mha_fwd_kernel<E, HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dm.T / kTile, dm.H, dm.B);
  mha_fwd_kernel<E, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias), mask,
      static_cast<const int*>(seed), static_cast<E*>(ctx), static_cast<float*>(lse), dm);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int HDP>
int launch_bwd(const void* qkv, const void* qkv_bias, const void* mask, const void* seed,
               const void* ctx, const void* dout, const void* lse, void* dsum, void* dqkv,
               void* dqb, Dims dm, cudaStream_t stream) {
  const size_t tile = static_cast<size_t>(kTile) * (HDP + 1);
  const size_t smem_dq = (5 * tile + 2 * kTile + mask_words(dm.T)) * sizeof(float);
  const size_t smem_kv = (6 * tile + 2 * kTile + mask_words(dm.T)) * sizeof(float);
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<E, HDP>, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(mha_bwd_dkdv_kernel<E, HDP>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dm.T / kTile, dm.H, dm.B);
  mha_bwd_dq_kernel<E, HDP><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias), mask,
      static_cast<const int*>(seed), static_cast<const E*>(ctx), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dsum), static_cast<E*>(dqkv),
      static_cast<float*>(dqb), dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkdv_kernel<E, HDP><<<grid, kThreads, smem_kv, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias), mask,
      static_cast<const int*>(seed), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<E*>(dqkv),
      static_cast<float*>(dqb), dm);
  return static_cast<int>(cudaGetLastError());
}

// ---- launchers: bf16 ------------------------------------------------------
// tiles (1024-byte aligned inside the block's dynamic shared memory) + words
constexpr size_t tc_smem(int HDP, int tiles, size_t words) {
  return kAtomBytes + static_cast<size_t>(tiles) * kTile * HDP * 2 + words * 4;
}

// f(seg, dropout) with the two run-time flags as compile-time constants: each
// kernel holds the code of its own mask and of its own dropout setting only.
template <typename F>
int with_flags(const Dims& dm, F f) {
  if (dm.seg)
    return dm.dropout ? f(std::true_type(), std::true_type())
                      : f(std::true_type(), std::false_type());
  return dm.dropout ? f(std::false_type(), std::true_type())
                    : f(std::false_type(), std::false_type());
}

template <int HDP>
int launch_fwd_tc(const void* qkv, const void* qkv_bias, const void* mask, const void* seed,
                  void* ctx, void* lse, Dims dm, cudaStream_t stream) {
  return with_flags(dm, [&](auto seg, auto drop) {
    auto kernel = mha_fwd_tc_kernel<HDP, decltype(seg)::value, decltype(drop)::value>;
    const size_t smem = tc_smem(HDP, 5, mask_words(dm.T));
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(dm.T / kTile, dm.H, dm.B);
    kernel<<<grid, kWG, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(qkv_bias), mask,
        static_cast<const int*>(seed), static_cast<bf16*>(ctx), static_cast<float*>(lse), dm);
    return static_cast<int>(cudaGetLastError());
  });
}

template <int HDP>
int launch_bwd_tc(const void* qkv, const void* qkv_bias, const void* mask, const void* seed,
                  const void* ctx, const void* dout, const void* lse, void* dsum, void* dqkv,
                  void* dqb, Dims dm, cudaStream_t stream) {
  return with_flags(dm, [&](auto seg, auto drop) {
    auto dq_kernel = mha_bwd_dq_tc_kernel<HDP, decltype(seg)::value, decltype(drop)::value>;
    auto kv_kernel = mha_bwd_dkdv_tc_kernel<HDP, decltype(seg)::value, decltype(drop)::value>;
    const size_t smem_dq = tc_smem(HDP, 6, kTile + mask_words(dm.T));
    const size_t smem_kv = tc_smem(HDP, 6, 4 * dm.T + mask_words(dm.T));
    cudaError_t err = allow_smem(dq_kernel, smem_dq);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(kv_kernel, smem_kv);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(dm.T / kTile, dm.H, dm.B);
    dq_kernel<<<grid, kWG, smem_dq, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(qkv_bias), mask,
        static_cast<const int*>(seed), static_cast<const bf16*>(ctx),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(dsum), static_cast<bf16*>(dqkv), static_cast<float*>(dqb), dm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    kv_kernel<<<grid, kWG, smem_kv, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(qkv_bias), mask,
        static_cast<const int*>(seed), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dsum),
        static_cast<bf16*>(dqkv), static_cast<float*>(dqb), dm);
    return static_cast<int>(cudaGetLastError());
  });
}

// head_major == 0: the standard slab [B, T, 3*H*hd] and ctx [B, T, H*hd];
// head_major != 0: the head-major slab [B, T, H*384], hd == 128, ctx [B, T, H*128].
Dims make_dims(int B, int T, int H, int hd, int head_major, int seg, float scale,
               float inv_keep, unsigned thr, int dropout) {
  Dims dm;
  dm.B = B;
  dm.T = T;
  dm.H = H;
  dm.hd = hd;
  dm.S = 3 * H * hd;
  dm.hs = head_major ? 3 * hd : hd;
  dm.ps = head_major ? hd : H * hd;
  dm.CS = H * hd;
  dm.chs = hd;
  dm.seg = seg;
  dm.scale = scale;
  dm.inv_keep = inv_keep;
  dm.thr = thr;
  dm.dropout = dropout;
  return dm;
}

}  // namespace

// C entry points (bound with ctypes). qkv [B, T, 3*H*hd] and qkv_bias
// [3*H*hd] in float32 (dtype 0) or bfloat16 (dtype 1), in the standard order
// (q all heads | k all heads | v all heads) or, with head_major != 0, per head
// q | k | v (the caller passes hd = 128, the padded width); mask [B, T]: f32
// additive key biases or, with seg != 0, int32 segment ids; seed [1] int32 on
// the device; ctx [B, T, H*hd] in the slab's type; lse [B, H, T] f32. T is a
// multiple of 64, at most 1024; hd <= 128. dropout != 0 applies keep = hash >=
// thr and scales kept entries by inv_keep. Each returns the CUDA error code of
// its launches (0 on success). The caller validates shapes.
extern "C" int mmtg_mha_train_fwd(const void* qkv, const void* qkv_bias, const void* mask,
                                  const void* seed, void* ctx, void* lse, int B, int T, int H,
                                  int hd, int head_major, int seg, float scale, float inv_keep,
                                  unsigned thr, int dropout, int dtype, void* stream) {
  const Dims dm = make_dims(B, T, H, hd, head_major, seg, scale, inv_keep, thr, dropout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd <= 64) return launch_fwd_tc<64>(qkv, qkv_bias, mask, seed, ctx, lse, dm, s);
    return launch_fwd_tc<128>(qkv, qkv_bias, mask, seed, ctx, lse, dm, s);
  }
  if (hd <= 64) return launch_fwd<float, 64>(qkv, qkv_bias, mask, seed, ctx, lse, dm, s);
  return launch_fwd<float, 128>(qkv, qkv_bias, mask, seed, ctx, lse, dm, s);
}

// Backward: dout and ctx [B, T, H*hd]; dsum [B, H, T] f32 scratch; dqkv in the
// slab's shape and layout (every element is written); dqb [3*H*hd] f32,
// ZEROED by the caller, receives the bias gradient by atomic adds.
extern "C" int mmtg_mha_train_bwd(const void* qkv, const void* qkv_bias, const void* mask,
                                  const void* seed, const void* ctx, const void* dout,
                                  const void* lse, void* dsum, void* dqkv, void* dqb, int B,
                                  int T, int H, int hd, int head_major, int seg, float scale,
                                  float inv_keep, unsigned thr, int dropout, int dtype,
                                  void* stream) {
  const Dims dm = make_dims(B, T, H, hd, head_major, seg, scale, inv_keep, thr, dropout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd <= 64)
      return launch_bwd_tc<64>(qkv, qkv_bias, mask, seed, ctx, dout, lse, dsum, dqkv, dqb, dm,
                               s);
    return launch_bwd_tc<128>(qkv, qkv_bias, mask, seed, ctx, dout, lse, dsum, dqkv, dqb, dm, s);
  }
  if (hd <= 64)
    return launch_bwd<float, 64>(qkv, qkv_bias, mask, seed, ctx, dout, lse, dsum, dqkv, dqb,
                                 dm, s);
  return launch_bwd<float, 128>(qkv, qkv_bias, mask, seed, ctx, dout, lse, dsum, dqkv, dqb,
                                dm, s);
}
