// Fused causal self-attention for the TRAIN step: forward and backward.
//
// Replaces the TPU kernel pair of mmtg_tpu/ops/train_attention.py
// mha_train_packed (_fwd_kernel_packed launched by _fwd_call_packed,
// _bwd_kernel_packed launched by _bwd_call_packed).
//
// What it computes, for every batch row b and head h of the standard GPT-2
// c_attn slab qkv [B, T, 3*H*hd] (q all heads | k all heads | v all heads):
//   q, k, v = slab slices + qkv_bias slices, rounded to the slab's type
//   s       = (q . k^T) * scale + key_bias[b, j] + (j > i ? -1e30 : 0)   (f32)
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
// What bounds it on the H100: bytes. At B = 64, T = 256, H = 12, hd = 64 in
// bf16 the forward must read the 75.5 MB slab and write a 25.2 MB context
// (100.7 MB, 30 us at 3.35 TB/s) for 12.9 GFLOP of dense products (13 us at
// the bf16 tensor-core peak); the backward must read the slab and do and
// write dqkv (176 MB, 53 us) for 32 GFLOP (33 us). These kernels also read
// the saved ctx and log-sum-exp (26 MB more): their own choice, not part of
// the bound. The [T, T] probabilities stay on chip in both directions: that
// is the point of the kernel.
//
// Design (simple and right first; CUDA cores only, no wgmma / TMA yet):
//   * tiles of 64 rows. A block of 256 threads owns one (b, h, 64-row tile);
//     thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
//     tx + 16 j of every 64-wide product, operands sit in shared memory as
//     f32 with an odd leading dimension (no bank conflicts), sums are f32
//     FMAs in registers. Key tiles past the causal diagonal are skipped.
//   * forward: the block owns a QUERY tile, keeps its whole score row block
//     [64, T] in shared memory (T <= 512), soft-maxes it with one warp per 8
//     rows, then multiplies by V tile by tile. It also writes the rows'
//     log-sum-exp [B, H, T] f32 for the backward.
//   * backward in two kernels so that dq/dk/dv need no atomics and dqkv is
//     bit-reproducible: the dq kernel owns a QUERY tile and walks key tiles;
//     the dk/dv kernel owns a KEY tile and walks query tiles. Both recompute
//     p = exp(s - lse) and the same keep bits. D_i is taken as
//     sum_d do_id ctx_id (equal to sum_j dp_ij p_ij; ctx is the saved
//     output), computed by the dq kernel and handed on in a [B, H, T] buffer.
//   * only dqb uses atomics (f32, one add per block and column), so its last
//     bits change from run to run.
// Semantics note: a causally masked score is skipped, not added as -1e30. The
// two differ only for a query row whose every key j <= i is padded, which the
// model never produces (key 0 is always live).
// Known limits, left to later work: no tensor cores (the bf16 path could use
// wgmma), 2-byte loads, one block per (b, h, tile) without persistence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query / key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 (or 4 x 8) outputs each
constexpr int kLdT = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// x rounded to the element type E, as f32
template <typename E>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
  float scale, inv_keep;
  uint32_t thr;
  int dropout;
};

// ---- forward --------------------------------------------------------------
template <typename E, int HDP>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const E* __restrict__ qkv, const E* __restrict__ qkv_bias,
               const float* __restrict__ key_bias, const int* __restrict__ seed_ptr,
               E* __restrict__ ctx, float* __restrict__ lse, Dims dm) {
  constexpr int LD = HDP + 1;
  constexpr int NJ = HDP / 16;
  extern __shared__ float smem[];
  const int T = dm.T, H = dm.H, hd = dm.hd;
  const int lds = T + 1;
  float* Qs = smem;                 // [64, LD]
  float* KVs = Qs + kTile * LD;     // [64, LD]   K tile, then V tile
  float* Ss = KVs + kTile * LD;     // [64, T + 1] scores, then probabilities
  float* kbs = Ss + kTile * lds;    // [T] key bias of this batch row

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * hd;
  const size_t S3 = static_cast<size_t>(3) * HD;
  const E* slab = qkv + static_cast<size_t>(b) * T * S3;
  const int kv_len = (qt + 1) * kTile;

  for (int j = tid; j < kv_len; j += kThreads) kbs[j] = key_bias[static_cast<size_t>(b) * T + j];
  load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S3 + h * hd, S3,
                    qkv_bias + h * hd, hd, tid);

  for (int kc = 0; kc <= qt; ++kc) {
    load_tile<E, HDP>(KVs, slab + static_cast<size_t>(kc) * kTile * S3 + HD + h * hd, S3,
                      qkv_bias + HD + h * hd, hd, tid);
    __syncthreads();
    float acc[4][4] = {};
    gemm_nt<HDP>(acc, Qs, LD, KVs, LD, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * lds + kc * kTile + tx + 16 * j] = acc[i][j];
    __syncthreads();
  }

  // softmax (+ dropout): warp w owns rows 8w .. 8w + 7
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int ig = qt * kTile + r;
    float* row = Ss + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < kv_len; j += 32) {
      float x = row[j] * dm.scale + kbs[j];
      x += (j > ig) ? kNegInf : 0.0f;
      row[j] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < kv_len; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const uint32_t grow = static_cast<uint32_t>((b * H + h) * T + ig);
    const uint32_t rkey = row_key(seed, grow);
    for (int j = lane; j < kv_len; j += 32) {
      float p = row[j] / sum;
      if (dm.dropout) p = keep_bit(rkey, static_cast<uint32_t>(j), dm.thr) ? p * dm.inv_keep : 0.0f;
      row[j] = rnd<E>(p);
    }
    if (lane == 0) lse[(static_cast<size_t>(b) * H + h) * T + ig] = m + logf(sum);
  }
  __syncthreads();

  float out[4][NJ] = {};
  for (int kc = 0; kc <= qt; ++kc) {
    load_tile<E, HDP>(KVs, slab + static_cast<size_t>(kc) * kTile * S3 + 2 * HD + h * hd, S3,
                      qkv_bias + 2 * HD + h * hd, hd, tid);
    __syncthreads();
    gemm_nn<NJ>(out, Ss + kc * kTile, lds, KVs, LD, ty, tx);
    __syncthreads();
  }
  E* dst = ctx + (static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile) * HD + h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) stf(dst + static_cast<size_t>(ty + 16 * i) * HD + d, out[i][j]);
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
                  const float* __restrict__ key_bias, const int* __restrict__ seed_ptr,
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

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * hd;
  const size_t S3 = static_cast<size_t>(3) * HD;
  const E* slab = qkv + static_cast<size_t>(b) * T * S3;
  const size_t row0 = static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * T + static_cast<size_t>(qt) * kTile;

  load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S3 + h * hd, S3,
                    qkv_bias + h * hd, hd, tid);
  load_tile<E, HDP>(dOs, dout + row0 * HD + h * hd, HD, static_cast<const E*>(nullptr), hd, tid);
  {  // D_i = sum_d do_id * ctx_id, one warp per 8 rows
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const E* c = ctx + (row0 + r) * HD + h * hd;
      const E* g = dout + (row0 + r) * HD + h * hd;
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

  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  uint32_t rkey[4];
  float li[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    rkey[i] = row_key(seed, static_cast<uint32_t>((b * H + h) * T + qt * kTile + r));
    li[i] = rowL[r];
    di[i] = rowD[r];
  }

  float dq[4][NJ] = {};
  for (int kc = 0; kc <= qt; ++kc) {
    load_tile<E, HDP>(Ks, slab + static_cast<size_t>(kc) * kTile * S3 + HD + h * hd, S3,
                      qkv_bias + HD + h * hd, hd, tid);
    load_tile<E, HDP>(Vs, slab + static_cast<size_t>(kc) * kTile * S3 + 2 * HD + h * hd, S3,
                      qkv_bias + 2 * HD + h * hd, hd, tid);
    __syncthreads();
    float s[4][4] = {}, dpd[4][4] = {};
    gemm_nt<HDP>(s, Qs, LD, Ks, LD, ty, tx);
    gemm_nt<HDP>(dpd, dOs, LD, Vs, LD, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jg = kc * kTile + tx + 16 * j;
      const float kb = key_bias[static_cast<size_t>(b) * T + jg];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pd;
        const float ds = bwd_element(s[i][j], dpd[i][j], kb, qt * kTile + ty + 16 * i, jg,
                                     li[i], di[i], rkey[i], dm, &pd);
        dSs[(ty + 16 * i) * kLdT + tx + 16 * j] = rnd<E>(ds);
      }
    }
    __syncthreads();
    gemm_nn<NJ>(dq, dSs, kLdT, Ks, LD, ty, tx);
    __syncthreads();
  }

  E* dst = dqkv + row0 * S3 + h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) stf(dst + static_cast<size_t>(ty + 16 * i) * S3 + d, dq[i][j]);
    }
  column_sums_to<NJ>(dqb + h * hd, dq, dSs, hd, ty, tx, tid);
}

// ---- backward, dk and dv: one block per (b, h, KEY tile) --------------------
template <typename E, int HDP>
__global__ void __launch_bounds__(kThreads)
mha_bwd_dkdv_kernel(const E* __restrict__ qkv, const E* __restrict__ qkv_bias,
                    const float* __restrict__ key_bias, const int* __restrict__ seed_ptr,
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

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x;  // key tile 0 walks every query tile: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * hd;
  const size_t S3 = static_cast<size_t>(3) * HD;
  const E* slab = qkv + static_cast<size_t>(b) * T * S3;
  const int n_tiles = T / kTile;

  load_tile<E, HDP>(Ks, slab + static_cast<size_t>(kt) * kTile * S3 + HD + h * hd, S3,
                    qkv_bias + HD + h * hd, hd, tid);
  load_tile<E, HDP>(Vs, slab + static_cast<size_t>(kt) * kTile * S3 + 2 * HD + h * hd, S3,
                    qkv_bias + 2 * HD + h * hd, hd, tid);
  float kb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    kb[j] = key_bias[static_cast<size_t>(b) * T + kt * kTile + tx + 16 * j];
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  float dk[4][NJ] = {}, dv[4][NJ] = {};
  for (int qt = kt; qt < n_tiles; ++qt) {
    const size_t row0 = static_cast<size_t>(b) * T + static_cast<size_t>(qt) * kTile;
    const size_t stat0 = (static_cast<size_t>(b) * H + h) * T + static_cast<size_t>(qt) * kTile;
    load_tile<E, HDP>(Qs, slab + static_cast<size_t>(qt) * kTile * S3 + h * hd, S3,
                      qkv_bias + h * hd, hd, tid);
    load_tile<E, HDP>(dOs, dout + row0 * HD + h * hd, HD, static_cast<const E*>(nullptr), hd,
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd;
        const float ds = bwd_element(s[i][j], dpd[i][j], kb[j], ig, kt * kTile + tx + 16 * j,
                                     li, di, rkey, dm, &pd);
        Ps[r * kLdT + tx + 16 * j] = rnd<E>(pd);
        dSs[r * kLdT + tx + 16 * j] = rnd<E>(ds);
      }
    }
    __syncthreads();
    gemm_tn<NJ>(dv, Ps, kLdT, dOs, LD, ty, tx);   // rows: keys, cols: d
    gemm_tn<NJ>(dk, dSs, kLdT, Qs, LD, ty, tx);
    __syncthreads();
  }

  E* dst = dqkv + (static_cast<size_t>(b) * T + static_cast<size_t>(kt) * kTile) * S3 + h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        stf(dst + static_cast<size_t>(ty + 16 * i) * S3 + HD + d, dk[i][j]);
        stf(dst + static_cast<size_t>(ty + 16 * i) * S3 + 2 * HD + d, dv[i][j]);
      }
    }
  column_sums_to<NJ>(dqb + HD + h * hd, dk, Ps, hd, ty, tx, tid);
  column_sums_to<NJ>(dqb + 2 * HD + h * hd, dv, Ps, hd, ty, tx, tid);
}

// ---- launchers ------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int HDP>
int launch_fwd(const void* qkv, const void* qkv_bias, const void* key_bias, const void* seed,
               void* ctx, void* lse, Dims dm, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(kTile) * (HDP + 1) + static_cast<size_t>(kTile) * (dm.T + 1) + dm.T) *
      sizeof(float);
  cudaError_t err = allow_smem(mha_fwd_kernel<E, HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dm.T / kTile, dm.H, dm.B);
  mha_fwd_kernel<E, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias),
      static_cast<const float*>(key_bias), static_cast<const int*>(seed),
      static_cast<E*>(ctx), static_cast<float*>(lse), dm);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int HDP>
int launch_bwd(const void* qkv, const void* qkv_bias, const void* key_bias, const void* seed,
               const void* ctx, const void* dout, const void* lse, void* dsum, void* dqkv,
               void* dqb, Dims dm, cudaStream_t stream) {
  const size_t tile = static_cast<size_t>(kTile) * (HDP + 1);
  const size_t smem_dq = (5 * tile + 2 * kTile) * sizeof(float);
  const size_t smem_kv = (6 * tile + 2 * kTile) * sizeof(float);
  cudaError_t err = allow_smem(mha_bwd_dq_kernel<E, HDP>, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(mha_bwd_dkdv_kernel<E, HDP>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(dm.T / kTile, dm.H, dm.B);
  mha_bwd_dq_kernel<E, HDP><<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias),
      static_cast<const float*>(key_bias), static_cast<const int*>(seed),
      static_cast<const E*>(ctx), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dsum), static_cast<E*>(dqkv),
      static_cast<float*>(dqb), dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkdv_kernel<E, HDP><<<grid, kThreads, smem_kv, stream>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qkv_bias),
      static_cast<const float*>(key_bias), static_cast<const int*>(seed),
      static_cast<const E*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<E*>(dqkv), static_cast<float*>(dqb), dm);
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int B, int T, int H, int hd, float scale, float inv_keep, unsigned thr,
               int dropout) {
  Dims dm;
  dm.B = B;
  dm.T = T;
  dm.H = H;
  dm.hd = hd;
  dm.scale = scale;
  dm.inv_keep = inv_keep;
  dm.thr = thr;
  dm.dropout = dropout;
  return dm;
}

}  // namespace

// C entry points (bound with ctypes). qkv [B, T, 3*H*hd] and qkv_bias
// [3*H*hd] in float32 (dtype 0) or bfloat16 (dtype 1); key_bias [B, T] f32;
// seed [1] int32 on the device; ctx [B, T, H*hd] in the slab's type; lse
// [B, H, T] f32. T is a multiple of 64, hd <= 128. dropout != 0 applies
// keep = hash >= thr and scales kept entries by inv_keep. Each returns the
// CUDA error code of its launches (0 on success). The caller validates shapes.
extern "C" int mmtg_mha_train_packed_fwd(const void* qkv, const void* qkv_bias,
                                         const void* key_bias, const void* seed, void* ctx,
                                         void* lse, int B, int T, int H, int hd, float scale,
                                         float inv_keep, unsigned thr, int dropout, int dtype,
                                         void* stream) {
  const Dims dm = make_dims(B, T, H, hd, scale, inv_keep, thr, dropout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd <= 64)
      return launch_fwd<__nv_bfloat16, 64>(qkv, qkv_bias, key_bias, seed, ctx, lse, dm, s);
    return launch_fwd<__nv_bfloat16, 128>(qkv, qkv_bias, key_bias, seed, ctx, lse, dm, s);
  }
  if (hd <= 64) return launch_fwd<float, 64>(qkv, qkv_bias, key_bias, seed, ctx, lse, dm, s);
  return launch_fwd<float, 128>(qkv, qkv_bias, key_bias, seed, ctx, lse, dm, s);
}

// Backward: dout and ctx [B, T, H*hd]; dsum [B, H, T] f32 scratch; dqkv
// [B, T, 3*H*hd] (every element is written); dqb [3*H*hd] f32, ZEROED by the
// caller, receives the bias gradient by atomic adds.
extern "C" int mmtg_mha_train_packed_bwd(const void* qkv, const void* qkv_bias,
                                         const void* key_bias, const void* seed,
                                         const void* ctx, const void* dout, const void* lse,
                                         void* dsum, void* dqkv, void* dqb, int B, int T, int H,
                                         int hd, float scale, float inv_keep, unsigned thr,
                                         int dropout, int dtype, void* stream) {
  const Dims dm = make_dims(B, T, H, hd, scale, inv_keep, thr, dropout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd <= 64)
      return launch_bwd<__nv_bfloat16, 64>(qkv, qkv_bias, key_bias, seed, ctx, dout, lse, dsum,
                                           dqkv, dqb, dm, s);
    return launch_bwd<__nv_bfloat16, 128>(qkv, qkv_bias, key_bias, seed, ctx, dout, lse, dsum,
                                          dqkv, dqb, dm, s);
  }
  if (hd <= 64)
    return launch_bwd<float, 64>(qkv, qkv_bias, key_bias, seed, ctx, dout, lse, dsum, dqkv, dqb,
                                 dm, s);
  return launch_bwd<float, 128>(qkv, qkv_bias, key_bias, seed, ctx, dout, lse, dsum, dqkv, dqb,
                                dm, s);
}
