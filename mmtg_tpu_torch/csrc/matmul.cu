// Batch-invariant dense product: out[z, m, n] = sum_k x[z, m, k] w[z, k, n]
// (+ bias[n]), rounded to x's type as `x @ w + bias` rounds (the product once,
// then the sum with the bias once).
//
// Replaces no TPU kernel. It was added so that the decode's products give one
// row the same bits whatever the number of rows M beside it: the JAX package
// promises that a (request, seed) decodes to the same tokens in any batch, and
// cuBLAS, which `torch.matmul` calls on the card, picks its kernel, its tile
// and its split of K by the shape, M included. Here the split of K, the
// column tile and the instruction are set by a plan (ops/matmul.plan) that
// is a function of (K, N, dtype) and the card's SM count alone; a row's
// inputs are the only rows it reads. So each output's summation tree is the
// same at any M.
//
// What bounds it on the H100: at the decode's M (1-512 rows) bytes, the
// weight matrix read once ([K, N] at 2 or 4 bytes a value; 4.7 MB for the MLP
// output product at D = 768 in bf16), against 2 M K N operations; from M of
// about 300 (bf16) operations. A block streams its tiles through a cp.async
// ring at a few tens of GB/s and spends ~0.5 us a 64-value stage (measured,
// PERF.md), so one block a 64-column tile walking all of K (12 blocks for
// N = 768) is bound by its chain of stages, not by the card's bytes.
//
// Design, path "tiled" (bf16): ops/matmul.plan cuts the weight columns into
// tiles of BN (64 or 32) and K into R ranges of `spr` whole 64-value stages.
// Range r's partial sums p_r are one mma chain from zero over its stages in
// order; every output is p_0 + p_1 + ... + p_{R-1}, added left to right in
// f32, then rounded to bf16 (and again after + bias). Two forms compute
// exactly that, and the launch picks one by the number of tiles (a function
// of M, which the sums are not):
//   * the cluster form (few tiles: the decode's M): the R blocks of a
//     thread-block cluster take one range each, with `slots` stages in
//     flight, so tiles x ranges fill the card. Each writes its f32 partial
//     tile to its shared memory and pushes each group of 4 sums to the block
//     that owns it (distributed shared memory); after the cluster barrier
//     each block adds its share over the ranges in index order. No workspace,
//     no counter, no atomic: nothing outlives the launch.
//   * the one-block form (many tiles: the prefill, B = 512): one block a tile
//     walks the ranges in order and adds each p_r to its running sum as the
//     range ends; 128 input rows a block when the tiles are many.
// A block: BN / 16 warps, one 16-column slice of the weights each, on
// mma.sync.m16n8k16 with f32 accumulation, the weights as the 16-row side
// (ldmatrix.trans for [K, N] rows, plain ldmatrix for a weight stored as
// [N, K], as the tied LM head is) and the input rows as the 8-wide side, as
// the whole-step kernel (decode_block_fused.cu) does: at M = 1 it wastes 7/8
// of a narrow side, not 15/16 of a wide one. Pieces of 8 rows past M are
// skipped; the others do not depend on them, so a row's bits are the same in
// any tile and at any M. A thread's copies of a stage are set up once
// (StageLoader): zero-filled past the edges of M, N and K.
// Path "tiled" (f32, the parity path): CUDA-core FMAs (no TF32), a thread a
// 4 x 4 block of outputs summed over k in order, one range (no split).
// Path "small" (K <= 32, both types: the prefill's per-head probs @ v, the
// beta attention's K = 3 mix): a block a tile of up to 64 rows x 256 columns
// of one batch entry, x and w staged in shared memory as f32, each output one
// FMA chain over k in order; no tile of zero rows for a batch entry of one.
// A batch axis z (grid.z, grid.y on the small path) for the attention's
// per-head products, with its own strides; the plan never depends on it.
//
// Two modes of the tiled paths keep a tensor-parallel product's sums those
// of one device. A row-parallel rank holds a K slice that covers a run of
// the full plan's ranges (ops/matmul.shard_plan). `acc` (f32 [M, N]) is the
// fold its ranges start from: every output is acc + p_a + p_{a+1} + ...,
// left to right, in both bf16 forms (the cluster form adds acc before the
// first range's partial, not after the fold), and the f32 path's FMA chain
// over k starts from it. `partial` writes the fold in f32 to out, before the
// rounding and without the bias. Rank 0 runs `partial`, each next rank
// `acc` + `partial`, the last `acc` alone and rounds once:
// ((p0 + p1) + p2) + p3 on one device or on two.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;          // input rows a block (tiled)
constexpr int kStagesF32 = 4;    // the f32 kernel's ring
constexpr int kMaxSlots = 4;     // the bf16 ring's slots at most
constexpr int kMaxRanges = 16;   // K ranges at most: Hopper's largest cluster
// the one-block form from this many 64-row tiles (x column tiles x batch) up
constexpr int kOneBlockTiles = 66;
// ... and its 128-row tiles from this many of them up. Measured against the
// 64-row tiles (tools/matmul_plans.py, forms 3 and 2; H100 80GB HBM3, 700 W):
// faster on the LM head at M = 512 (836 wide tiles: 78.8 against 87.7 us) and
// at the B = 512 prefill's 8192 rows (mlp_proj 203 against 250 us; qkv,
// mlp_fc, attn_proj within 1.5%), slower below (M = 512, 144 wide tiles of
// mlp_proj: 49.1 against 30.8 us; blocks of up to 255 registers are too few
// to keep the loads in flight)
constexpr int kWideTiles = 512;
constexpr int kPad = 16;         // bytes after each staged row: no bank conflicts
constexpr int kSmallK = 32;      // the small path's K at most
constexpr int kSmallRows = 64;   // the small path's tile: rows
constexpr int kSmallCols = 256;  // ... and columns
constexpr int kSmallThreads = 256;
constexpr int kMaxDynamicSmem = 232448;  // what a block may ask for on Hopper

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* out;        // T, or f32 with `partial`
  const float* acc; // f32 [M, N] the fold starts from, or null
  int partial;      // 1: out is the f32 fold, unrounded, no bias
  int Z, M, N, K;
  long long sx, sw, so;  // batch strides, in elements
  int spr;               // K stages a range
  int ranges;            // K ranges: the blocks of a cluster
  int slots;             // stages in flight (bf16 ring)
  int cluster;           // bf16: blocks a column tile's ranges take (the launch sets it)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with `ok` false the 16 bytes are zeros
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// at most n (block-uniform, below kMaxSlots) groups still pending
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBK = 64, kVec = 8;
};
template <>
struct Cfg<float> {
  static constexpr int kBK = 32, kVec = 4;
};

// Bytes of one stage's tiles: weights (either layout) and input rows.
template <typename T, int BN>
__host__ __device__ constexpr int tile_bytes() {
  constexpr int kk = Cfg<T>::kBK * static_cast<int>(sizeof(T)) + kPad;  // a row of K values
  constexpr int nn = BN * static_cast<int>(sizeof(T)) + kPad;           // a row of N values
  constexpr int w_kn = Cfg<T>::kBK * nn, w_nk = BN * kk;
  return w_kn > w_nk ? w_kn : w_nk;
}
template <typename T, int BN>
__host__ __device__ constexpr int stage_bytes() {
  return tile_bytes<T, BN>() + kBM * (Cfg<T>::kBK * static_cast<int>(sizeof(T)) + kPad);
}
// Queue the copies of K stage `kt` into `st`: the weight tile (rows of N
// values for [K, N], rows of K values for [N, K]) and the input rows.
template <typename T, int BN, bool TRANS, int NT>
__device__ __forceinline__ void load_stage(const T* x, const T* w, int M, int N, int K, int m0,
                                           int n0, int kt, unsigned char* st, int tid) {
  constexpr int BK = Cfg<T>::kBK, V = Cfg<T>::kVec;
  constexpr int E = static_cast<int>(sizeof(T));
  const int k0 = kt * BK;
  unsigned char* ws = st;
  unsigned char* xs = st + tile_bytes<T, BN>();
  if constexpr (TRANS) {  // w is [N, K]: BN rows of BK values
    constexpr int CPR = BK / V;
    for (int c = tid; c < BN * CPR; c += NT) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = n0 + r < N && k0 + cc * V < K;
      cp_async16(ws + r * (BK * E + kPad) + cc * 16,
                 ok ? w + static_cast<size_t>(n0 + r) * K + k0 + cc * V : w, ok);
    }
  } else {  // w is [K, N]: BK rows of BN values
    constexpr int CPR = BN / V;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = k0 + r < K && n0 + cc * V < N;
      cp_async16(ws + r * (BN * E + kPad) + cc * 16,
                 ok ? w + static_cast<size_t>(k0 + r) * N + n0 + cc * V : w, ok);
    }
  }
  constexpr int CPR = BK / V;
  for (int c = tid; c < kBM * CPR; c += NT) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = m0 + r < M && k0 + cc * V < K;
    cp_async16(xs + r * (BK * E + kPad) + cc * 16,
               ok ? x + static_cast<size_t>(m0 + r) * K + k0 + cc * V : x, ok);
  }
}

// bf16 tiles: a stage holds the weight tile (either layout) and BM input
// rows of 64 values
template <int BN, int BM>
__host__ __device__ constexpr int bf16_stage_bytes() {
  return tile_bytes<__nv_bfloat16, BN>() + BM * (64 * 2 + kPad);
}

// The bf16 stage copies of one thread, set up once: a thread's chunks of
// a tile share one 16-byte column and step down the rows, so a stage is a
// few pointer increments (the general load_stage spends ~18 instructions a
// copy on the address and the bounds).
template <int BN, bool TRANS, int BM>
struct StageLoader {
  using T = __nv_bfloat16;
  static constexpr int NT = 2 * BN, BK = 64, kRowX = BK * 2 + kPad;
  static constexpr int kRowW = TRANS ? BK * 2 + kPad : BN * 2 + kPad;
  static constexpr int CPW = TRANS ? BK / 8 : BN / 8;  // 16-byte chunks a weight row
  static constexpr int WC = (TRANS ? BN : BK) * CPW / NT, WS = NT / CPW;  // copies, row step
  static constexpr int XC = BM * (BK / 8) / NT, XS = NT / (BK / 8);
  const T* wp;  // this thread's first weight chunk at stage 0
  const T* xp;
  long long w_row, w_stage;  // elements between its weight rows, between stages
  int K, wk, xk;             // K, and the K offset of its chunks in a stage
  unsigned w_dst, x_dst, w_ok, x_ok;  // first destinations; rows in bounds (a bit each)
  __device__ StageLoader(const T* x, const T* w, int M, int N, int K_, int m0, int n0, int tid)
      : K(K_) {
    const int wr = tid / CPW, wc = tid % CPW, xr = tid / (BK / 8), xc = tid % (BK / 8);
    w_ok = x_ok = 0;
    if (TRANS) {  // rows of K values, one row per column n
      wp = w + static_cast<size_t>(n0 + wr) * K + wc * 8;
      w_row = static_cast<long long>(WS) * K;
      w_stage = BK;
      wk = wc * 8;
      for (int i = 0; i < WC; ++i) w_ok |= (n0 + wr + i * WS < N ? 1u : 0u) << i;
    } else {  // rows of N values, one row per k
      wp = w + static_cast<size_t>(wr) * N + n0 + wc * 8;
      w_row = static_cast<long long>(WS) * N;
      w_stage = static_cast<long long>(BK) * N;
      wk = wr;  // (+ i * WS)
      w_ok = n0 + wc * 8 < N ? (1u << WC) - 1 : 0u;
    }
    w_dst = wr * kRowW + wc * 16;
    xp = x + static_cast<size_t>(m0 + xr) * K + xc * 8;
    xk = xc * 8;
    for (int i = 0; i < XC; ++i) x_ok |= (m0 + xr + i * XS < M ? 1u : 0u) << i;
    x_dst = tile_bytes<T, BN>() + xr * kRowX + xc * 16;
  }
  // queue stage kt's copies into `st` (zeros past M, N and K)
  __device__ __forceinline__ void issue(int kt, unsigned char* st) const {
    const int k0 = kt * BK;
    const bool tail = k0 + BK > K;  // only K's last stage may be partial
    const T* w = wp + kt * w_stage;
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      bool ok = (w_ok >> i) & 1;
      if (tail) ok = ok && k0 + (TRANS ? wk : wk + i * WS) < K;
      cp_async16(st + w_dst + i * WS * kRowW, ok ? w + i * w_row : wp, ok);
    }
    const T* x = xp + k0;
    const bool xk_ok = !tail || k0 + xk < K;
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const bool ok = ((x_ok >> i) & 1) && xk_ok;
      cp_async16(st + x_dst + i * XS * kRowX, ok ? x + static_cast<long long>(i) * XS * K : xp, ok);
    }
  }
};

// ---- bf16: mma.sync, a warp a 16-column slice --------------------------------

template <int BN, bool TRANS, int PIECES>
__device__ __forceinline__ void mma_stage(const unsigned char* st, int pieces,
                                          float (&c)[PIECES][4], int warp) {
  using T = __nv_bfloat16;
  constexpr int BK = Cfg<T>::kBK;
  constexpr int kRow = BK * 2 + kPad, nRow = BN * 2 + kPad;
  const int lane = threadIdx.x & 31;
  const int mat = lane >> 3, r8 = lane & 7;
  const unsigned char* ws = st;
  const unsigned char* xs = st + tile_bytes<T, BN>();
  // the lane's row address in the weight tile's A fragment (16 columns x 16 k)
  const unsigned char* arow =
      TRANS ? ws + (warp * 16 + ((mat & 1) << 3) + r8) * kRow + ((mat >> 1) << 3) * 2
            : ws + (r8 + ((mat >> 1) << 3)) * nRow + (warp * 16 + ((mat & 1) << 3)) * 2;
  // two pieces of 8 input rows a ldmatrix.x4: matrices 0, 1 the first
  // piece's k 0-7 and 8-15, matrices 2, 3 the second's
  const unsigned char* brow = xs + (((mat >> 1) << 3) + r8) * kRow + ((mat & 1) << 3) * 2;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    unsigned a0, a1, a2, a3;
    if constexpr (TRANS)
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(arow + kk * 32)));
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(arow + kk * 16 * nRow)));
    // every piece's fragment first, then the products: the loads overlap
    unsigned b[PIECES][2];
#pragma unroll
    for (int j = 0; j < PIECES; j += 2) {
      if (j < pieces)  // warp-uniform: a piece of 8 rows holds a row below M
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                     : "=r"(b[j][0]), "=r"(b[j][1]), "=r"(b[j + 1][0]), "=r"(b[j + 1][1])
                     : "r"(smem_addr(brow + j * 8 * kRow + kk * 32)));
    }
#pragma unroll
    for (int j = 0; j < PIECES; ++j) {
      if (j < pieces)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[j][0]), "r"(b[j][1]));
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the cluster's barrier in two halves: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Shared memory of the cluster form beside the ring: the partial tile
// [64][BN + 4] f32 and a receive buffer of a 64 x BN tile's groups of 4 f32
// sums (a block's share, from every range).
template <int BN>
__host__ __device__ constexpr int part_bytes() {
  return kBM * (BN + 4) * 4;
}
template <int BN>
__host__ __device__ constexpr int recv_bytes() {
  return (kBM * BN / 4 + kMaxRanges) * 16;
}

// The bf16 tiled product of a BN-column x (8 PIECES)-row tile. Each K range
// r's partial sums p_r are an mma chain from zero over the range's stages in
// order; every output is p_0 + p_1 + ... + p_{R-1}, added left to right in
// f32. Two forms give the same bits (the launch picks one by the number of
// tiles): the cluster form, where the R blocks of a cluster each compute one
// p_r and add the ranges through distributed shared memory (PIECES = 8), and
// the one-block form, where one block walks the ranges in order and adds
// each p_r to its sum as it ends.
template <int BN, bool TRANS, int PIECES>
__global__ void __launch_bounds__(2 * BN) matmul_bf16_kernel(const Args a) {
  using T = __nv_bfloat16;
  constexpr int BK = Cfg<T>::kBK, NT = 2 * BN, BM = 8 * PIECES, SB = bf16_stage_bytes<BN, BM>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.cluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int crank = blockIdx.x % C;  // the block's rank in its cluster
  const int n0 = (blockIdx.x / C) * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + z * a.sx;
  const T* w = static_cast<const T*>(a.w) + z * a.sw;
  T* out = static_cast<T*>(a.out) + z * a.so;
  float* part_out = static_cast<float*>(a.out) + z * a.so;  // with a.partial
  const T* bias = static_cast<const T*>(a.bias);
  const int nk = (a.K + BK - 1) / BK;
  const int pieces = min(PIECES, (a.M - m0 + 7) / 8);
  // this block's ranges: its own (cluster form) or all, in order (one block)
  const int r0 = C > 1 ? crank : 0, r1 = C > 1 ? crank + 1 : a.ranges;
  const int units = min(nk, r1 * a.spr) - r0 * a.spr;  // its stages, streamed through the ring
  const int pre = min(a.slots, units);
  const StageLoader<BN, TRANS, BM> loader(x, w, a.M, a.N, a.K, m0, n0, threadIdx.x);
  int lstage = r0 * a.spr, lslot = 0;  // the next stage to load, its slot
  auto load_next = [&]() {
    loader.issue(lstage++, smem + lslot * SB);
    cp_commit();
    if (++lslot == a.slots) lslot = 0;
  };
  for (int u = 0; u < pre; ++u) load_next();
  float acc[PIECES][4];  // one-block form: the ranges' partial sums so far
  float c[PIECES][4];
  // the one-block form's fold starts from `a.acc` where there is one
  const bool from_acc = a.acc != nullptr && C == 1;
  if (from_acc) {
    const int n = n0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < PIECES; ++q) {
      const int b = m0 + q * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int bb = b + (i & 1), nn = n + (i >> 1) * 8;
        acc[q][i] = bb < a.M && nn < a.N ? a.acc[static_cast<size_t>(bb) * a.N + nn] : 0.0f;
      }
    }
  }
  int u = 0, slot = 0;
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int q = 0; q < PIECES; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[q][i] = 0.0f;
    const int ns = min(nk, (r + 1) * a.spr) - r * a.spr;
    for (int s = 0; s < ns; ++s, ++u) {
      cp_wait_upto(pre - 1);  // stage u has landed (this thread's copies; one group a stage)
      __syncthreads();        // ... and every thread's
      mma_stage<BN, TRANS, PIECES>(smem + slot * SB, pieces, c, warp);
      if (u + pre < units) {  // (then pre == slots) stage u + pre takes this slot
        __syncthreads();
        load_next();
      } else {
        cp_commit();  // one group a stage: the wait above counts on it
      }
      if (++slot == a.slots) slot = 0;
    }
    if (C == 1) {
#pragma unroll
      for (int q = 0; q < PIECES; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[q][i] = r == 0 && !from_acc ? c[q][i] : acc[q][i] + c[q][i];
    }
  }
  if (C == 1) {  // the one-block form rounds its sum
    const int n = n0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < PIECES; ++q) {
      const int b = m0 + q * 8 + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int bb = b + (i & 1), nn = n + (i >> 1) * 8;
        if (bb < a.M && nn < a.N) {
          if (a.partial) {
            part_out[static_cast<size_t>(bb) * a.N + nn] = acc[q][i];
            continue;
          }
          float y = round_bf16(acc[q][i]);
          if (bias != nullptr) y = round_bf16(y + __bfloat162float(bias[nn]));
          out[static_cast<size_t>(bb) * a.N + nn] = __float2bfloat16_rn(y);
        }
      }
    }
    return;
  }
  if constexpr (PIECES == 8) {
    // The cluster form: the partial tile over this block's ring, each group
    // of 4 sums pushed to the block that owns it, then each block adds its
    // share over the ranges in index order. The receive buffer lies after
    // the partial tile, inside the ring's bytes: peers write it only after
    // every block is done with its ring (the barrier's first phase).
    constexpr int PS = BN + 4;  // the partial tile's row stride in floats
    constexpr int G = BN / 4;   // groups of 4 columns a row
    float* part = reinterpret_cast<float*>(smem);
    float4* recv = reinterpret_cast<float4*>(smem + part_bytes<BN>());
    cp_wait<0>();
    __syncthreads();
    cluster_arrive();  // this block's ring is free
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < pieces) {
        const int b = q * 8 + 2 * (lane & 3), n = warp * 16 + (lane >> 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) part[(b + (i & 1)) * PS + n + (i >> 1) * 8] = c[q][i];
      }
    }
    __syncthreads();
    const int groups = min(kBM, a.M - m0) * G;
    const int per = (groups + a.ranges - 1) / a.ranges;  // a block's share
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();  // every block's ring is free
    for (int g = threadIdx.x; g < groups; g += NT) {  // each group to its owner
      const int owner = g / per;
      const float4 v = *reinterpret_cast<const float4*>(part + (g / G) * PS + (g % G) * 4);
      *cluster.map_shared_rank(recv + crank * per + g - owner * per, owner) = v;
    }
    cluster_arrive();
    cluster_wait();  // every range's share has landed
    const int lo = crank * per, hi = min(groups, lo + per);
    for (int g = lo + threadIdx.x; g < hi; g += NT) {
      const int col = n0 + (g % G) * 4, row = m0 + g / G;
      float4 t = recv[g - lo];
      if (a.acc != nullptr) {  // the fold so far, before range 0's partial
        const float* ar = a.acc + static_cast<size_t>(row) * a.N;
        t.x = (col < a.N ? ar[col] : 0.0f) + t.x;
        t.y = (col + 1 < a.N ? ar[col + 1] : 0.0f) + t.y;
        t.z = (col + 2 < a.N ? ar[col + 2] : 0.0f) + t.z;
        t.w = (col + 3 < a.N ? ar[col + 3] : 0.0f) + t.w;
      }
#pragma unroll
      for (int q = 1; q < kMaxRanges; ++q) {  // the ranges in index order
        if (q < a.ranges) {
          const float4 v = recv[q * per + g - lo];
          t.x += v.x;
          t.y += v.y;
          t.z += v.z;
          t.w += v.w;
        }
      }
      const float tv[4] = {t.x, t.y, t.z, t.w};
      T* o = out + static_cast<size_t>(row) * a.N;
      float* po = part_out + static_cast<size_t>(row) * a.N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (col + i < a.N) {
          if (a.partial) {
            po[col + i] = tv[i];
            continue;
          }
          float y = round_bf16(tv[i]);
          if (bias != nullptr) y = round_bf16(y + __bfloat162float(bias[col + i]));
          o[col + i] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// ---- f32: CUDA-core FMAs, a thread a 4 x 4 block ------------------------------

template <bool TRANS>
__global__ void __launch_bounds__(256) matmul_f32_kernel(const Args a) {
  using T = float;
  constexpr int BK = Cfg<T>::kBK, BN = 64, NT = 256, SB = stage_bytes<T, BN>();
  constexpr int kRow = BK + kPad / 4, nRow = BN + kPad / 4;  // in floats
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + z * a.sx;
  const T* w = static_cast<const T*>(a.w) + z * a.sw;
  T* out = static_cast<T*>(a.out) + z * a.so;
  const int nk = (a.K + BK - 1) / BK;
  const int tn = threadIdx.x % (BN / 4), tm = threadIdx.x / (BN / 4);
  // a thread whose four rows all lie past M stages its share of the tiles
  // and waits at the barriers, but sums nothing (a row's sums do not change)
  const bool live = m0 + tm * 4 < a.M;
  float acc[4][4];  // each chain starts from `a.acc` where there is one
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = m0 + tm * 4 + i, n = n0 + tn * 4 + j;
      acc[i][j] = a.acc != nullptr && b < a.M && n < a.N
                      ? a.acc[static_cast<size_t>(b) * a.N + n] : 0.0f;
    }
#pragma unroll
  for (int s = 0; s < kStagesF32 - 1; ++s) {
    if (s < nk)
      load_stage<T, BN, TRANS, NT>(x, w, a.M, a.N, a.K, m0, n0, s, smem + s * SB, threadIdx.x);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStagesF32 - 2>();
    __syncthreads();
    const unsigned char* st = smem + (kt % kStagesF32) * SB;
    const float* ws = reinterpret_cast<const float*>(st);
    const float* xs = reinterpret_cast<const float*>(st + tile_bytes<T, BN>()) + tm * 4 * kRow;
    if (live) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float wv[4];
        if constexpr (TRANS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = ws[(tn * 4 + j) * kRow + k];
        } else {
          const float4 w4 = *reinterpret_cast<const float4*>(ws + k * nRow + tn * 4);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[i * kRow + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
    const int next = kt + kStagesF32 - 1;
    if (next < nk)
      load_stage<T, BN, TRANS, NT>(x, w, a.M, a.N, a.K, m0, n0, next,
                                   smem + (next % kStagesF32) * SB, threadIdx.x);
    cp_commit();
  }
  cp_wait<0>();
  const float* bias = static_cast<const float*>(a.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (b < a.M && n < a.N)  // (a partial has no bias: the same f32 value)
        out[static_cast<size_t>(b) * a.N + n] =
            acc[i][j] + (bias != nullptr && !a.partial ? bias[n] : 0.0f);
    }
  }
}

// ---- small K: a thread two columns, an FMA chain an output --------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the sum rounded as `x @ w + bias` rounds it
__device__ __forceinline__ float finish(float s, float b, bool has_bias, float) {
  return has_bias ? s + b : s;
}
__device__ __forceinline__ __nv_bfloat16 finish(float s, float b, bool has_bias, __nv_bfloat16) {
  float v = round_bf16(s);
  if (has_bias) v = round_bf16(v + b);
  return __float2bfloat16_rn(v);
}

// The small path's shared memory, in floats: x's tile [rows][K] (rounded up to
// 16 bytes), then w's [K][ws_row] (a row of up to kSmallCols columns, rounded
// up to 4: a thread reads 4 columns as one float4).
__host__ __device__ inline int small_ws_row(int N) {
  return ((N < kSmallCols ? N : kSmallCols) + 3) / 4 * 4;
}
__host__ __device__ inline int small_xs_floats(int M, int K) {
  return ((M < kSmallRows ? M : kSmallRows) * K + 3) / 4 * 4;
}

// a block: a tile of up to kSmallRows rows x kSmallCols columns of one batch
// entry (then the next entry grid.y further); x and w in shared memory as f32,
// read 16 bytes a load where the rows allow; a thread 4 neighbouring outputs
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kSmallThreads) matmul_small_kernel(const Args a) {
  constexpr int VW = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
  // the tiles as the shape needs them: x [rows][K], then w [K][ws_row]
  extern __shared__ __align__(16) float small_smem[];
  const int ws_row = small_ws_row(a.N);
  float* xs = small_smem;
  float* ws = small_smem + small_xs_floats(a.M, a.K);
  const int col_tiles = (a.N + kSmallCols - 1) / kSmallCols;
  const int n0 = (blockIdx.x % col_tiles) * kSmallCols, m0 = (blockIdx.x / col_tiles) * kSmallRows;
  const int rows = min(kSmallRows, a.M - m0), cols = min(kSmallCols, a.N - n0);
  const T* bias = static_cast<const T*>(a.bias);
  // whole 16-byte pieces: x's rows (a tile of x is contiguous), w's rows
  const bool x_vec = a.K % VW == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool w_vec = !TRANS && a.N % VW == 0 && cols % VW == 0 &&
                     reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  const int c4 = (cols + 3) / 4;
  for (int z = blockIdx.y; z < a.Z; z += gridDim.y) {
    const T* x = static_cast<const T*>(a.x) + z * a.sx + static_cast<size_t>(m0) * a.K;
    const T* w = static_cast<const T*>(a.w) + z * a.sw;
    T* out = static_cast<T*>(a.out) + z * a.so;
    __syncthreads();  // the last entry's products are done with the tiles
    if (x_vec) {
      for (int e = threadIdx.x; e < rows * a.K / VW; e += kSmallThreads) {
        const uint4 q = *reinterpret_cast<const uint4*>(x + e * VW);
        const T* v = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int i = 0; i < VW; ++i) xs[e * VW + i] = to_f(v[i]);
      }
    } else {
      for (int e = threadIdx.x; e < rows * a.K; e += kSmallThreads) xs[e] = to_f(x[e]);
    }
    if (w_vec) {
      const int cv = cols / VW;
      for (int e = threadIdx.x; e < a.K * cv; e += kSmallThreads) {
        const int k = e / cv, c = (e % cv) * VW;
        const uint4 q = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * a.N + n0 + c);
        const T* v = reinterpret_cast<const T*>(&q);
#pragma unroll
        for (int i = 0; i < VW; ++i) ws[k * ws_row + c + i] = to_f(v[i]);
      }
    } else {
      for (int e = threadIdx.x; e < a.K * cols; e += kSmallThreads) {
        const int k = e / cols, n = n0 + e % cols;
        ws[k * ws_row + e % cols] =
            to_f(TRANS ? w[static_cast<size_t>(n) * a.K + k] : w[static_cast<size_t>(k) * a.N + n]);
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < rows * c4; o += kSmallThreads) {
      const int m = o / c4, n = (o % c4) * 4;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < a.K; ++k) {  // k in order: each chain is a function of K alone
        const float xv = xs[m * a.K + k];
        const float4 w4 = *reinterpret_cast<const float4*>(ws + k * ws_row + n);
        s[0] = fmaf(xv, w4.x, s[0]);
        s[1] = fmaf(xv, w4.y, s[1]);
        s[2] = fmaf(xv, w4.z, s[2]);
        s[3] = fmaf(xv, w4.w, s[3]);
      }
      T* o_row = out + static_cast<size_t>(m0 + m) * a.N + n0 + n;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < cols)
          o_row[i] = finish(s[i], bias != nullptr ? to_f(bias[n0 + n + i]) : 0.0f, bias != nullptr,
                            T());
    }
  }
}

// ---- launches ----------------------------------------------------------------

// the kernel's attributes, set once a device (`ready`: one array a kernel)
template <typename K>
cudaError_t prepare(K kernel, int smem, bool clusters, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && ready[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && clusters)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) ready[dev] = true;
  return err;
}

template <int BN, bool TRANS, int PIECES>
int launch_tiles(const Args& a, cudaStream_t stream) {
  constexpr int SB = bf16_stage_bytes<BN, 8 * PIECES>();
  auto kernel = matmul_bf16_kernel<BN, TRANS, PIECES>;
  static bool ready[64] = {};
  cudaError_t err = prepare(kernel, kMaxDynamicSmem, true, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool clustered = a.cluster > 1;
  int smem = a.slots * SB;
  if (clustered && smem < part_bytes<BN>() + recv_bytes<BN>())
    smem = part_bytes<BN>() + recv_bytes<BN>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.N + BN - 1) / BN) * a.cluster, (a.M + 8 * PIECES - 1) / (8 * PIECES), a.Z);
  cfg.blockDim = dim3(2 * BN, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = clustered ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// form: 1 the cluster form, 2 the one-block form with 64-row tiles, 3 the
// one-block form with 128-row tiles (64-column tiles only), 0 the launch
// picks (the cluster while the tiles are too few to fill the card, 128-row
// tiles when they are many). No sum changes with the form.
template <int BN, bool TRANS>
int launch_bf16(const Args& plan, int form, cudaStream_t stream) {
  Args a = plan;
  if (form == 0) {
    const long long cols = (a.N + BN - 1) / BN;
    const long long tiles = cols * ((a.M + kBM - 1) / kBM) * a.Z;
    const long long wide = cols * ((a.M + 127) / 128) * a.Z;
    form = a.ranges > 1 && tiles < kOneBlockTiles ? 1 : BN == 64 && wide >= kWideTiles ? 3 : 2;
  }
  if (form == 1 && a.ranges > 1) {
    a.cluster = a.ranges;
    return launch_tiles<BN, TRANS, 8>(a, stream);
  }
  a.slots = kMaxSlots;  // one block walks every range: the deepest ring
  if (form == 3) {
    if constexpr (BN == 64) return launch_tiles<BN, TRANS, 16>(a, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_tiles<BN, TRANS, 8>(a, stream);
}

template <bool TRANS>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int smem = kStagesF32 * stage_bytes<float, 64>();
  auto kernel = matmul_f32_kernel<TRANS>;
  static bool ready[64] = {};
  const cudaError_t err = prepare(kernel, smem, false, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + 63) / 64, (a.M + kBM - 1) / kBM, a.Z);
  kernel<<<grid, 256, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TRANS>
int launch_small(const Args& a, cudaStream_t stream) {
  const int tiles = ((a.N + kSmallCols - 1) / kSmallCols) * ((a.M + kSmallRows - 1) / kSmallRows);
  const dim3 grid(tiles, a.Z < 65535 ? a.Z : 65535, 1);
  const int smem = (small_xs_floats(a.M, a.K) + a.K * small_ws_row(a.N)) * 4;
  matmul_small_kernel<T, TRANS><<<grid, kSmallThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const Args& a, bool trans, int dtype, int path, int bn, int form, cudaStream_t s) {
  if (path == 1) {  // small: no acc, no partial
    if (a.K > kSmallK || a.acc != nullptr || a.partial)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1)
      return trans ? launch_small<__nv_bfloat16, true>(a, s) : launch_small<__nv_bfloat16, false>(a, s);
    return trans ? launch_small<float, true>(a, s) : launch_small<float, false>(a, s);
  }
  if (dtype == 0) {  // f32: one range, 64 columns
    if (a.ranges != 1 || bn != 64) return static_cast<int>(cudaErrorInvalidValue);
    return trans ? launch_f32<true>(a, s) : launch_f32<false>(a, s);
  }
  // bf16 tiled: the plan's ranges must cover K's stages exactly
  const int nk = (a.K + Cfg<__nv_bfloat16>::kBK - 1) / Cfg<__nv_bfloat16>::kBK;
  if (a.spr < 1 || a.ranges < 1 || a.ranges > kMaxRanges || a.slots < 1 ||
      a.slots > kMaxSlots || a.ranges != (nk + a.spr - 1) / a.spr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 64)
    return trans ? launch_bf16<64, true>(a, form, s) : launch_bf16<64, false>(a, form, s);
  if (bn == 32)
    return trans ? launch_bf16<32, true>(a, form, s) : launch_bf16<32, false>(a, form, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point (bound with ctypes). x [Z, M, K], out [Z, M, N] (contiguous
// rows; batch strides sx, so in elements), w [Z, K, N] with rows of N values
// (trans = 0) or [Z, N, K] with rows of K values (trans = 1), batch stride
// sw; bias [N] or null; all of one type (dtype 0 = float32, 1 = bfloat16).
// The plan (ops/matmul.plan): path 0 = tiled, 1 = small (K <= 32); bn the
// column tile (bf16 64 or 32, f32 64); spr the K stages a range, ranges the
// K ranges (ceil(stages / spr), at most 16; f32 1), slots the stages in
// flight (1-4); form (bf16) 1 the cluster form, 2 / 3 the one-block form with
// 64- / 128-row tiles, 0 the launch's pick (all give the same bits). On the
// tiled path rows of K values (and of N values for trans = 0) are a multiple
// of 16 bytes and every matrix starts on a 16-byte
// boundary; the small path reads single values. The tiled paths' modes (Z =
// 1): acc, f32 [M, N] or null, the fold to start from; partial = 1 writes
// the f32 fold to out (f32 [M, N]), unrounded and without the bias. Returns
// cudaGetLastError() after the launch (0 on success; cudaErrorInvalidValue
// for a plan the kernel does not take). The caller validates shapes and
// alignment.
extern "C" int mmtg_matmul(const void* x, const void* w, const void* bias, void* out,
                           const void* acc, int partial, int Z, int M, int N, int K,
                           long long sx, long long sw, long long so, int trans, int dtype,
                           int path, int bn, int spr, int ranges, int slots, int form,
                           void* stream) {
  if ((acc != nullptr || partial) && Z != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, out, static_cast<const float*>(acc), partial, Z, M, N, K,
               sx, sw, so, spr, ranges, slots, 1};
  return launch(a, trans != 0, dtype, path, bn, form, static_cast<cudaStream_t>(stream));
}
