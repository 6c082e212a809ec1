// Whole-step decode kernel: ALL transformer layers of one decode step in one
// launch.
//
// Replaces the TPU kernel mmtg_tpu/ops/decode_megakernel.py (_megakernel,
// called through decode_block_fused). Per layer it computes, for every batch
// row: LN1 -> QKV product + bias -> q scaled by 1/sqrt(hd) -> int8
// quantize-append of the k/v rows (gpt2.quantize_rows) -> attention over the
// live cache prefix -> output projection + residual -> LN2 -> MLP with
// gelu_new -> residual. Products accumulate in f32 and round back to the
// stream type T; LayerNorm statistics are f32; every elementwise step rounds
// to T where the per-layer PyTorch step (models/gpt2.gpt2_decode_step) does,
// so the two paths differ by summation order only. It returns the hidden state
// before the final LayerNorm and updates the int8 caches and their scales in
// place (slot `position` only).
//
// What bounds it on the H100: bytes. A step reads the layers' weights (7.08 M
// values a layer, 169.9 MB in bf16 at the model's width: more than L2, so from
// HBM) and the live prefix of both caches of every layer; the products are 2
// FLOPs per weight and batch row. The TPU kernel loads each layer's weights
// into VMEM once and lets every batch block use them.
//
// Design: one persistent grid, every weight byte read once a step.
//   * The grid is as large as the card holds at once (ops/decode_megakernel.
//     plan: one or two blocks of 256 threads an SM; the launch is cooperative
//     and fails rather than start a grid that is not co-resident). The layers'
//     stages run one after another, each spread over the whole grid, with a
//     grid barrier between them (7 a layer: LN1 | QKV | append + attention |
//     proj + residual | LN2 | FC + gelu_new | MLP proj + residual). The barrier
//     is one arrival word in global memory that the wrapper keeps per (device,
//     stream): the last block to arrive flips its top bit, which the others
//     wait on, and the word is right for the next call without a reset.
//   * The activations live in a global scratch [B, 9D] of type T (h, the LN
//     output / ctx, qkv, the MLP row; every value there is rounded to T, so
//     nothing is lost), small enough to stay in L2.
//   * Products: the weight matrix [K, N] of each product is cut into tiles of
//     nt columns and K/splits rows; block j owns tiles j, j + grid, ... and
//     multiplies each by ALL B rows (staged 64 at a time in shared memory), so
//     no weight byte is read twice. The tiles of a block go through two shared
//     memory buffers by cp.async: the load of product g + 2 is issued as soon as
//     product g has freed its buffer, before the barrier, so HBM streams the
//     weights while the grid waits at barriers and attends. Where a product is
//     split over K, the partial sums go to scratch, the S blocks of a column
//     tile wait for each other (an atomic count) and each adds the K ranges in
//     order for its share of the outputs: no atomics on values, the result is
//     the same on every run.
//   * bf16 products run on the tensor cores (mma.sync.m16n8k16, f32
//     accumulation) with the weight tile as the 16-row side (ldmatrix.trans
//     from its [k][n] rows) and the batch as the 8-wide side: the stage moves
//     bytes, not operations, below B = 512, so mma.sync is enough and a B of 1
//     wastes 7/8 of a narrow side rather than 15/16 of a 64-row wgmma. f32
//     stays on CUDA-core FMAs (no TF32: it keeps about three digits), on the
//     same tiles.
//   * Batch invariance: no split depends on B. The plan's tile widths and K
//     ranges are chosen for a full batch group of 64 rows whatever B is, and
//     a warp (a thread in f32) sums an output piece over its tile's whole K
//     range in k order; so each output's summation tree is a function of
//     (K, N, grid), and a row's h has the same bits at any batch size (the
//     service promises one answer per (request, seed) whatever its window
//     holds). Below 8 row pieces a tile keeps some warps idle where a K split
//     across warps would have used them: the small-B price of the promise.
//   * Attention: the (batch row, head) items are spread over the grid, four at
//     a time a block (64 threads each, named barriers: eight items in flight an
//     SM, where an item is a chain of dependent loads). An item runs the stages
//     of decode_attention.cuh that the per-layer kernel runs: the append
//     recomputed where it is read (every item of a row computes the row's
//     scales from the qkv scratch and its own head's codes, which it writes;
//     the head-0 item writes the scales; none reads slot `position` from the
//     cache), then 16-byte lane loads with a per-group online softmax, groups
//     merged in order.
// Limits of this kernel: int8 split cache; weights of the stream type;
// head_dim a multiple of 16 and <= 128; the plan's shared memory.

#include "decode_attention.cuh"

namespace {

using namespace mmtg;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatchGroup = 64;  // rows of a product's input staged at a time
constexpr int kItemThreads = 64;  // threads that attend over one (row, head) item
constexpr int kBiasBytes = 1024;  // a column tile's bias slice

template <typename T>
struct Params {
  const T *ln1_g, *ln1_b, *attn_w, *attn_b, *proj_w, *proj_b;
  const T *ln2_g, *ln2_b, *fc_w, *fc_b, *mproj_w, *mproj_b;
};

struct Prod {
  int nt, splits;  // column tile width; K ranges
};

template <typename T>
struct Args {
  const T* h_in;
  Params<T> p;
  int8_t *k_cache, *v_cache;
  float *k_scale, *v_scale;
  const int32_t* key_mask;
  T* h_out;
  T* act;          // [B, 9D]: h | LN output, ctx | qkv | MLP row
  float* partial;  // split-K partial sums [splits, B, N]
  unsigned* sync;  // the barrier's arrival word, then a count a column tile
  int L, B, T_cap, D, n_head, position;
  float eps, q_scale;
  int wbuf;        // bytes of one weight buffer
  Prod prod[4];    // qkv, proj, fc, mproj
};

// ---- the grid barrier -------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One arrival word: block 0 adds 2^31 - (grid - 1), every other block 1, so
// each barrier adds 2^31 in all and its last arrival flips the top bit, which
// the others wait on. No reset: the word is right for the next barrier and
// the next call.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0u) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <int NT>
__device__ __forceinline__ void item_sync(int part) {
  asm volatile("bar.sync %0, %1;" ::"r"(part + 1), "r"(NT) : "memory");
}

// ---- cp.async, ldmatrix, mma ------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- numerics of the per-layer step -------------------------------------------

// gelu_new as models/gpt2.gelu_new computes it in type T, op by op
template <typename T>
__device__ __forceinline__ float gelu_new(float x) {
  const float x3 = round_to<T>(x * x * x);
  const float inner = round_to<T>(x + round_to<T>(0.044715f * x3));
  const float t = round_to<T>(tanhf(round_to<T>(0.7978845608028654f * inner)));
  return round_to<T>(round_to<T>(0.5f * x) * round_to<T>(1.0f + t));
}

// LayerNorm with the port's numerics (models/gpt2.layer_norm): f32 statistics,
// elementwise math rounded to T. A warp a row. The gain and bias come into
// `work` once a block and each warp's row beside them, all loads in flight at
// once; the three passes read shared memory. With `copy`, the rows of `src` are
// also written to h.
template <typename T>
__device__ void ln_stage(const Args<T>& a, const T* src, size_t ld_src, bool copy,
                         const T* g, const T* bb, unsigned char* work) {
  constexpr int V = 16 / sizeof(T), U = 4;
  if (blockIdx.x * kWarps >= a.B) return;  // no row for this block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D, chunks = D / V;
  const size_t ld = 9 * static_cast<size_t>(D);
  uint4* gb = reinterpret_cast<uint4*>(work);  // gain, then bias
  T* row = reinterpret_cast<T*>(work + 2 * D * sizeof(T)) + warp * D;
  for (int b = blockIdx.x * kWarps + warp, first = 1; first || b < a.B;
       b += gridDim.x * kWarps, first = 0) {
    const bool mine = b < a.B;
    const uint4* x = reinterpret_cast<const uint4*>(src + b * ld_src);
    T* h = a.act + b * ld;
    for (int c0 = lane; c0 < chunks; c0 += 32 * U) {
      uint4 v[U], w[2 * U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u;
        if (mine && c < chunks) v[u] = __ldcg(x + c);
        if (first) {  // the gain and bias, by the block's warps together
          const int j = warp * 32 * U * 2 + 2 * c;
          if (j < 2 * chunks) w[2 * u] = __ldg(reinterpret_cast<const uint4*>(j < chunks ? g : bb) + j % chunks);
          if (j + 1 < 2 * chunks) w[2 * u + 1] = __ldg(reinterpret_cast<const uint4*>(j + 1 < chunks ? g : bb) + (j + 1) % chunks);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u;
        if (mine && c < chunks) {
          reinterpret_cast<uint4*>(row)[c] = v[u];
          if (copy) reinterpret_cast<uint4*>(h)[c] = v[u];
        }
        if (first) {
          const int j = warp * 32 * U * 2 + 2 * c;
          if (j < 2 * chunks) gb[j] = w[2 * u];
          if (j + 1 < 2 * chunks) gb[j + 1] = w[2 * u + 1];
        }
      }
    }
    if (first) __syncthreads();  // every warp's share of the gain and bias
    if (!mine) break;
    const T* gs = reinterpret_cast<const T*>(gb);
    const T* bs = gs + D;
    T* out = h + D;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) sum += to_f(row[d]);
    const float mean = round_to<T>(warp_sum(sum) / static_cast<float>(D));
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xm = round_to<T>(to_f(row[d]) - mean);
      sq += round_to<T>(xm * xm);
    }
    const float var = warp_sum(sq) / static_cast<float>(D);
    const float rstd = round_to<T>(rsqrtf(var + a.eps));
    for (int d = lane; d < D; d += 32) {
      const float xm = round_to<T>(to_f(row[d]) - mean);
      out[d] = from_f<T>(round_to<T>(round_to<T>(xm * rstd) * to_f(gs[d])) + to_f(bs[d]));
    }
    __syncwarp();  // the next row overwrites `row`
  }
}

// ---- products ---------------------------------------------------------------

// Product q of layer l: its weights and shape.
template <typename T>
__device__ __forceinline__ const T* weights(const Args<T>& a, int q, int l, int& K, int& N) {
  const size_t D = a.D;
  switch (q) {
    case 0: K = a.D; N = 3 * a.D; return a.p.attn_w + l * D * 3 * D;
    case 1: K = a.D; N = a.D; return a.p.proj_w + l * D * D;
    case 2: K = a.D; N = 4 * a.D; return a.p.fc_w + l * D * 4 * D;
    default: K = 4 * a.D; N = a.D; return a.p.mproj_w + l * 4 * D * D;
  }
}

// Issue the cp.async loads of this block's tiles of product g (= 4 l + q) into
// `buf`: tile m at m * kt rows of nt * sizeof(T) + 16 bytes (the pad keeps
// ldmatrix free of bank conflicts). Always commits one group (empty past the
// last layer).
template <typename T>
__device__ void load_tiles(const Args<T>& a, int g, unsigned char* buf) {
  const int q = g & 3, l = g >> 2;
  if (l < a.L) {
    int K, N;
    const T* W = weights(a, q, l, K, N);
    const Prod pr = a.prod[q];
    const int kt = K / pr.splits;
    const int cpr = pr.nt * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces a row
    const int rowb = pr.nt * static_cast<int>(sizeof(T)) + 16;
    const int items = N / pr.nt * pr.splits;
    int m = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++m) {
      const int ct = i / pr.splits, s = i % pr.splits;
      const T* src = W + static_cast<size_t>(s) * kt * N + static_cast<size_t>(ct) * pr.nt;
      unsigned char* dst = buf + static_cast<size_t>(m) * kt * rowb;
      for (int c = threadIdx.x; c < kt * cpr; c += kThreads) {
        const int r = c / cpr, x = c % cpr;
        cp_async16(dst + r * rowb + x * 16,
                   src + static_cast<size_t>(r) * N + x * (16 / static_cast<int>(sizeof(T))));
      }
    }
  }
  cp_commit();
}

// Stage input rows b0 .. b0 + rows - 1 (zero past B), columns k0 .. k0 + kt - 1
// of x (row stride ld) into xs: rows of kt * sizeof(T) + 16 bytes. A thread
// keeps 8 loads in flight.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* x, size_t ld, int B, int b0, int rows,
                                           int k0, int kt, unsigned char* xs) {
  constexpr int V = 16 / sizeof(T), U = 8;
  const int cpr = kt / V, rowb = kt * static_cast<int>(sizeof(T)) + 16, total = rows * cpr;
  for (int c0 = threadIdx.x; c0 < total; c0 += kThreads * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kThreads, r = c / cpr;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (c < total && b0 + r < B)
        v[u] = __ldcg(reinterpret_cast<const uint4*>(x + (b0 + r) * ld + k0 + (c % cpr) * V));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * kThreads;
      if (c < total) *reinterpret_cast<uint4*>(xs + (c / cpr) * rowb + (c % cpr) * 16) = v[u];
    }
  }
}

// The products of one batch group with one tile, calling out(b, n, sum) (b, n
// local to the group and tile) once for every output. bf16: tensor cores, a
// warp a 16 x 8 output piece over the tile's whole K, in k order: a row's sums
// are the same whatever the number of rows nb (no K split across warps, which
// would follow the number of pieces, and so the batch).
template <typename Out>
__device__ __forceinline__ void tile_mma(const unsigned char* wt, int nt, int kt,
                                         const unsigned char* xs, int nb, Out out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rowb = nt * 2 + 16, xrowb = kt * 2 + 16;
  const int mtiles = nt / 16, nb8 = (nb + 7) / 8, ksteps = kt / 16;
  const int mat = lane >> 3, r8 = lane & 7;
  for (int u = warp; u < mtiles * nb8; u += kWarps) {
    const int mt = u % mtiles, bt = u / mtiles;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const unsigned char* arow = wt + (r8 + ((mat >> 1) << 3)) * rowb + (mt * 16 + ((mat & 1) << 3)) * 2;
    const unsigned char* brow = xs + (bt * 8 + r8) * xrowb + ((mat & 1) << 3) * 2;
    for (int kk = 0; kk < ksteps; ++kk) {
      unsigned a0, a1, a2, a3, b0, b1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(arow + kk * 16 * rowb)));
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
                   : "=r"(b0), "=r"(b1)
                   : "r"(smem_addr(brow + kk * 32)));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    const int n = mt * 16 + (lane >> 2), b = bt * 8 + 2 * (lane & 3);
    if (b < nb) out(b, n, c[0]);
    if (b + 1 < nb) out(b + 1, n, c[1]);
    if (b < nb) out(b, n + 8, c[2]);
    if (b + 1 < nb) out(b + 1, n + 8, c[3]);
  }
}

// f32: CUDA-core FMAs, a thread a 4 x 4 block of outputs (4 rows, 4 columns:
// 5 shared loads for 16 FMAs) over the tile's whole K, in k order (no K split
// across threads: see tile_mma).
template <typename Out>
__device__ __forceinline__ void tile_fma(const unsigned char* wt_, int nt, int kt,
                                         const unsigned char* xs_, int nb, Out out) {
  const float* wt = reinterpret_cast<const float*>(wt_);
  const float* xs = reinterpret_cast<const float*>(xs_);
  const int wrow = nt + 4, xrow = kt + 4;
  const int cg = nt / 4, O = (nb + 3) / 4 * cg;
  for (int u = threadIdx.x; u < O; u += kThreads) {
    const int c4 = (u % cg) * 4, r4 = (u / cg) * 4;
    const float* xr = xs + r4 * xrow;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < kt; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(wt + k * wrow + c4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xr[i * xrow + k];
        acc[i][0] = fmaf(xv, w.x, acc[i][0]);
        acc[i][1] = fmaf(xv, w.y, acc[i][1]);
        acc[i][2] = fmaf(xv, w.z, acc[i][2]);
        acc[i][3] = fmaf(xv, w.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r4 + i < nb) out(r4 + i, c4 + j, acc[i][j]);
  }
}

// Product g = 4 l + q over the whole grid: this block's tiles (already in
// `buf`) times all B input rows of x (row stride 9D), epi(b, n, sum, bias[n])
// once for every output. The tile's bias slice comes in with its first rows.
template <typename T, typename Epi>
__device__ void product(const Args<T>& a, int q, const T* x, const T* bias,
                        const unsigned char* buf, unsigned char* work, Epi epi) {
  int K, N;
  weights(a, q, 0, K, N);
  const Prod pr = a.prod[q];
  const int kt = K / pr.splits;
  const int rowb = pr.nt * static_cast<int>(sizeof(T)) + 16;
  const int items = N / pr.nt * pr.splits;
  const size_t ld = 9 * static_cast<size_t>(a.D);
  T* sbias = reinterpret_cast<T*>(work);
  unsigned char* xs = work + kBiasBytes;
  const int bias_chunks = pr.nt * static_cast<int>(sizeof(T)) / 16;
  unsigned* counters = a.sync + 1;
  int m = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x, ++m) {
    const int ct = i / pr.splits, s = i % pr.splits;
    const unsigned char* wt = buf + static_cast<size_t>(m) * kt * rowb;
    uint4 bv = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < bias_chunks)  // issued before the rows' loads, stored after
      bv = __ldg(reinterpret_cast<const uint4*>(bias + ct * pr.nt) + threadIdx.x);
    for (int b0 = 0; b0 < a.B; b0 += kBatchGroup) {
      const int nb = min(kBatchGroup, a.B - b0);
      stage_rows<T>(x, ld, a.B, b0, (nb + 7) & ~7, s * kt, kt, xs);
      if (b0 == 0 && threadIdx.x < bias_chunks) reinterpret_cast<uint4*>(sbias)[threadIdx.x] = bv;
      __syncthreads();
      auto out = [&](int b, int n, float v) {
        const int bg = b0 + b, ng = ct * pr.nt + n;
        if (pr.splits == 1)
          epi(bg, ng, v, to_f(sbias[n]));
        else
          a.partial[(static_cast<size_t>(s) * a.B + bg) * N + ng] = v;
      };
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        tile_mma(wt, pr.nt, kt, xs, nb, out);
      else
        tile_fma(wt, pr.nt, kt, xs, nb, out);
      __syncthreads();  // xs is staged again
    }
    if (pr.splits > 1) {
      // The S items of a column tile (on S blocks: the plan gives a split
      // product at most one item a block, and all blocks are resident) wait
      // for each other's partial sums, then each adds the K ranges, in order,
      // for its share of the tile's outputs. The count goes to S when all
      // partials are written, to 2S when all shares are done; the block that
      // takes it to 2S zeroes it for the next product.
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        atomicAdd(counters + ct, 1u);
        while (ld_acquire(counters + ct) < static_cast<unsigned>(pr.splits)) {
        }
        __threadfence();
      }
      __syncthreads();
      const int outs = a.B * pr.nt, share = (outs + pr.splits - 1) / pr.splits;
      const int o_end = min(outs, (s + 1) * share);
      // 4 outputs a thread at a time, 8 K ranges of each in flight
      constexpr int OU = 4, RU = 8;
      for (int o0 = s * share + threadIdx.x; o0 < o_end; o0 += kThreads * OU) {
        float sum[OU];
#pragma unroll
        for (int j = 0; j < OU; ++j) sum[j] = 0.0f;
        for (int r0 = 0; r0 < pr.splits; r0 += RU) {
          float v[OU][RU];
#pragma unroll
          for (int j = 0; j < OU; ++j) {
            const int o = o0 + j * kThreads, b = o / pr.nt, n = ct * pr.nt + o % pr.nt;
#pragma unroll
            for (int r = 0; r < RU; ++r)
              v[j][r] = o < o_end && r0 + r < pr.splits
                            ? __ldcg(a.partial + (static_cast<size_t>(r0 + r) * a.B + b) * N + n)
                            : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < OU; ++j)
#pragma unroll
            for (int r = 0; r < RU; ++r)
              if (r0 + r < pr.splits) sum[j] += v[j][r];
        }
#pragma unroll
        for (int j = 0; j < OU; ++j) {
          const int o = o0 + j * kThreads;
          if (o < o_end) epi(o / pr.nt, ct * pr.nt + o % pr.nt, sum[j], to_f(sbias[o % pr.nt]));
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && atomicAdd(counters + ct, 1u) == 2u * pr.splits - 1u)
        atomicExch(counters + ct, 0u);  // ready for the next product
    }
  }
}

// The stage of product g: wait for its tiles, run it, then start the load of
// product g + 2 into the buffer it leaves.
template <typename T, typename Epi>
__device__ void product_stage(const Args<T>& a, int g, const T* x, const T* bias,
                              unsigned char* const (&wbuf)[2], unsigned char* work, Epi epi) {
  cp_wait<1>();  // all but the newest group (product g + 1) have landed
  __syncthreads();
  product(a, g & 3, x, bias, wbuf[g & 1], work, epi);
  __syncthreads();
  load_tiles(a, g + 2, wbuf[g & 1]);
}

// ---- attention -----------------------------------------------------------------

template <typename T>
__device__ void attention_stage(const Args<T>& a, int l, unsigned char* work) {
  constexpr int NT = kItemThreads, kParts = kThreads / NT;
  using K = Kind<T, kInt8, false>;
  constexpr int EPL = K::EPL;
  __shared__ float red[kParts][2][NT / 32];
  const int D = a.D, hd = D / a.n_head;
  const int G = group_lanes<T, kInt8, false>(hd);
  const int n_groups = NT / G;
  const int part = threadIdx.x / NT, tid = threadIdx.x % NT;
  const int grp = tid / G, lg = tid % G;
  const int stage_b = (D + 15) & ~15;
  const int row_b = D * static_cast<int>(sizeof(T));  // a multiple of 16
  int8_t* sk = reinterpret_cast<int8_t*>(
      work + part * (2 * stage_b + 2 * row_b + 4 * ((a.T_cap + 3) & ~3) + 4 * n_groups * (2 + hd)));
  int8_t* sv = sk + stage_b;
  T* kv = reinterpret_cast<T*>(sv + stage_b);  // the step's k row, then its v row
  int32_t* smask = reinterpret_cast<int32_t*>(sv + stage_b + 2 * row_b);  // [T_cap]
  float* gm = reinterpret_cast<float*>(smask + ((a.T_cap + 3) & ~3));
  float* gl = gm + n_groups;
  float* gacc = gl + n_groups;
  const auto sync = [part] { item_sync<NT>(part); };
  const size_t ld = 9 * static_cast<size_t>(D);
  const int pos = a.position;
  for (int i = blockIdx.x * kParts + part; i < a.B * a.n_head; i += gridDim.x * kParts) {
    const int b = i / a.n_head, hb = i % a.n_head;
    const T* q = a.act + b * ld + 2 * D;  // q (scaled), then k_new, v_new
    const size_t row0 = (static_cast<size_t>(l) * a.B + b) * a.T_cap;
    int8_t* k_rows = a.k_cache + row0 * D;
    int8_t* v_rows = a.v_cache + row0 * D;
    const int32_t* mask_row = a.key_mask + static_cast<size_t>(b) * a.T_cap;
    const LaneMap lm = lane_map<T, kInt8, false>(lg, hb, hd, D);
    float qv[1][EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lg * EPL + j;
      qv[0][j] = e < hd ? to_f(q[hb * hd + e]) : 0.0f;
    }
    {  // k_new ‖ v_new (contiguous in the scratch row) and the live mask words,
       // every load in flight
      constexpr int U = 8;
      const uint4* src = reinterpret_cast<const uint4*>(q + D);
      const int chunks = 2 * row_b / 16, words = pos + 1;
      for (int c0 = tid; c0 < chunks || c0 < words; c0 += NT * U) {
        uint4 v[U];
        int32_t m[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * NT;
          if (c < chunks) v[u] = __ldcg(src + c);
          if (c < words) m[u] = __ldg(mask_row + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * NT;
          if (c < chunks) reinterpret_cast<uint4*>(kv)[c] = v[u];
          if (c < words) smask[c] = m[u];
        }
      }
      sync();
    }
    // the scales from the whole row, the codes of this head: the item writes
    // them (each head's codes one item, the scales the head-0 item)
    float ks, vs;
    stage_quantized<kInt8>(kv, kv + D, D, hb * hd, hb * hd + hd, tid, NT, sk, sv,
                           k_rows + static_cast<size_t>(pos) * D,
                           v_rows + static_cast<size_t>(pos) * D, &red[part][0][0], sync, ks, vs);
    if (hb == 0 && tid == 0) {
      a.k_scale[row0 + pos] = ks;
      a.v_scale[row0 + pos] = vs;
    }
    State<1, EPL> st;
    st.init();
    attend_range<T, kInt8, false, true>(st, qv, k_rows, v_rows, static_cast<size_t>(D),
                                        a.k_scale + row0, a.v_scale + row0, smask, 0, pos,
                                        n_groups, grp, lm, G);
    attend_pos<T, kInt8, false>(st, qv, sk, sv, ks, vs, smask[pos] != 0, grp, lm, G);
    T* ctx = a.act + b * ld + D + hb * hd;
    merge_groups<1, EPL, NT>(
        st, gm, gl, gacc, n_groups, grp, lg, true, hd, tid, sync,
        [&](int, int d, int, float, float Lsum, float A) {
          ctx[d] = from_f<T>(Lsum > 0.0f ? A / Lsum : 0.0f);
        });
  }
}

// ---- the kernel ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) decode_block_fused_kernel(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const wbuf[2] = {smem, smem + a.wbuf};
  unsigned char* work = smem + 2 * static_cast<size_t>(a.wbuf);
  const int D = a.D;
  const size_t ld = 9 * static_cast<size_t>(D);
  T* h = a.act;
  const Params<T>& p = a.p;
  load_tiles(a, 0, wbuf[0]);
  load_tiles(a, 1, wbuf[1]);
  for (int l = 0; l < a.L; ++l) {
    const size_t lD = static_cast<size_t>(l) * D;
    const bool last = l + 1 == a.L;
    // ---- LN1 (layer 0 reads h_in and copies it to h) ------------------------
    ln_stage(a, l == 0 ? a.h_in : h, l == 0 ? static_cast<size_t>(D) : ld, l == 0,
             p.ln1_g + lD, p.ln1_b + lD, work);
    grid_sync(a.sync);
    // ---- qkv (+ bias; q scaled and rounded as the attention wants) ----------
    product_stage(a, 4 * l, a.act + D, p.attn_b + 3 * lD, wbuf, work,
                  [&](int b, int n, float sum, float bias) {
      float v = round_to<T>(round_to<T>(sum) + bias);
      if (n < D) v = round_to<T>(v * a.q_scale);
      a.act[b * ld + 2 * D + n] = from_f<T>(v);
    });
    grid_sync(a.sync);
    // ---- int8 append, then attention over the live prefix -> ctx -----------
    attention_stage(a, l, work);
    grid_sync(a.sync);
    // ---- output projection + residual ---------------------------------------
    product_stage(a, 4 * l + 1, a.act + D, p.proj_b + lD, wbuf, work,
                  [&](int b, int n, float sum, float bias) {
      T* hp = h + b * ld + n;
      *hp = from_f<T>(round_to<T>(round_to<T>(to_f(*hp) + round_to<T>(sum)) + bias));
    });
    grid_sync(a.sync);
    // ---- LN2 -> MLP with gelu_new -> residual --------------------------------
    ln_stage(a, h, ld, false, p.ln2_g + lD, p.ln2_b + lD, work);
    grid_sync(a.sync);
    product_stage(a, 4 * l + 2, a.act + D, p.fc_b + 4 * lD, wbuf, work,
                  [&](int b, int n, float sum, float bias) {
      a.act[b * ld + 5 * D + n] = from_f<T>(gelu_new<T>(round_to<T>(round_to<T>(sum) + bias)));
    });
    grid_sync(a.sync);
    product_stage(a, 4 * l + 3, a.act + 5 * D, p.mproj_b + lD, wbuf, work,
                  [&](int b, int n, float sum, float bias) {
      const float v = round_to<T>(round_to<T>(to_f(h[b * ld + n]) + round_to<T>(sum)) + bias);
      if (last)
        a.h_out[static_cast<size_t>(b) * D + n] = from_f<T>(v);
      else
        h[b * ld + n] = from_f<T>(v);
    });
    if (!last) grid_sync(a.sync);
  }
  cp_wait<0>();
}

template <typename T>
int launch(const Args<T>& a, int grid, int smem, cudaStream_t stream) {
  auto kernel = decode_block_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid that is not resident all at once would wait at its first barrier for ever
  if (static_cast<long>(per_sm) * sms < grid)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* h_in, const void* const* params, void* k_cache, void* v_cache,
                 void* k_scale, void* v_scale, const void* key_mask, void* h_out, void* act,
                 void* partial, void* sync, const int* plan, int L, int B, int T_cap, int D,
                 int n_head, int position, float eps, float q_scale, cudaStream_t stream) {
  Args<T> a{};
  a.h_in = static_cast<const T*>(h_in);
  const T** fields[12] = {&a.p.ln1_g, &a.p.ln1_b, &a.p.attn_w, &a.p.attn_b,
                          &a.p.proj_w, &a.p.proj_b, &a.p.ln2_g, &a.p.ln2_b,
                          &a.p.fc_w,   &a.p.fc_b,   &a.p.mproj_w, &a.p.mproj_b};
  for (int i = 0; i < 12; ++i) *fields[i] = static_cast<const T*>(params[i]);
  a.k_cache = static_cast<int8_t*>(k_cache);
  a.v_cache = static_cast<int8_t*>(v_cache);
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.key_mask = static_cast<const int32_t*>(key_mask);
  a.h_out = static_cast<T*>(h_out);
  a.act = static_cast<T*>(act);
  a.partial = static_cast<float*>(partial);
  a.sync = static_cast<unsigned*>(sync);
  a.L = L; a.B = B; a.T_cap = T_cap; a.D = D; a.n_head = n_head; a.position = position;
  a.eps = eps; a.q_scale = q_scale;
  a.wbuf = plan[2];
  for (int q = 0; q < 4; ++q) a.prod[q] = Prod{plan[3 + 2 * q], plan[4 + 2 * q]};
  return launch(a, plan[0], plan[1], stream);
}

}  // namespace

// C entry point (bound with ctypes). h_in / h_out [B, D]; `params`: 12
// pointers in the order ln1_g, ln1_b, attn_w [L, D, 3D], attn_b, attn_proj_w
// [L, D, D], attn_proj_b, ln2_g, ln2_b, mlp_fc_w [L, D, 4D], mlp_fc_b,
// mlp_proj_w [L, 4D, D], mlp_proj_b, all of h's type; caches [L, B, T_cap, D]
// int8; scales [L, B, T_cap] f32; key_mask [B, T_cap] int32. Scratch from the
// caller: `act` [B, 9D] of h's type, `partial` the split-K sums (f32, the
// largest splits * B * N of a split product), `sync` int32 words that are
// zero before the first call on a stream and that every call leaves ready for
// the next (the barrier's arrival word, then one count a column tile). `plan`: grid,
// dynamic shared memory bytes, bytes of one weight buffer, then
// (nt, splits) of the qkv, proj, fc and mproj products
// (ops/decode_megakernel.plan). dtype: 0 = float32, 1 = bfloat16. Returns the
// CUDA error of the set-up or the launch (0 on success);
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident at once.
// The caller validates shapes and bounds.
extern "C" int mmtg_decode_block_fused(
    const void* h_in, const void* const* params, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* key_mask, void* h_out, void* act, void* partial,
    void* sync, const int* plan, int L, int B, int T_cap, int D, int n_head, int position,
    float eps, float q_scale, int dtype, void* stream) {
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(h_in, params, k_cache, v_cache, k_scale, v_scale,
                                       key_mask, h_out, act, partial, sync, plan, L, B, T_cap,
                                       D, n_head, position, eps, q_scale,
                                       static_cast<cudaStream_t>(stream));
  return launch_dtype<float>(h_in, params, k_cache, v_cache, k_scale, v_scale, key_mask, h_out, act, partial,
             sync, plan, L, B, T_cap, D, n_head, position, eps, q_scale,
             static_cast<cudaStream_t>(stream));
}
