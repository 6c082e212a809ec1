// Single-query decode attention over the KV cache, with or without the fused
// append of the step's k/v row.
//
// Replaces the TPU kernel mmtg_tpu/ops/decode_attention_unified.py
// (_unified_kernel, built by build_call) as called through every wrapper of
// mmtg_tpu/ops/decode_attention.py. As there, the cache kind, the append stage
// and the merged layout are options of ONE kernel:
//   decode_attention / _int8 / _int4           CACHE = fp/int8/int4, no append
//   decode_attention_fp_append                  fp,   append
//   decode_attention_int8_append                int8, append
//   decode_attention_int4_append                int4, append
//   decode_attention_int8_append_merged         int8, append, k||v in one
//                                               [L, B, T, 2D] buffer: a row
//                                               stride of 2D, v at +D
//
// What it computes, for one layer `layer` of a [L, B, T, row] cache (heads
// merged into D = H * hd):
//   1. append (when on): the step's k/v rows go into slot `position`,
//      quantized as the cache kind says (decode_attention.cuh), scales written.
//   2. attend: q (pre-scaled by 1/sqrt(hd) and rounded back to its own type,
//      as the TPU wrapper does) against slots t <= position with
//      key_mask[b, t] != 0. Scores, running max, sum and accumulator are f32
//      (online softmax); ctx is stored in q's type.
//
// What bounds it on the H100: bytes. Each call streams the live cache prefix
// of one layer, (position + 1) * D bytes per row for int8, half that for int4
// and 2x / 4x for bf16 / f32, and does 2 FLOPs per byte or less. The first
// port ran one block per batch row (64 SMs at B = 64, ONE at B = 1), a warp
// per head walking the slots one by one, 1-4 bytes a lane and a 5-step
// shuffle chain per slot: a latency chain at 30-80x the byte bound.
//
// Design:
//   * a block of 128 threads owns one (batch row, head) and one chunk of the
//     slots: chunks of 256, their number a function of `position` alone
//     (ops/decode_attention.split_slots), never of B, so a row's context is
//     summed in the same tree at any batch size (the service promises one
//     answer per (request, seed) whatever its window holds). Up to position
//     255 (the default 220-token call) that is one chunk. With more, the
//     partial (max, sum, accumulator) triples go to scratch that the wrapper
//     allocates, and the block that finishes last (an atomic count, reset by
//     that block for the next call) merges them in chunk order:
//     reproducible. No split follows B: where B x heads cannot fill the card
//     (B = 1), splitting into 16-slot chunks was no faster than one chunk
//     (0.0147 against 0.0148 ms at position 235, NVIDIA H100 80GB HBM3 at
//     700 W), and it made the tree depend on B.
//   * a lane loads 16 bytes of a slot's head row, neighbouring lanes the
//     neighbouring bytes: a group of G = hd * size / 16 lanes covers the row
//     (8 lanes for bf16 at hd = 64, 4 for int8), so a warp reads 32 / G slots
//     a load, and each group keeps its own online softmax. A score is summed
//     within its group (log2 G shuffles), never over the whole warp; the
//     groups of the block merge once at the end. A lane issues the loads of 4
//     slots before it reduces any of them.
//   * int4: heads h and h + H/2 share their bytes (byte j holds lane j low and
//     lane j + D/2 high), so for even H (and 16 | hd) one block owns the head
//     pair and each 16-byte load gives the 32 codes of both heads. Odd H, where
//     D/2 falls inside a head, takes a plain path: a block per head, a lane
//     reading single bytes and picking its nibble.
//   * append with exact bytes: every block whose chunk holds slot `position`
//     recomputes the row's scale (an abs-max over ALL heads of k_new / v_new)
//     and the row's codes from the step's rows, and attends over slot
//     `position` from those; exactly one of them (head 0) writes the codes and
//     both scales. No block reads slot `position` from the cache, so nothing
//     races. The read-only kernel takes slot `position` at the same point of
//     its sweep (after the chunk's other slots), so after an append it gives
//     the same ctx bit for bit.
// The item's stages are the device functions of decode_attention.cuh, which
// the whole-step kernel (decode_block_fused.cu) calls too.

#include "decode_attention.cuh"

namespace {

using namespace mmtg;

constexpr int kThreads = 128;

// Head `hh` of this block (0 or, for a pair, 1) as a head index of the model.
template <bool PAIR>
__device__ __forceinline__ int head_of(int hb, int hh, int n_head) {
  return PAIR ? hb + hh * (n_head / 2) : hb;
}

// The body of one block; the two kernels below differ only in their launch
// bounds.
template <typename T, int KIND, bool APPEND, bool PAIR>
__device__ __forceinline__ void attention_block(
                        const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, void* k_cache_, void* v_cache_,
                        float* k_scale, float* v_scale, const int32_t* __restrict__ key_mask,
                        T* __restrict__ ctx, float* __restrict__ scratch, int* counters,
                        int B, int T_cap, int D, int n_head, int position, int layer,
                        float q_scale, int row_stride, int chunk, int G) {
  using K = Kind<T, KIND, PAIR>;
  using C = typename K::C;
  constexpr int NH = K::NH, EPL = K::EPL;
  extern __shared__ float4 smem4[];
  __shared__ float red[2][kThreads / 32];
  __shared__ int is_last;

  const int s_idx = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, n_hb = gridDim.y;
  const int tid = threadIdx.x;
  const int hd = D / n_head;
  const int n_groups = kThreads / G, grp = tid / G, lg = tid % G;
  const int W = position + 1;
  const int lo = s_idx * chunk, hi = min(lo + chunk, W);
  const bool has_pos = hi == W;  // this chunk holds slot `position`

  // row-element width of one stored row (bytes for int4, elements else)
  const int row_w = KIND == kInt4 ? D / 2 : D;
  unsigned char* stage_k = reinterpret_cast<unsigned char*>(smem4);  // APPEND, quantized
  unsigned char* stage_v = stage_k + ((row_w + 15) & ~15);
  float* gsum = reinterpret_cast<float*>(
      stage_k + (APPEND && KIND != kFp ? 2 * ((row_w + 15) & ~15) : 0));
  // gsum: [NH][n_groups] max, [NH][n_groups] sum, [NH][n_groups][hd] accumulators
  float* gm = gsum;
  float* gl = gm + NH * n_groups;
  float* gacc = gl + NH * n_groups;

  const size_t row0 = (static_cast<size_t>(layer) * B + b) * T_cap;
  C* k_rows = static_cast<C*>(k_cache_) + row0 * row_stride;
  C* v_rows = static_cast<C*>(v_cache_) + row0 * row_stride;
  const int32_t* mask_row = key_mask + static_cast<size_t>(b) * T_cap;

  // ---- this lane's elements ---------------------------------------------------
  const LaneMap lm = lane_map<T, KIND, PAIR>(lg, hb, hd, D);
  float qv[NH][EPL];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lg * EPL + i;
      // pre-scale and round back to T, as the TPU wrapper does
      qv[h][i] = e < hd ? round_to<T>(to_f(q[static_cast<size_t>(b) * D +
                                             head_of<PAIR>(hb, h, n_head) * hd + e]) *
                                      q_scale)
                        : 0.0f;
    }
  const auto sync = [] { __syncthreads(); };

  // ---- 1. the step's row, when this block attends over slot `position` -------
  const C* pos_k = k_rows + static_cast<size_t>(position) * row_stride;
  const C* pos_v = v_rows + static_cast<size_t>(position) * row_stride;
  float pos_ks = 0.0f, pos_vs = 0.0f;
  if constexpr (APPEND) {
    if (has_pos) {
      const T* kn = k_new + static_cast<size_t>(b) * D;
      const T* vn = v_new + static_cast<size_t>(b) * D;
      const bool writer = hb == 0;  // exactly one block writes the row
      if constexpr (KIND == kFp) {
        pos_k = kn;  // stored as it comes: the cache's type is q's
        pos_v = vn;
        if (writer)
          for (int d = tid; d < D; d += kThreads) {
            k_rows[static_cast<size_t>(position) * row_stride + d] = kn[d];
            v_rows[static_cast<size_t>(position) * row_stride + d] = vn[d];
          }
      } else {
        // the scale is an abs-max over the WHOLE row: every block computes it
        int8_t* sk = reinterpret_cast<int8_t*>(stage_k);
        int8_t* sv = reinterpret_cast<int8_t*>(stage_v);
        float ks, vs;
        stage_quantized<KIND, kThreads>(kn, vn, D, 0, row_w, tid, sk, sv, red, sync, ks, vs);
        if (writer) {
          for (int d = tid; d < row_w; d += kThreads) {
            k_rows[static_cast<size_t>(position) * row_stride + d] = sk[d];
            v_rows[static_cast<size_t>(position) * row_stride + d] = sv[d];
          }
          if (tid == 0) {
            k_scale[row0 + position] = ks;
            v_scale[row0 + position] = vs;
          }
        }
        pos_k = reinterpret_cast<const C*>(sk);
        pos_v = reinterpret_cast<const C*>(sv);
        pos_ks = ks;
        pos_vs = vs;
      }
    }
  }
  if constexpr (!APPEND && KIND != kFp) {
    if (has_pos) {
      pos_ks = k_scale[row0 + position];
      pos_vs = v_scale[row0 + position];
    }
  }

  // ---- 2. attend: the chunk's slots before `position`, then `position` --------
  State<NH, EPL> st;
  st.init();
  attend_range<T, KIND, PAIR>(st, qv, k_rows, v_rows, static_cast<size_t>(row_stride),
                              k_scale + row0, v_scale + row0, mask_row, lo, min(hi, position),
                              n_groups, grp, lm, G);
  if (has_pos)  // slot `position`, by group 0, at the same point in every kind
    attend_pos<T, KIND, PAIR>(st, qv, pos_k, pos_v, pos_ks, pos_vs, mask_row[position] != 0,
                              grp, lm, G);

  // ---- 3. merge the groups of the block, in group order ------------------------
  const int P = NH * (2 + hd);  // one partial: m[NH], l[NH], acc[NH][hd]
  float* part = n_split > 1
                    ? scratch + ((static_cast<size_t>(b) * n_hb + hb) * n_split + s_idx) * P
                    : nullptr;
  merge_groups<NH, EPL, kThreads>(
      st, gm, gl, gacc, n_groups, grp, lg, hd, tid, sync,
      [&](int h, int d, int idx, float M, float Lsum, float A) {
        if (n_split == 1) {
          ctx[static_cast<size_t>(b) * D + head_of<PAIR>(hb, h, n_head) * hd + d] =
              from_f<T>(Lsum > 0.0f ? A / Lsum : 0.0f);
        } else {
          if (d == 0) {
            part[h] = M;
            part[NH + h] = Lsum;
          }
          part[2 * NH + idx] = A;
        }
      });
  if (n_split == 1) return;

  // ---- 4. the last chunk of (b, head) to finish merges the chunks, in order ----
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + b * n_hb + hb, 1);
    is_last = prev == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = scratch + (static_cast<size_t>(b) * n_hb + hb) * n_split * P;
  for (int idx = tid; idx < NH * hd; idx += kThreads) {
    const int h = idx / hd, d = idx % hd;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(parts + s * P + h));
    float Lsum = 0.0f, A = 0.0f;
    if (M != -INFINITY)
      for (int s = 0; s < n_split; ++s) {
        const float ms = __ldcg(parts + s * P + h);
        const float f = ms == -INFINITY ? 0.0f : expf(ms - M);
        Lsum += __ldcg(parts + s * P + NH + h) * f;
        A += __ldcg(parts + s * P + 2 * NH + idx) * f;
      }
    ctx[static_cast<size_t>(b) * D + head_of<PAIR>(hb, h, n_head) * hd + d] =
        from_f<T>(Lsum > 0.0f ? A / Lsum : 0.0f);
  }
  if (tid == 0) counters[b * n_hb + hb] = 0;  // ready for the next call
}

template <typename T, int KIND, bool APPEND, bool PAIR>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, void* k_cache_, void* v_cache_,
                        float* k_scale, float* v_scale, const int32_t* __restrict__ key_mask,
                        T* __restrict__ ctx, float* __restrict__ scratch, int* counters,
                        int B, int T_cap, int D, int n_head, int position, int layer,
                        float q_scale, int row_stride, int chunk, int G) {
  attention_block<T, KIND, APPEND, PAIR>(
      q, k_new, v_new, k_cache_, v_cache_, k_scale, v_scale, key_mask, ctx, scratch, counters, B, T_cap, D, n_head, position, layer, q_scale, row_stride, chunk, G);
}

// int4: four blocks an SM (at most 128 registers a thread), the occupancy
// these kernels had before their stages moved to decode_attention.cuh, where
// the head-pair append took 147 registers and 3 blocks an SM (13% slower at
// B=512). The other kinds keep the compiler's own choice: any second launch
// bound (even 1) made the bf16 fp kernels up to 39% slower.
template <typename T, int KIND, bool APPEND, bool PAIR>
__global__ void __launch_bounds__(kThreads, 4)
decode_attention_int4_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, void* k_cache_, void* v_cache_,
                        float* k_scale, float* v_scale, const int32_t* __restrict__ key_mask,
                        T* __restrict__ ctx, float* __restrict__ scratch, int* counters,
                        int B, int T_cap, int D, int n_head, int position, int layer,
                        float q_scale, int row_stride, int chunk, int G) {
  attention_block<T, KIND, APPEND, PAIR>(
      q, k_new, v_new, k_cache_, v_cache_, k_scale, v_scale, key_mask, ctx, scratch, counters, B, T_cap, D, n_head, position, layer, q_scale, row_stride, chunk, G);
}

template <typename T, int KIND, bool APPEND, bool PAIR>
constexpr auto kernel_of() {
  if constexpr (KIND == kInt4)
    return &decode_attention_int4_kernel<T, KIND, APPEND, PAIR>;
  else
    return &decode_attention_kernel<T, KIND, APPEND, PAIR>;
}

struct Args {
  const void *q, *k_new, *v_new;
  void *k_cache, *v_cache, *k_scale, *v_scale;
  const void* key_mask;
  void *ctx, *scratch, *counters;
  int B, T_cap, D, n_head, position, layer;
  float q_scale;
  int row_stride, n_split, chunk;
  cudaStream_t stream;
};

template <typename T, int KIND, bool APPEND, bool PAIR>
int launch(const Args& a) {
  using K = Kind<T, KIND, PAIR>;
  const int hd = a.D / a.n_head;
  const int G = group_lanes<T, KIND, PAIR>(hd);
  if (G > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_groups = kThreads / G;
  const int row_w = KIND == kInt4 ? a.D / 2 : a.D;
  const size_t stage = APPEND && KIND != kFp ? 2 * static_cast<size_t>((row_w + 15) & ~15) : 0;
  const size_t smem = stage + sizeof(float) * K::NH * n_groups * (2 + static_cast<size_t>(hd));
  auto kernel = kernel_of<T, KIND, APPEND, PAIR>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.n_split, a.n_head / K::NH, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), a.k_cache, a.v_cache, static_cast<float*>(a.k_scale),
      static_cast<float*>(a.v_scale), static_cast<const int32_t*>(a.key_mask),
      static_cast<T*>(a.ctx), static_cast<float*>(a.scratch), static_cast<int*>(a.counters),
      a.B, a.T_cap, a.D, a.n_head, a.position, a.layer, a.q_scale, a.row_stride, a.chunk, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool APPEND>
int launch_kind(const Args& a, int kind, bool pair) {
  if (kind == kFp) return launch<T, kFp, APPEND, false>(a);
  if (kind == kInt8) return launch<T, kInt8, APPEND, false>(a);
  return pair ? launch<T, kInt4, APPEND, true>(a) : launch<T, kInt4, APPEND, false>(a);
}

template <typename T>
int launch_dtype(const Args& a, int kind, bool append, bool pair) {
  return append ? launch_kind<T, true>(a, kind, pair) : launch_kind<T, false>(a, kind, pair);
}

}  // namespace

// C entry point (bound with ctypes). Shapes: q/k_new/v_new/ctx [B, D] (k_new /
// v_new unused without `append`); caches [L, B, T_cap, row_stride] of q's type
// (cache_kind 0), int8 (1) or int8 holding two int4 codes a byte (2);
// `row_stride` is the cache's last dimension in elements: D, D/2 for int4, or
// 2D for the merged k||v buffer, whose v half the caller passes as
// v_cache = k_cache + D. Scales [L, B, T_cap] f32 (ignored for kind 0);
// key_mask [B, T_cap] int32. dtype: 0 = float32, 1 = bfloat16. The slots
// 0..position are taken in n_split chunks of `chunk` (the last one holds
// `position`); with n_split > 1, `scratch` holds B * n_head * n_split * (hd +
// 2) f32 and `counters` B * n_head int32 that are ZERO (each call leaves them
// zero). `pair` (int4 only, even n_head, 16 | hd): a block owns heads h and
// h + n_head/2. Cache rows and their head slices start on 16-byte boundaries.
// Returns cudaGetLastError() after the launch (0 on success). The caller
// validates shapes and bounds.
extern "C" int mmtg_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* key_mask, void* ctx, void* scratch,
    void* counters, int B, int T_cap, int D, int n_head, int position, int layer,
    float q_scale, int cache_kind, int append, int row_stride, int dtype, int n_split,
    int chunk, int pair, void* stream) {
  const Args a{q,        k_new,  v_new,    k_cache, v_cache,  k_scale, v_scale,
               key_mask, ctx,    scratch,  counters, B,       T_cap,   D,
               n_head,   position, layer,  q_scale, row_stride, n_split, chunk,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(a, cache_kind, append != 0, pair != 0);
  return launch_dtype<float>(a, cache_kind, append != 0, pair != 0);
}
