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
// and 2x / 4x for bf16 / f32, and does 2 FLOPs per byte or less.
//
// Design (simple and right first):
//   * one block per batch row, one warp per head: the per-row quantisation
//     scale spans all heads, so the block computes the row's abs-max, writes
//     the quantised row and both scales, __syncthreads(), and only then
//     streams slots 0..position. No block reads another block's row.
//   * a warp keeps its head's q and accumulator in registers (hd <= 128, up
//     to 4 values per lane) and walks the slots in chunks of kChunk, issuing
//     the chunk's k and v loads before the reductions so that several loads
//     are in flight per warp.
//   * int4: a byte holds lanes j and j + D/2, which belong to two heads; each
//     head's warp reads the bytes that hold its lanes and takes its nibble
//     (the byte is fetched by two warps of the block, once from memory).
// Known limits, left to later work: B blocks under-fill the 132 SMs at small
// B (B=64 uses 64 SMs); a lane reads 1-4 bytes per slot instead of 16; no
// split over T; no TMA or wgmma.

#include "decode_attention.cuh"

namespace {

using namespace mmtg;

template <typename T, int KIND, bool APPEND>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, void* k_cache_, void* v_cache_,
    float* k_scale, float* v_scale, const int32_t* __restrict__ key_mask,
    T* __restrict__ ctx, int B, int T_cap, int D, int n_head, int position,
    int layer, float q_scale, int row_stride) {
  using C = typename CacheElem<T, KIND>::type;
  extern __shared__ float staged[];  // APPEND: the step's k and v rows, 2 * D

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hd = D / n_head;

  // slot 0 of (layer, b): row index into the [L*B*T] rows of the cache
  const size_t row0 = (static_cast<size_t>(layer) * B + b) * T_cap;
  C* k_rows = static_cast<C*>(k_cache_) + row0 * row_stride;
  C* v_rows = static_cast<C*>(v_cache_) + row0 * row_stride;

  // ---- 1. append the step's row at `position` -----------------------------
  if constexpr (APPEND) {
    for (int d = tid; d < D; d += blockDim.x) {
      staged[d] = to_f(k_new[static_cast<size_t>(b) * D + d]);
      staged[D + d] = to_f(v_new[static_cast<size_t>(b) * D + d]);
    }
    __syncthreads();
    const size_t slot = static_cast<size_t>(position) * row_stride;
    append_row<T, KIND>(staged, staged + D, k_rows + slot, v_rows + slot,
                        k_scale + row0 + position, v_scale + row0 + position, D);
  }

  // ---- 2. attend: warp `warp` owns head `warp` ----------------------------
  const int hoff = warp * hd;
  float qv[kMaxLaneElems];
  float out[kMaxLaneElems];
#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) {
    const int d = lane + 32 * i;
    // pre-scale and round back to T, as the TPU wrapper does
    qv[i] = d < hd ? round_to<T>(to_f(q[static_cast<size_t>(b) * D + hoff + d]) * q_scale)
                   : 0.0f;
  }
  attend_head<C, KIND>(qv, k_rows, v_rows, static_cast<size_t>(row_stride),
                       k_scale + row0, v_scale + row0,
                       key_mask + static_cast<size_t>(b) * T_cap, position, D, hd,
                       hoff, lane, out);
#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) ctx[static_cast<size_t>(b) * D + hoff + d] = from_f<T>(out[i]);
  }
}

struct Args {
  const void *q, *k_new, *v_new;
  void *k_cache, *v_cache, *k_scale, *v_scale;
  const void* key_mask;
  void* ctx;
  int B, T_cap, D, n_head, position, layer;
  float q_scale;
  int row_stride;
  cudaStream_t stream;
};

template <typename T, int KIND, bool APPEND>
void launch(const Args& a) {
  const size_t smem = APPEND ? 2 * sizeof(float) * a.D : 0;
  decode_attention_kernel<T, KIND, APPEND><<<a.B, a.n_head * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), a.k_cache, a.v_cache,
      static_cast<float*>(a.k_scale), static_cast<float*>(a.v_scale),
      static_cast<const int32_t*>(a.key_mask), static_cast<T*>(a.ctx), a.B,
      a.T_cap, a.D, a.n_head, a.position, a.layer, a.q_scale, a.row_stride);
}

template <typename T>
void launch_kind(const Args& a, int kind, bool append) {
  if (kind == kFp) {
    append ? launch<T, kFp, true>(a) : launch<T, kFp, false>(a);
  } else if (kind == kInt8) {
    append ? launch<T, kInt8, true>(a) : launch<T, kInt8, false>(a);
  } else {
    append ? launch<T, kInt4, true>(a) : launch<T, kInt4, false>(a);
  }
}

}  // namespace

// C entry point (bound with ctypes). Shapes: q/k_new/v_new/ctx [B, D] (k_new /
// v_new unused without `append`); caches [L, B, T_cap, row_stride] of q's type
// (cache_kind 0), int8 (1) or int8 holding two int4 codes a byte (2);
// `row_stride` is the cache's last dimension in elements: D, D/2 for int4, or
// 2D for the merged k||v buffer, whose v half the caller passes as
// v_cache = k_cache + D. Scales [L, B, T_cap] f32 (ignored for kind 0);
// key_mask [B, T_cap] int32. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 on success). The caller validates
// shapes and bounds.
extern "C" int mmtg_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* key_mask,
    void* ctx, int B, int T_cap, int D, int n_head, int position, int layer,
    float q_scale, int cache_kind, int append, int row_stride, int dtype,
    void* stream) {
  const Args a{q,       k_new,    v_new, k_cache, v_cache, k_scale,
               v_scale, key_mask, ctx,   B,       T_cap,   D,
               n_head,  position, layer, q_scale, row_stride,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 1)
    launch_kind<__nv_bfloat16>(a, cache_kind, append != 0);
  else
    launch_kind<float>(a, cache_kind, append != 0);
  return static_cast<int>(cudaGetLastError());
}
