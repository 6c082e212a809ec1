// Fused append + single-query decode attention for the KV-cached decode step.
//
// Replaces the TPU kernel mmtg_tpu/ops/decode_attention_unified.py
// (_unified_kernel, built by build_call) as called through
// mmtg_tpu/ops/decode_attention.py decode_attention_int8_append (CACHE="int8")
// and decode_attention_fp_append (CACHE="fp"), both with APPEND=True.
//
// What it computes, for one layer `layer` of a [L, B, T, D] cache (heads
// merged into D = H * hd):
//   1. append: the step's k/v rows go into slot `position`. The int8 cache
//      stores clip(rint(x / s), -127, 127) with s = max(max|x|, 1e-6) / 127
//      over the WHOLE D-wide row (all heads), i.e. gpt2.quantize_rows, and
//      writes s to k_scale / v_scale. The fp cache stores the row as is.
//   2. attend: q (pre-scaled by 1/sqrt(hd) and rounded back to its own type,
//      as the TPU wrapper does) against slots t <= position with
//      key_mask[b, t] != 0. The k scale folds into the score, the v scale
//      into the probability. Scores, running max, sum and accumulator are f32
//      (online softmax); ctx is stored in q's type.
//
// What bounds it on the H100: bytes. Each call streams the live cache prefix
// of one layer, (position + 1) * D bytes per row for int8 and 2x / 4x that
// for bf16 / f32, and does 2 FLOPs per byte or less.
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
//   * slots past `position` are never read; masked slots are skipped, which
//     gives the TPU kernel's result (there they add -1e30 to the score).
//   * division is IEEE (build without --use_fast_math) and rounding is
//     rintf (half to even, like jnp.round / torch.round), so the int8 cache
//     and scales are bit-identical to the plain PyTorch version.
// Known limits, left to later work: B blocks under-fill the 132 SMs at small
// B (B=64 uses 64 SMs); a lane reads 1-4 bytes per slot instead of 16; no
// split over T; no TMA or wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLaneElems = 4;  // head_dim <= 128
constexpr int kChunk = 8;         // slots per warp iteration

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  // true IEEE division and round-half-even: gpt2.quantize_rows bit for bit
  const float r = rintf(x / scale);
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

template <typename T, bool INT8>
__global__ void decode_attention_append_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, void* __restrict__ k_cache_,
    void* __restrict__ v_cache_, float* __restrict__ k_scale,
    float* __restrict__ v_scale, const int32_t* __restrict__ key_mask,
    T* __restrict__ ctx, int B, int T_cap, int D, int n_head, int position,
    int layer, float q_scale) {
  using C = typename std::conditional<INT8, int8_t, T>::type;
  C* k_cache = static_cast<C*>(k_cache_);
  C* v_cache = static_cast<C*>(v_cache_);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int hd = D / n_head;

  // slot 0 of (layer, b): row index into the [L*B*T] rows of the cache
  const size_t row0 = (static_cast<size_t>(layer) * B + b) * T_cap;
  C* k_rows = k_cache + row0 * D;
  C* v_rows = v_cache + row0 * D;
  const T* kn = k_new + static_cast<size_t>(b) * D;
  const T* vn = v_new + static_cast<size_t>(b) * D;

  // ---- 1. append the step's row at `position` -----------------------------
  if constexpr (INT8) {
    __shared__ float red[2][32];
    float mk = 0.0f, mv = 0.0f;
    for (int d = tid; d < D; d += blockDim.x) {
      mk = fmaxf(mk, fabsf(to_f(kn[d])));
      mv = fmaxf(mv, fabsf(to_f(vn[d])));
    }
    mk = warp_max(mk);
    mv = warp_max(mv);
    if (lane == 0) {
      red[0][warp] = mk;
      red[1][warp] = mv;
    }
    __syncthreads();
    mk = 0.0f;
    mv = 0.0f;
    for (int w = 0; w < n_warps; ++w) {
      mk = fmaxf(mk, red[0][w]);
      mv = fmaxf(mv, red[1][w]);
    }
    const float ks = fmaxf(mk, 1e-6f) / 127.0f;
    const float vs = fmaxf(mv, 1e-6f) / 127.0f;
    for (int d = tid; d < D; d += blockDim.x) {
      k_rows[static_cast<size_t>(position) * D + d] = quantize(to_f(kn[d]), ks);
      v_rows[static_cast<size_t>(position) * D + d] = quantize(to_f(vn[d]), vs);
    }
    if (tid == 0) {
      k_scale[row0 + position] = ks;
      v_scale[row0 + position] = vs;
    }
  } else {
    for (int d = tid; d < D; d += blockDim.x) {
      k_rows[static_cast<size_t>(position) * D + d] = kn[d];
      v_rows[static_cast<size_t>(position) * D + d] = vn[d];
    }
  }
  // the appended row (and its scales) are visible to the whole block
  __syncthreads();

  // ---- 2. attend: warp `warp` owns head `warp` ----------------------------
  const int h = warp;
  const int hoff = h * hd;
  float qv[kMaxLaneElems];
  float acc[kMaxLaneElems];
#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) {
    const int d = lane + 32 * i;
    // pre-scale and round back to T, as the TPU wrapper does
    qv[i] = d < hd ? to_f(from_f<T>(to_f(q[static_cast<size_t>(b) * D + hoff + d]) * q_scale))
                   : 0.0f;
    acc[i] = 0.0f;
  }
  const int32_t* mask_row = key_mask + static_cast<size_t>(b) * T_cap;
  float m = -INFINITY;
  float l = 0.0f;

  for (int t0 = 0; t0 <= position; t0 += kChunk) {
    float s[kChunk];
    float vv[kChunk][kMaxLaneElems];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      // warp-uniform: every lane reads the same mask word
      const bool live = t <= position && mask_row[t] != 0;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxLaneElems; ++i) {
        const int d = lane + 32 * i;
        vv[c][i] = 0.0f;
        if (live && d < hd) {
          const size_t off = static_cast<size_t>(t) * D + hoff + d;
          part += qv[i] * to_f(k_rows[off]);
          vv[c][i] = to_f(v_rows[off]);
        }
      }
      part = warp_sum(part);
      if constexpr (INT8) {
        if (live) part *= k_scale[row0 + t];
      }
      s[c] = live ? part : -INFINITY;
    }
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) cmax = fmaxf(cmax, s[c]);
    if (cmax == -INFINITY) continue;  // no live slot in this chunk
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);  // m == -inf gives 0
    l *= corr;
#pragma unroll
    for (int i = 0; i < kMaxLaneElems; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (s[c] == -INFINITY) continue;
      float p = expf(s[c] - m_new);
      l += p;
      if constexpr (INT8) p *= v_scale[row0 + t0 + c];
#pragma unroll
      for (int i = 0; i < kMaxLaneElems; ++i) acc[i] += p * vv[c][i];
    }
    m = m_new;
  }

#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) {
      ctx[static_cast<size_t>(b) * D + hoff + d] = from_f<T>(l > 0.0f ? acc[i] / l : 0.0f);
    }
  }
}

template <typename T, bool INT8>
void launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
            void* v_cache, void* k_scale, void* v_scale, const void* key_mask,
            void* ctx, int B, int T_cap, int D, int n_head, int position,
            int layer, float q_scale, cudaStream_t stream) {
  decode_attention_append_kernel<T, INT8><<<B, n_head * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), k_cache, v_cache,
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int32_t*>(key_mask), static_cast<T*>(ctx), B, T_cap, D,
      n_head, position, layer, q_scale);
}

}  // namespace

// C entry point (bound with ctypes). Shapes: q/k_new/v_new/ctx [B, D];
// caches [L, B, T_cap, D] (int8 when int8_cache, else q's type); scales
// [L, B, T_cap] f32 (ignored for the fp cache); key_mask [B, T_cap] int32.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success). The caller validates shapes and bounds.
extern "C" int mmtg_decode_attention_append(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, void* k_scale, void* v_scale, const void* key_mask,
    void* ctx, int B, int T_cap, int D, int n_head, int position, int layer,
    float q_scale, int int8_cache, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (int8_cache)
      launch<__nv_bfloat16, true>(q, k_new, v_new, k_cache, v_cache, k_scale,
                                  v_scale, key_mask, ctx, B, T_cap, D, n_head,
                                  position, layer, q_scale, s);
    else
      launch<__nv_bfloat16, false>(q, k_new, v_new, k_cache, v_cache, k_scale,
                                   v_scale, key_mask, ctx, B, T_cap, D, n_head,
                                   position, layer, q_scale, s);
  } else {
    if (int8_cache)
      launch<float, true>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                          key_mask, ctx, B, T_cap, D, n_head, position, layer,
                          q_scale, s);
    else
      launch<float, false>(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                           key_mask, ctx, B, T_cap, D, n_head, position, layer,
                           q_scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
