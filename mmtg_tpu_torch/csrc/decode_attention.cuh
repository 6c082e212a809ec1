// Device functions shared by the decode kernels: the append stage (store or
// quantize one k/v row into its cache slot) and the attend stage (one warp,
// one head, online softmax over the live slots). decode_attention.cu wraps
// them in a kernel of their own; decode_block_fused.cu calls them from inside
// the whole-step kernel, so the two paths cannot drift apart.
//
// Cache kinds (the TPU kernel's CACHE build flag, decode_attention_unified.py):
//   kFp    rows of T, D wide;
//   kInt8  rows of int8, D wide, one f32 scale a row: clip(rint(x / s), -127,
//          127) with s = max(max|x|, 1e-6) / 127 over the WHOLE row
//          (gpt2.quantize_rows);
//   kInt4  rows of D/2 bytes, one f32 scale a row: codes clip(rint(x / s), -7,
//          7) with s = max(max|x|, 1e-6) / 7; byte j holds lane j in its low
//          nibble and lane j + D/2 in its high nibble
//          (gpt2.quantize_rows_int4 / unpack_int4).
// A cache row may be wider than what one of k or v stores (`row_stride`,
// counted in cache elements): the merged k||v cache keeps k in the low half
// of a 2D-wide row and v in the high half.
//
// Division is IEEE (the build has no --use_fast_math) and rounding is rintf
// (half to even), so quantized rows and scales are bit-identical to the plain
// PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mmtg {

constexpr int kMaxLaneElems = 4;  // head_dim <= 128
constexpr int kChunk = 8;         // slots per warp iteration
constexpr int kFp = 0, kInt8 = 1, kInt4 = 2;

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

// x rounded to T and back: where the stream dtype rounds
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

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

__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  // true IEEE division and round-half-even: gpt2.quantize_rows bit for bit
  const float r = rintf(x / scale);
  return static_cast<int>(fminf(fmaxf(r, -qmax), qmax));
}

template <typename T, int KIND>
struct CacheElem {
  using type = typename std::conditional<KIND == kFp, T, int8_t>::type;
};

// Append stage, called by every thread of the block. `kf` / `vf`: the step's
// k / v row, D floats in shared memory holding values of type T. `k_slot` /
// `v_slot`: where the row's slot starts in the cache. `ks_out` / `vs_out`:
// the slot's scale (unused for kFp). Ends with a __syncthreads(), after which
// the row and its scales are visible to the whole block.
template <typename T, int KIND>
__device__ __forceinline__ void append_row(
    const float* kf, const float* vf, typename CacheElem<T, KIND>::type* k_slot,
    typename CacheElem<T, KIND>::type* v_slot, float* ks_out, float* vs_out, int D) {
  const int tid = threadIdx.x;
  if constexpr (KIND == kFp) {
    for (int d = tid; d < D; d += blockDim.x) {
      k_slot[d] = from_f<T>(kf[d]);
      v_slot[d] = from_f<T>(vf[d]);
    }
  } else {
    __shared__ float red[2][32];
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = (blockDim.x + 31) >> 5;
    float mk = 0.0f, mv = 0.0f;
    for (int d = tid; d < D; d += blockDim.x) {
      mk = fmaxf(mk, fabsf(kf[d]));
      mv = fmaxf(mv, fabsf(vf[d]));
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
    constexpr float qmax = KIND == kInt8 ? 127.0f : 7.0f;
    const float ks = fmaxf(mk, 1e-6f) / qmax;
    const float vs = fmaxf(mv, 1e-6f) / qmax;
    if constexpr (KIND == kInt8) {
      for (int d = tid; d < D; d += blockDim.x) {
        k_slot[d] = static_cast<int8_t>(quantize(kf[d], ks, qmax));
        v_slot[d] = static_cast<int8_t>(quantize(vf[d], vs, qmax));
      }
    } else {
      const int half = D >> 1;
      for (int j = tid; j < half; j += blockDim.x) {
        const int klo = quantize(kf[j], ks, qmax), khi = quantize(kf[j + half], ks, qmax);
        const int vlo = quantize(vf[j], vs, qmax), vhi = quantize(vf[j + half], vs, qmax);
        k_slot[j] = static_cast<int8_t>(((khi & 15) << 4) | (klo & 15));
        v_slot[j] = static_cast<int8_t>(((vhi & 15) << 4) | (vlo & 15));
      }
    }
    if (tid == 0) {
      *ks_out = ks;
      *vs_out = vs;
    }
  }
  __syncthreads();
}

// One stored element as a float. For kInt4 `col` is the byte and `high`
// picks the nibble: the low one is sign-extended through a shift pair, the
// high one by the arithmetic shift (unpack_int4).
template <typename C, int KIND>
__device__ __forceinline__ float load_elem(const C* row, int col, bool high) {
  if constexpr (KIND == kInt4) {
    const int b = static_cast<int>(row[col]);  // sign-extended byte
    const int code = high ? (b >> 4) : (static_cast<int>(static_cast<int8_t>(b << 4)) >> 4);
    return static_cast<float>(code);
  } else {
    return to_f(row[col]);
  }
}

// Attend stage, called by one whole warp for one head. `qv`: the head's query,
// already scaled by 1/sqrt(hd) and rounded to T, lane `lane` holding lanes
// lane + 32 i of the head. `k_rows` / `v_rows`: slot 0 of this (layer, batch
// row); `scales`: that row's [T_cap] scale rows (unused for kFp). Walks slots
// 0..position in chunks, skipping masked ones (the TPU kernel adds -1e30 to
// their score: the same result unless every slot is masked). The k scale folds
// into the score, the v scale into the probability. `out`: ctx in f32.
template <typename C, int KIND>
__device__ __forceinline__ void attend_head(
    const float (&qv)[kMaxLaneElems], const C* k_rows, const C* v_rows,
    size_t row_stride, const float* k_scale, const float* v_scale,
    const int32_t* mask_row, int position, int D, int hd, int hoff, int lane,
    float (&out)[kMaxLaneElems]) {
  // which stored column each of this lane's elements lives in: with one warp a
  // head, the two nibbles of an int4 byte belong to two heads (lanes g and
  // g + D/2), so both heads' warps read the byte and each takes its nibble
  int col[kMaxLaneElems];
  bool high[kMaxLaneElems];
  float acc[kMaxLaneElems];
#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) {
    const int g = hoff + lane + 32 * i;
    if constexpr (KIND == kInt4) {
      const int half = D >> 1;
      high[i] = g >= half;
      col[i] = high[i] ? g - half : g;
    } else {
      high[i] = false;
      col[i] = g;
    }
    acc[i] = 0.0f;
  }
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
        vv[c][i] = 0.0f;
        if (live && lane + 32 * i < hd) {
          const size_t off = static_cast<size_t>(t) * row_stride;
          part += qv[i] * load_elem<C, KIND>(k_rows + off, col[i], high[i]);
          vv[c][i] = load_elem<C, KIND>(v_rows + off, col[i], high[i]);
        }
      }
      part = warp_sum(part);
      if constexpr (KIND != kFp) {
        if (live) part *= k_scale[t];
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
      if constexpr (KIND != kFp) p *= v_scale[t0 + c];
#pragma unroll
      for (int i = 0; i < kMaxLaneElems; ++i) acc[i] += p * vv[c][i];
    }
    m = m_new;
  }
#pragma unroll
  for (int i = 0; i < kMaxLaneElems; ++i) out[i] = l > 0.0f ? acc[i] / l : 0.0f;
}

}  // namespace mmtg
