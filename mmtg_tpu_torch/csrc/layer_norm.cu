// Batch-invariant LayerNorm over the last axis, with the port's numerics
// (models/gpt2.layer_norm, the JAX package's): the row's mean and variance
// accumulate in f32, the elementwise steps round to the input's type:
//   mean = round_T(sum(x) / D); xm = round_T(x - mean);
//   var = sum(round_T(xm * xm)) / D; rstd = round_T(rsqrt(var + eps));
//   out = round_T(round_T(round_T(xm * rstd) * g) + b).
// The residual form takes the decode step's pending add into the same launch:
//   h_new = round_T(round_T(h + y) + bias) (the eager `h + y + bias`, left to
//   right), written out, and out = LayerNorm(h_new).
//
// Replaces no TPU kernel. It was added so that a row's statistics do not
// depend on the rows beside it: on the card PyTorch's reduction kernel sets how
// many threads share a row, and the order they sum in, by the number of rows,
// so a row's mean (and, after its rounding, the row) changed with the batch.
// Here one warp sums a row: each lane its own values in a fixed order, then the
// lanes in a fixed butterfly, an order set by D alone. A block holds kWarps
// rows; the block size does not touch a row's order.
//
// What bounds it on the H100: bytes (x read, out written; a few operations an
// element) and, at the decode's few rows, latency. So a lane reads its share
// of the row once, in 16-byte vectors, with the gain and bias (and the
// residual's y and bias) loads in flight at the same time, keeps it in
// registers for both reductions and the output, and writes each output once.
// D is a template constant at the model's widths (768: GPT-2; 512: the
// encoder's LayerNorms); any other width runs the same kernel with D = 0, a
// lane's values read with scalar loads, the row read again for each pass.
// The elementwise steps use __fadd_rn / __fmul_rn, so the compiler contracts
// none of them into an FMA (the f32 form rounds as the eager ops do).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 2;  // rows (warps) a block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }
template <typename T>
__device__ __forceinline__ float add_r(float a, float b) { return round_to<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float mul_r(float a, float b) { return round_to<T>(__fmul_rn(a, b)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a 16-byte vector of T as floats, and back
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) f[j] = to_f(t[j]);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) t[j] = from_f<T>(f[j]);
  return u;
}

// One warp a row, kWarps rows a block. kD > 0: the row's width, a
// multiple of 32 vectors (every pointer 16-byte aligned); kD == 0: `D` at run
// time. kAdd: x is h, and y and c (the residual and its bias [D]) are added
// first, the sum written to h_out.
template <typename T, int kD, bool kAdd>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ c,
                      const T* __restrict__ g, const T* __restrict__ b, T* __restrict__ h_out,
                      T* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  if constexpr (kD > 0) {
    constexpr int V = 16 / sizeof(T);   // values a vector
    constexpr int C = kD / (32 * V);    // vectors a lane
    static_assert(kD % (32 * V) == 0, "a lane takes whole vectors");
    const size_t row = static_cast<size_t>(r) * (kD / V);
    const uint4* xr = reinterpret_cast<const uint4*>(x) + row;
    uint4 xv[C], yv[C], cv[C], gv[C], bv[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {  // every load of the lane in flight at once
      const int k = lane + 32 * u;
      xv[u] = __ldg(xr + k);
      if constexpr (kAdd) {
        yv[u] = __ldg(reinterpret_cast<const uint4*>(y) + row + k);
        cv[u] = __ldg(reinterpret_cast<const uint4*>(c) + k);
      }
      gv[u] = __ldg(reinterpret_cast<const uint4*>(g) + k);
      bv[u] = __ldg(reinterpret_cast<const uint4*>(b) + k);
    }
    float v[C * V];
#pragma unroll
    for (int u = 0; u < C; ++u) unpack<T>(xv[u], v + u * V);
    if constexpr (kAdd) {
#pragma unroll
      for (int u = 0; u < C; ++u) {
        float t[V], s[V];
        unpack<T>(yv[u], t);
        unpack<T>(cv[u], s);
#pragma unroll
        for (int j = 0; j < V; ++j) v[u * V + j] = add_r<T>(add_r<T>(v[u * V + j], t[j]), s[j]);
        reinterpret_cast<uint4*>(h_out)[row + lane + 32 * u] = pack<T>(v + u * V);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < C * V; ++i) sum += v[i];
    const float mean = round_to<T>(warp_sum(sum) / static_cast<float>(kD));
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < C * V; ++i) {
      v[i] = round_to<T>(__fsub_rn(v[i], mean));
      sq += mul_r<T>(v[i], v[i]);
    }
    const float rstd = round_to<T>(rsqrtf(warp_sum(sq) / static_cast<float>(kD) + eps));
#pragma unroll
    for (int u = 0; u < C; ++u) {
      float gg[V], bb[V], o[V];
      unpack<T>(gv[u], gg);
      unpack<T>(bv[u], bb);
#pragma unroll
      for (int j = 0; j < V; ++j) o[j] = add_r<T>(mul_r<T>(mul_r<T>(v[u * V + j], rstd), gg[j]), bb[j]);
      reinterpret_cast<uint4*>(out)[row + lane + 32 * u] = pack<T>(o);
    }
  } else {
    const size_t row = static_cast<size_t>(r) * D;
    // the row's value at d: x, or h + y + bias (recomputed in each pass: the
    // same bits every time)
    auto at = [&](int d) {
      float v = to_f(x[row + d]);
      if constexpr (kAdd) v = add_r<T>(add_r<T>(v, to_f(y[row + d])), to_f(c[d]));
      return v;
    };
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = at(d);
      if constexpr (kAdd) h_out[row + d] = from_f<T>(v);
      sum += v;
    }
    const float mean = round_to<T>(warp_sum(sum) / static_cast<float>(D));
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xm = round_to<T>(__fsub_rn(at(d), mean));
      sq += mul_r<T>(xm, xm);
    }
    const float rstd = round_to<T>(rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps));
    for (int d = lane; d < D; d += 32) {
      const float xm = round_to<T>(__fsub_rn(at(d), mean));
      out[row + d] = from_f<T>(add_r<T>(mul_r<T>(mul_r<T>(xm, rstd), to_f(g[d])), to_f(b[d])));
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int kD, bool kAdd>
void start(int R, int D, float eps, cudaStream_t s, const void* x, const void* y, const void* c,
           const void* g, const void* b, void* h_out, void* out) {
  layer_norm_kernel<T, kD, kAdd><<<(R + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(c),
      static_cast<const T*>(g), static_cast<const T*>(b), static_cast<T*>(h_out),
      static_cast<T*>(out), R, D, eps);
}

template <typename T, bool kAdd>
int launch(int R, int D, float eps, cudaStream_t s, const void* x, const void* y, const void* c,
           const void* g, const void* b, void* h_out, void* out) {
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  if (D == 768 || D == 512) {  // the vector form: 16-byte aligned rows
    const void* ptrs[] = {x, g, b, out, kAdd ? y : x, kAdd ? c : x, kAdd ? h_out : out};
    for (const void* p : ptrs)
      if (!aligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 768)
      start<T, 768, kAdd>(R, D, eps, s, x, y, c, g, b, h_out, out);
    else
      start<T, 512, kAdd>(R, D, eps, s, x, y, c, g, b, h_out, out);
  } else {
    start<T, 0, kAdd>(R, D, eps, s, x, y, c, g, b, h_out, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). x, out [R, D] contiguous, g and b [D],
// all of one type (dtype 0 = float32, 1 = bfloat16). Return
// cudaGetLastError() after the launch (0 on success). The caller validates
// shapes, and at D = 768 or 512 passes 16-byte aligned pointers.
extern "C" int mmtg_layer_norm(const void* x, const void* g, const void* b, void* out, int R,
                               int D, float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16, false>(R, D, eps, s, x, nullptr, nullptr, g, b,
                                                   nullptr, out)
                    : launch<float, false>(R, D, eps, s, x, nullptr, nullptr, g, b, nullptr, out);
}

// The residual form: h, y, h_out [R, D], bias [D]; h_out = h + y + bias (in
// that order, rounded to the type after each add) and out = LayerNorm(h_out).
extern "C" int mmtg_add_layer_norm(const void* h, const void* y, const void* bias, const void* g,
                                   const void* b, void* h_out, void* out, int R, int D, float eps,
                                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16, true>(R, D, eps, s, h, y, bias, g, b, h_out, out)
                    : launch<float, true>(R, D, eps, s, h, y, bias, g, b, h_out, out);
}
