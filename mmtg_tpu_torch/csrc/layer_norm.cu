// Batch-invariant LayerNorm over the last axis, with the port's numerics
// (models/gpt2.layer_norm, the JAX package's): the row's mean and variance
// accumulate in f32, the elementwise steps round to the input's type:
//   mean = round_T(sum(x) / D); xm = round_T(x - mean);
//   var = sum(round_T(xm * xm)) / D; rstd = round_T(rsqrt(var + eps));
//   out = round_T(round_T(round_T(xm * rstd) * g) + b).
//
// Replaces no TPU kernel. It was added so that a row's statistics do not
// depend on the rows beside it: on the card PyTorch's reduction kernel sets how
// many threads share a row, and the order they sum in, by the number of rows,
// so a row's mean (and, after its rounding, the row) changed with the batch.
// Here one warp sums a row, each lane its strided values in order, then the
// lanes in a fixed butterfly: an order set by D alone. The whole-step kernel
// (decode_block_fused.cu, ln_stage) normalises the same way.
//
// What bounds it on the H100: bytes (x read, out written; a few operations an
// element) and, at the decode's few rows, latency: a warp a row, eight rows a
// block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows a block

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                      T* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * D;
  T* yr = out + static_cast<size_t>(r) * D;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum += to_f(xr[d]);
  const float mean = round_to<T>(warp_sum(sum) / static_cast<float>(D));
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float xm = round_to<T>(to_f(xr[d]) - mean);
    sq += round_to<T>(xm * xm);
  }
  const float rstd = round_to<T>(rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps));
  for (int d = lane; d < D; d += 32) {
    const float xm = round_to<T>(to_f(xr[d]) - mean);
    yr[d] = from_f<T>(round_to<T>(round_to<T>(xm * rstd) * to_f(g[d])) + to_f(b[d]));
  }
}

}  // namespace

// C entry point (bound with ctypes). x, out [R, D] contiguous, g and b [D],
// all of one type (dtype 0 = float32, 1 = bfloat16). Returns
// cudaGetLastError() after the launch (0 on success). The caller validates
// shapes.
extern "C" int mmtg_layer_norm(const void* x, const void* g, const void* b, void* out, int R,
                               int D, float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kWarps - 1) / kWarps);
  if (dtype == 1)
    layer_norm_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), R, D, eps);
  else
    layer_norm_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(out), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}
