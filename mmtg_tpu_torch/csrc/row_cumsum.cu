// Batch-invariant inclusive prefix sum along each row: out[r, i] = sum_{j <= i}
// x[r, j], summed in f32 and rounded to x's type once an entry, as
// torch.cumsum computes it.
//
// Replaces no TPU kernel. It was added for the sampler's nucleus (top-p)
// filter, the cumulative probability of the sorted candidates
// (ops/sampling._nucleus_mask_sorted): on the card torch.cumsum lays a row's
// scan out by the number of rows, so one row's sums, and with them where its
// nucleus ends, changed with the batch. Here a row's scan is one block's, in
// an order fixed by the row's length alone.
//
// What bounds it on the H100: bytes (each value read and written once; one
// add an element) and, for the decode's few rows, latency: one block a row.
//
// Design: a block of 256 threads walks its row in tiles of 4096 values. A tile
// comes into shared memory by coalesced loads; each thread sums its 16
// neighbouring values in order; thread 0 adds the 256 thread totals in order to
// the carry of the tiles before; each thread writes its 16 prefix sums. Every
// sum is taken in that one order whatever the number of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;  // values a thread sums in order
constexpr int kTile = kThreads * kPer;

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
__global__ void __launch_bounds__(kThreads) row_cumsum_kernel(const T* __restrict__ x,
                                                              T* __restrict__ out, int V) {
  __shared__ float vals[kTile];
  __shared__ float base[kThreads];
  __shared__ float carry;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * V;
  T* yr = out + static_cast<size_t>(blockIdx.x) * V;
  const int t = threadIdx.x;
  if (t == 0) carry = 0.0f;
  for (int t0 = 0; t0 < V; t0 += kTile) {
    const int n = min(kTile, V - t0);
    for (int i = t; i < kTile; i += kThreads) vals[i] = i < n ? to_f(xr[t0 + i]) : 0.0f;
    __syncthreads();
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) s += vals[t * kPer + j];
    base[t] = s;
    __syncthreads();
    if (t == 0) {  // the thread totals, in order, after the carry
      float c = carry;
      for (int i = 0; i < kThreads; ++i) {
        const float v = base[i];
        base[i] = c;
        c += v;
      }
      carry = c;
    }
    __syncthreads();
    float run = base[t];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = t * kPer + j;
      run += vals[i];
      vals[i] = run;
    }
    __syncthreads();
    for (int i = t; i < n; i += kThreads) yr[t0 + i] = from_f<T>(vals[i]);
    __syncthreads();  // vals, base and carry are used again
  }
}

}  // namespace

// C entry point (bound with ctypes). x, out [R, V] contiguous, of one type
// (dtype 0 = float32, 1 = bfloat16). Returns cudaGetLastError() after the
// launch (0 on success). The caller validates shapes.
extern "C" int mmtg_row_cumsum(const void* x, void* out, int R, int V, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    row_cumsum_kernel<__nv_bfloat16><<<R, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), V);
  else
    row_cumsum_kernel<float><<<R, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<float*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
