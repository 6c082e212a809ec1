// Batch-invariant inclusive prefix sum along each row: out[r, i] = sum_{j <= i}
// x[r, j], summed in f32 and rounded to x's type once an entry, as
// torch.cumsum computes it.
//
// Replaces no TPU kernel. It was added for the sampler's nucleus (top-p)
// filter, the cumulative probability of the sorted candidates
// (ops/sampling._nucleus_mask_sorted): on the card torch.cumsum lays a row's
// scan out by the number of rows, so one row's sums, and with them where its
// nucleus ends, changed with the batch. Here a row's scan has one shape, set
// by the row's length V alone (the launch picks the kernel by V; ops/cumsum.path
// states the same rule).
//
// What bounds it on the H100: bytes (each value read and written once; one
// add an element) and, for the decode's few short rows, latency.
//
// Design, two kernels chosen by V alone:
//   * short rows (V <= 32; the sampler's top-k 10): a thread a row, 64 rows a
//     block; a thread loads its row into registers (all loads at once), sums
//     it in order, as the plain version does, and writes each prefix sum. The
//     result is the plain version's, bit for bit.
//   * long rows (top-p over the vocabulary, 13317): a block of 256 threads a
//     row, in tiles of 4096 values. Each thread sums its 16 neighbouring
//     values in order; the thread totals are scanned by a fixed tree (shuffles
//     within a warp, the 8 warp totals in order), added to the carry of the
//     tiles before, and each thread writes its 16 prefix sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kShortV = 32;     // the short path's V at most
constexpr int kShortRows = 64;   // rows (threads) a block on the short path
constexpr int kThreads = 256;   // the long path's block
constexpr int kPer = 16;        // values a thread sums in order (long path)
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
__global__ void __launch_bounds__(kShortRows) row_cumsum_short_kernel(const T* __restrict__ x,
                                                                      T* __restrict__ out, int R,
                                                                      int V) {
  const int r = blockIdx.x * kShortRows + threadIdx.x;
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * V;
  T* yr = out + static_cast<size_t>(r) * V;
  float v[kShortV];
#pragma unroll
  for (int j = 0; j < kShortV; ++j)  // every load first: one round trip
    if (j < V) v[j] = to_f(xr[j]);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kShortV; ++j) {
    if (j < V) {
      s += v[j];
      yr[j] = from_f<T>(s);
    }
  }
}

// a word of padding after every 32: a thread's 16 neighbours hit 16 banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <typename T>
__global__ void __launch_bounds__(kThreads) row_cumsum_long_kernel(const T* __restrict__ x,
                                                                   T* __restrict__ out, int V) {
  __shared__ float vals[kTile + kTile / 32];
  __shared__ float warp_sum[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * V;
  T* yr = out + static_cast<size_t>(blockIdx.x) * V;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float carry = 0.0f;  // the tiles before (every thread holds it)
  for (int t0 = 0; t0 < V; t0 += kTile) {
    const int n = min(kTile, V - t0);
    for (int i = t; i < kTile; i += kThreads) vals[padded(i)] = i < n ? to_f(xr[t0 + i]) : 0.0f;
    __syncthreads();
    float run[kPer];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s += vals[padded(t * kPer + j)];
      run[j] = s;
    }
    // the thread totals: an inclusive scan of fixed shape within the warp
    float inc = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    const float up = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    float before = 0.0f, tile = 0.0f;  // the warps before this one, all warps: in order
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) {
      if (q == warp) before = tile;
      tile += warp_sum[q];
    }
    const float base = carry + (before + (lane ? up : 0.0f));
#pragma unroll
    for (int j = 0; j < kPer; ++j) vals[padded(t * kPer + j)] = base + run[j];
    carry += tile;
    __syncthreads();
    for (int i = t; i < n; i += kThreads) yr[t0 + i] = from_f<T>(vals[padded(i)]);
    __syncthreads();  // vals and warp_sum are used again
  }
}

template <typename T>
int launch(const void* x, void* out, int R, int V, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(out);
  if (V <= kShortV)
    row_cumsum_short_kernel<T><<<(R + kShortRows - 1) / kShortRows, kShortRows, 0, s>>>(xt, yt, R,
                                                                                         V);
  else
    row_cumsum_long_kernel<T><<<R, kThreads, 0, s>>>(xt, yt, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). x, out [R, V] contiguous, of one type
// (dtype 0 = float32, 1 = bfloat16); V <= kShortV a thread a row, else a block
// a row. Returns cudaGetLastError() after the launch (0 on success). The
// caller validates shapes.
extern "C" int mmtg_row_cumsum(const void* x, void* out, int R, int V, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, R, V, s);
  return launch<float>(x, out, R, V, s);
}
