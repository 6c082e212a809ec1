// Fused single-layer GRU recurrence over the 5-step experience sequence.
//
// Replaces the TPU kernel mmtg_tpu/ops/fused_gru.py (_kernel, launched by
// fused_gru): the input projection x @ W_ih + b_ih is computed outside
// (torch.matmul, as the TPU version left it to XLA) and arrives here as xp;
// this kernel runs the recurrence
//     hp = h @ W_hh + b_hh
//     r = sigmoid(xr + hr); z = sigmoid(xz + hz); n = tanh(xn + r * hn)
//     h' = (1 - z) * n + z * h
// in torch gate order [r, z, n] with the hidden bias inside the reset
// product. Math in f32; the output is stored in the input's type.
//
// What bounds it on the H100: bytes. Each step re-reads W_hh ([H, 3H] f32,
// 3 MB at H = 512) once per block, from L2 after the first block; the FLOPs
// (2 * BB * H * 3H per block and step) are small.
//
// Design: GRU rows are independent across the batch, so one block owns
// kRows batch rows for all T steps and needs no cross-block
// synchronisation. h lives in shared memory (two [kRows, H] f32 buffers,
// current and next); each thread owns hidden columns j and keeps the three
// gate sums of its kRows rows in registers while it walks k over H (a plain
// dot, no tensor cores, no cuBLAS). Known limit, left to later work: at
// B = 64 only 8 blocks run, each streaming 3 MB of W_hh per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // batch rows per block

template <typename O>
__device__ __forceinline__ O store_as(float x);
template <>
__device__ __forceinline__ float store_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename O>
__global__ void fused_gru_kernel(const float* __restrict__ xp,
                                 const float* __restrict__ w_hh,
                                 const float* __restrict__ b_hh,
                                 O* __restrict__ out, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_cur = smem;             // [kRows, H]
  float* h_nxt = smem + kRows * H;  // [kRows, H]
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int H3 = 3 * H;

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) h_cur[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float ar[kRows], az[kRows], an[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ar[r] = az[r] = an[r] = 0.0f;
      for (int k = 0; k < H; ++k) {
        const float* wk = w_hh + static_cast<size_t>(k) * H3;
        const float wr = wk[j], wz = wk[H + j], wn = wk[2 * H + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h_cur[r * H + k];  // broadcast read
          ar[r] = fmaf(hk, wr, ar[r]);
          az[r] = fmaf(hk, wz, az[r]);
          an[r] = fmaf(hk, wn, an[r]);
        }
      }
      const float br = b_hh[j], bz = b_hh[H + j], bn = b_hh[2 * H + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const size_t row = static_cast<size_t>(t) * B + b0 + r;
          const float* x = xp + row * H3;
          const float rg = sigmoid(x[j] + (ar[r] + br));
          const float zg = sigmoid(x[H + j] + (az[r] + bz));
          const float ng = tanhf(x[2 * H + j] + rg * (an[r] + bn));
          const float hn = (1.0f - zg) * ng + zg * h_cur[r * H + j];
          h_nxt[r * H + j] = hn;
          out[row * H + j] = store_as<O>(hn);
        } else {
          h_nxt[r * H + j] = 0.0f;
        }
      }
    }
    // every thread is done reading h_cur before the buffers swap
    __syncthreads();
    float* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

template <typename O>
int launch(const void* xp, const void* w_hh, const void* b_hh, void* out,
           int T, int B, int H, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kRows) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gru_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = H < 512 ? ((H + 31) / 32) * 32 : 512;
  const int blocks = (B + kRows - 1) / kRows;
  fused_gru_kernel<O><<<blocks, threads, smem, stream>>>(
      static_cast<const float*>(xp), static_cast<const float*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<O*>(out), T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). xp [T, B, 3H] f32 (x @ W_ih + b_ih);
// w_hh [H, 3H] f32; b_hh [3H] f32; out [T, B, H], float32 (out_dtype 0) or
// bfloat16 (out_dtype 1). Returns the CUDA error code of the launch (0 on
// success). The caller validates shapes.
extern "C" int mmtg_fused_gru(const void* xp, const void* w_hh,
                              const void* b_hh, void* out, int T, int B, int H,
                              int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch<__nv_bfloat16>(xp, w_hh, b_hh, out, T, B, H, s);
  return launch<float>(xp, w_hh, b_hh, out, T, B, H, s);
}
