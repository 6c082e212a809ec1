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
// product. Math in f32 (FMAs, no tensor cores: TF32 would lose the 1e-5
// agreement with the plain version); the output is stored in the input's type.
//
// What bounds it on the H100: neither bytes (W_hh is 3 MB f32 at H = 512, read
// once) nor operations (2 * B * H * 3H FMAs a step, 0.4 GFLOP at B = 64 over
// 5 steps), but latency: 5 dependent steps, each a reduction over H followed
// by an exchange of h. The first port gave one block 8 batch rows, so B = 1
// ran on one SM, and every block streamed all of W_hh from L2 on every step.
//
// Design: a thread-block cluster (Hopper) owns a group of kRows batch rows
// and splits the H hidden columns over its H / 32 blocks (16 at H = 512, a
// non-portable cluster size):
//   * each block keeps its slice of W_hh, the 3 x 32 columns of its hidden
//     columns for all three gates ([H, 96] f32, 192 KB at H = 512), in shared
//     memory for the whole call: W_hh is read from memory once a call;
//   * each block holds the group's full h ([kRows, H], double-buffered); its 8
//     warps split the reduction over k (float4 broadcast reads of h, one
//     conflict-free row of the slice a lane), sum their partials in a fixed
//     order and run the gates for the block's 32 columns;
//   * the new h columns go straight into every peer block's next h buffer
//     (distributed shared memory), then cluster.sync(): h never leaves the
//     chip, and one launch runs all T steps;
//   * the clusters are as many as fit on the card at once (one block an SM)
//     and walk the row groups, each loading its slices once.
// Why a cluster and not a cooperative grid: the exchange is between 16 blocks
// of one row group, not the whole grid; cluster.sync() costs a fraction of a
// grid barrier and distributed shared memory keeps h out of L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 32;       // hidden columns a block owns: one a lane
constexpr int kSlice = 3 * kCols;  // its W_hh columns: r, z, n
constexpr int kRows = 4;        // batch rows a cluster steps together
constexpr int kWarps = 8;       // split the reduction over k
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 16;  // the largest cluster Hopper allows

template <typename O>
__device__ __forceinline__ O store_as(float x);
template <>
__device__ __forceinline__ float store_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// dynamic shared memory: W slice [H, 96] | h [2, kRows, H] | partials [kWarps, kRows, 96]
__host__ __device__ constexpr size_t smem_floats(int H) {
  return static_cast<size_t>(H) * kSlice + 2 * kRows * static_cast<size_t>(H) +
         kWarps * kRows * kSlice;
}

template <typename O>
__global__ void __launch_bounds__(kThreads, 1)
fused_gru_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                 const float* __restrict__ b_hh, O* __restrict__ out, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* Ws = reinterpret_cast<float*>(smem4);  // Ws[k * 96 + g * 32 + c] = W_hh[k, g*H + col0 + c]
  float* hbuf = Ws + static_cast<size_t>(H) * kSlice;  // [2][kRows][H]
  float* red = hbuf + 2 * kRows * H;                   // [kWarps][kRows][96]

  const int nb = static_cast<int>(cluster.num_blocks());
  const int col0 = static_cast<int>(cluster.block_rank()) * kCols;
  const int n_clusters = gridDim.x / nb;
  const int cid = blockIdx.x / nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H3 = 3 * H;

  // this block's slice of W_hh, once for the whole call
  for (int i = tid; i < H * (kSlice / 4); i += kThreads) {
    const int k = i / (kSlice / 4), q = i % (kSlice / 4);
    const int g = q / (kCols / 4), c = (q % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(Ws + k * kSlice + g * kCols + c) =
        *reinterpret_cast<const float4*>(w_hh + static_cast<size_t>(k) * H3 + g * H + col0 + c);
  }
  // every block of the cluster is running before any writes a peer's memory
  cluster.sync();
  // gate threads: tid < kRows * 32, row gr of the group, hidden column col0 + lane
  const int gr = warp;
  const bool gate = tid < kRows * 32;
  const float br = b_hh[col0 + lane], bz = b_hh[H + col0 + lane], bn = b_hh[2 * H + col0 + lane];
  const int kw = H / kWarps;  // a multiple of 4
  const int k0 = warp * kw;

  for (int g0 = cid * kRows; g0 < B; g0 += n_clusters * kRows) {
    // h_0 = 0. No peer writes buffer 0 before this group's first step ends
    // (the writes of the previous group ended at its last cluster.sync()).
    for (int i = tid; i < kRows * H; i += kThreads) hbuf[i] = 0.0f;
    __syncthreads();
    int p = 0;
    for (int t = 0; t < T; ++t) {
      const float* hc = hbuf + p * kRows * H;
      const int b = g0 + gr;
      const bool live = gate && b < B;
      float xr = 0.0f, xz = 0.0f, xn = 0.0f;
      if (live) {  // issued before the reduction, used after it
        const float* x = xp + (static_cast<size_t>(t) * B + b) * H3 + col0 + lane;
        xr = x[0];
        xz = x[H];
        xn = x[2 * H];
      }
      float acc[kRows][3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
      for (int k = k0; k < k0 + kw; k += 4) {
        float4 hv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hc + r * H + k);  // one address a warp
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* w = Ws + (k + kk) * kSlice + lane;
          const float wr = w[0], wz = w[kCols], wn = w[2 * kCols];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hk = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
            acc[r][0] = fmaf(hk, wr, acc[r][0]);
            acc[r][1] = fmaf(hk, wz, acc[r][1]);
            acc[r][2] = fmaf(hk, wn, acc[r][2]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g) red[(warp * kRows + r) * kSlice + g * kCols + lane] = acc[r][g];
      __syncthreads();
      if (gate) {
        float sr = 0.0f, sz = 0.0f, sn = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {  // a fixed order: reproducible
          const float* s = red + (w * kRows + gr) * kSlice + lane;
          sr += s[0];
          sz += s[kCols];
          sn += s[2 * kCols];
        }
        float hn = 0.0f;
        if (live) {
          const float rg = sigmoid(xr + (sr + br));
          const float zg = sigmoid(xz + (sz + bz));
          const float ng = tanhf(xn + rg * (sn + bn));
          hn = (1.0f - zg) * ng + zg * hc[gr * H + col0 + lane];
          out[(static_cast<size_t>(t) * B + b) * H + col0 + lane] = store_as<O>(hn);
        }
        // the new columns into every block's next h, this block's included
        float* dst = hbuf + (p ^ 1) * kRows * H + gr * H + col0 + lane;
        for (int q = 0; q < nb; ++q) *cluster.map_shared_rank(dst, q) = hn;
      }
      // every peer's columns have arrived, and no one reads this step's h or
      // partials any more
      cluster.sync();
      p ^= 1;
    }
  }
}

template <typename O>
int launch(const void* xp, const void* w_hh, const void* b_hh, void* out, int T, int B, int H,
           cudaStream_t stream) {
  if (H <= 0 || H % kCols || H / kCols > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = H / kCols;
  const size_t smem = smem_floats(H) * sizeof(float);
  auto kernel = fused_gru_kernel<O>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int max_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_clusters < 1) return -1;  // the card cannot place one such cluster
  const int groups = (B + kRows - 1) / kRows;
  const int n_clusters = groups < max_clusters ? groups : max_clusters;
  cfg.gridDim = dim3(nb * n_clusters, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(xp),
                           static_cast<const float*>(w_hh), static_cast<const float*>(b_hh),
                           static_cast<O*>(out), T, B, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). xp [T, B, 3H] f32 (x @ W_ih + b_ih);
// w_hh [H, 3H] f32; b_hh [3H] f32; out [T, B, H], float32 (out_dtype 0) or
// bfloat16 (out_dtype 1). H is a multiple of 32, at most 512; all pointers are
// 16-byte aligned. Returns the CUDA error code of the launch (0 on success),
// or -1 when the card cannot place a cluster of H / 32 blocks with this
// shared memory. The caller validates shapes.
extern "C" int mmtg_fused_gru(const void* xp, const void* w_hh, const void* b_hh, void* out,
                              int T, int B, int H, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch<__nv_bfloat16>(xp, w_hh, b_hh, out, T, B, H, s);
  return launch<float>(xp, w_hh, b_hh, out, T, B, H, s);
}
