// Whole-step decode kernel: ALL transformer layers of one decode step in one
// launch.
//
// Replaces the TPU kernel mmtg_tpu/ops/decode_megakernel.py (_megakernel,
// called through decode_block_fused). Per layer it computes, for every batch
// row: LN1 -> QKV product + bias -> q scaled by 1/sqrt(hd) -> int8
// quantize-append of the k/v rows (gpt2.quantize_rows) -> attention over the
// live cache prefix -> output projection + residual -> LN2 -> MLP with
// gelu_new -> residual. Products accumulate in f32 and round back to the
// stream type T; LayerNorm statistics are f32; every elementwise step rounds
// to T where the per-layer PyTorch step (models/gpt2.gpt2_decode_step) does,
// so in bf16 the two paths differ by summation order only. It returns the
// hidden state before the final LayerNorm and updates the int8 caches and
// their scales in place.
//
// What bounds it on the H100: bytes. A step reads the layers' weights once
// (7.08 M values a layer) and the live prefix of both caches of every layer;
// the products are 2 FLOPs per weight and batch row.
//
// Design (simple and right first). Every operation of the step is independent
// between batch rows, so a block owns one row, keeps its residual stream and
// every intermediate in shared memory as f32, and walks the layers alone: no
// block waits for another, and the launch is an ordinary one. The TPU kernel's
// grid=(L, B/block_b) with a persistent VMEM scratch becomes the loop over
// layers inside the block.
//   * products: a thread owns 16 bytes of output columns (8 bf16 / 4 f32) and
//     walks K with 8 independent 16-byte weight loads in flight; where N is
//     narrow the K range is split over thread groups and summed through shared
//     memory in a fixed order (the result does not vary from run to run).
//   * the append and the attention are the device functions of
//     decode_attention.cuh, the ones the per-layer kernel runs: one warp a
//     head; the appended row is visible to the block's attention
//     through the __syncthreads() that ends append_row.
//   * weights do not fit in shared memory (14.2 MB a layer in bf16): every
//     block streams them from L2 / HBM, so B blocks read each layer B times,
//     mostly from L2. That is the known cost of this design; sharing one pass
//     over the weights between rows or blocks (several rows a block, clusters,
//     or a grid-wide barrier) is later work.
// Limits of this kernel: int8 split cache; weights of the stream type; D a
// multiple of 8 (16-byte weight loads); head_dim <= 128; shared memory
// 9 D + max(4 D, 3072) floats <= 227 KB.

#include "decode_attention.cuh"

namespace {

using namespace mmtg;

constexpr int kThreads = 384;  // 12 warps: one a head at the model's 12 heads
constexpr int kUnroll = 8;     // weight loads in flight per thread

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float (&w)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&w)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of its f32
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// epi(n, sum_k x[k] * W[k, n]) for the block's row. x: [K] floats in shared
// memory; W: [K, N] in global memory, N a multiple of the vector width;
// scratch: max(kThreads * Vec::n, N) floats of shared memory. Called by every
// thread; ends with a __syncthreads().
template <typename T, typename Epi>
__device__ __forceinline__ void matvec(const float* x, const T* __restrict__ W, int K,
                                       int N, float* scratch, Epi epi) {
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  const int G = N / V;  // column groups
  int S = G >= kThreads ? 1 : kThreads / G;  // K splits
  if (S > K) S = K;
  const int ks = (K + S - 1) / S;
  for (int w = tid; w < G * S; w += kThreads) {
    const int g = w % G, s = w / G;
    const int k0 = s * ks, k1 = min(K, k0 + ks);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    const T* wp = W + static_cast<size_t>(g) * V;
    int k = k0;
    for (; k + kUnroll <= k1; k += kUnroll) {
      float wf[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T>::load(wp + static_cast<size_t>(k + u) * N, wf[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float xk = x[k + u];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(xk, wf[u][j], acc[j]);
      }
    }
    for (; k < k1; ++k) {
      float wf[V];
      Vec<T>::load(wp + static_cast<size_t>(k) * N, wf);
      const float xk = x[k];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(xk, wf[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) scratch[s * N + g * V + j] = acc[j];
  }
  __syncthreads();
  for (int n = tid; n < N; n += kThreads) {
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += scratch[s * N + n];
    epi(n, sum);
  }
  __syncthreads();
}

// LayerNorm with the port's numerics (models/gpt2.layer_norm): f32 statistics,
// elementwise math rounded to T. The first warp does the row; the caller
// synchronizes.
template <typename T>
__device__ __forceinline__ void layer_norm_row(const float* x, float* out, const T* g,
                                               const T* b, int D, float eps) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float sum = 0.0f;
  for (int d = lane; d < D; d += 32) sum += x[d];
  const float mean = round_to<T>(warp_sum(sum) / static_cast<float>(D));
  float sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float xm = round_to<T>(x[d] - mean);
    sq += round_to<T>(xm * xm);
  }
  const float var = warp_sum(sq) / static_cast<float>(D);
  const float rstd = round_to<T>(rsqrtf(var + eps));
  for (int d = lane; d < D; d += 32) {
    const float xm = round_to<T>(x[d] - mean);
    out[d] = round_to<T>(round_to<T>(round_to<T>(xm * rstd) * to_f(g[d])) + to_f(b[d]));
  }
}

// gelu_new as models/gpt2.gelu_new computes it in type T, op by op
template <typename T>
__device__ __forceinline__ float gelu_new(float x) {
  const float x3 = round_to<T>(x * x * x);
  const float inner = round_to<T>(x + round_to<T>(0.044715f * x3));
  const float t = round_to<T>(tanhf(round_to<T>(0.7978845608028654f * inner)));
  return round_to<T>(round_to<T>(0.5f * x) * round_to<T>(1.0f + t));
}

template <typename T>
struct Params {
  const T *ln1_g, *ln1_b, *attn_w, *attn_b, *proj_w, *proj_b;
  const T *ln2_g, *ln2_b, *fc_w, *fc_b, *mproj_w, *mproj_b;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_block_fused_kernel(
    const T* __restrict__ h_in, Params<T> p, int8_t* k_cache, int8_t* v_cache,
    float* k_scale, float* v_scale, const int32_t* __restrict__ key_mask,
    T* __restrict__ h_out, int L, int B, int T_cap, int D, int n_head,
    int position, float eps, float q_scale) {
  extern __shared__ float smem[];
  float* h = smem;             // [D]  residual stream
  float* a = h + D;            // [D]  LN output, then ctx
  float* qkv = a + D;          // [3D]
  float* mlp = qkv + 3 * D;    // [4D]
  float* scratch = mlp + 4 * D;  // max(kThreads * Vec<T>::n, 4 D)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int hd = D / n_head;

  for (int i = tid; i < D; i += kThreads)
    h[i] = to_f(h_in[static_cast<size_t>(b) * D + i]);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const size_t lD = static_cast<size_t>(l) * D;
    // ---- LN1 -> qkv (+ bias; q scaled and rounded as the attention wants) --
    layer_norm_row<T>(h, a, p.ln1_g + lD, p.ln1_b + lD, D, eps);
    __syncthreads();
    {
      const T* bias = p.attn_b + 3 * lD;
      matvec<T>(a, p.attn_w + lD * 3 * D, D, 3 * D, scratch, [&](int n, float sum) {
        float v = round_to<T>(round_to<T>(sum) + to_f(bias[n]));
        if (n < D) v = round_to<T>(v * q_scale);
        qkv[n] = v;
      });
    }
    // ---- int8 quantize-append, then attention over the live prefix ---------
    const size_t row0 = (static_cast<size_t>(l) * B + b) * T_cap;
    const size_t slot = (row0 + position) * D;
    append_row<T, kInt8>(qkv + D, qkv + 2 * D, k_cache + slot, v_cache + slot,
                         k_scale + row0 + position, v_scale + row0 + position, D);
    for (int head = warp; head < n_head; head += kThreads / 32) {
      const int hoff = head * hd;
      float qv[kMaxLaneElems], out[kMaxLaneElems];
#pragma unroll
      for (int i = 0; i < kMaxLaneElems; ++i) {
        const int d = lane + 32 * i;
        qv[i] = d < hd ? qkv[hoff + d] : 0.0f;
      }
      attend_head<int8_t, kInt8>(
          qv, k_cache + row0 * D, v_cache + row0 * D, static_cast<size_t>(D),
          k_scale + row0, v_scale + row0,
          key_mask + static_cast<size_t>(b) * T_cap, position, D, hd, hoff, lane, out);
#pragma unroll
      for (int i = 0; i < kMaxLaneElems; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) a[hoff + d] = round_to<T>(out[i]);
      }
    }
    __syncthreads();
    // ---- output projection + residual --------------------------------------
    {
      const T* bias = p.proj_b + lD;
      matvec<T>(a, p.proj_w + lD * D, D, D, scratch, [&](int n, float sum) {
        h[n] = round_to<T>(round_to<T>(h[n] + round_to<T>(sum)) + to_f(bias[n]));
      });
    }
    // ---- LN2 -> MLP with gelu_new -> residual ------------------------------
    layer_norm_row<T>(h, a, p.ln2_g + lD, p.ln2_b + lD, D, eps);
    __syncthreads();
    {
      const T* bias = p.fc_b + 4 * lD;
      matvec<T>(a, p.fc_w + lD * 4 * D, D, 4 * D, scratch, [&](int n, float sum) {
        mlp[n] = gelu_new<T>(round_to<T>(round_to<T>(sum) + to_f(bias[n])));
      });
    }
    {
      const T* bias = p.mproj_b + lD;
      matvec<T>(mlp, p.mproj_w + lD * 4 * D, 4 * D, D, scratch, [&](int n, float sum) {
        h[n] = round_to<T>(round_to<T>(h[n] + round_to<T>(sum)) + to_f(bias[n]));
      });
    }
  }
  for (int i = tid; i < D; i += kThreads)
    h_out[static_cast<size_t>(b) * D + i] = from_f<T>(h[i]);
}

struct Args {
  const void* h_in;
  const void* params[12];
  void *k_cache, *v_cache, *k_scale, *v_scale;
  const void* key_mask;
  void* h_out;
  int L, B, T_cap, D, n_head, position;
  float eps, q_scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr int V = Vec<T>::n;
  const int scratch = kThreads * V > 4 * a.D ? kThreads * V : 4 * a.D;
  const size_t smem = sizeof(float) * (static_cast<size_t>(9) * a.D + scratch);
  auto kernel = decode_block_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Params<T> p;
  const T** fields[12] = {&p.ln1_g, &p.ln1_b, &p.attn_w, &p.attn_b, &p.proj_w, &p.proj_b,
                          &p.ln2_g, &p.ln2_b, &p.fc_w,   &p.fc_b,   &p.mproj_w, &p.mproj_b};
  for (int i = 0; i < 12; ++i) *fields[i] = static_cast<const T*>(a.params[i]);
  kernel<<<a.B, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.h_in), p, static_cast<int8_t*>(a.k_cache),
      static_cast<int8_t*>(a.v_cache), static_cast<float*>(a.k_scale),
      static_cast<float*>(a.v_scale), static_cast<const int32_t*>(a.key_mask),
      static_cast<T*>(a.h_out), a.L, a.B, a.T_cap, a.D, a.n_head, a.position, a.eps,
      a.q_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). h_in / h_out [B, D]; `params`: 12
// pointers in the order ln1_g, ln1_b, attn_w [L, D, 3D], attn_b, attn_proj_w
// [L, D, D], attn_proj_b, ln2_g, ln2_b, mlp_fc_w [L, D, 4D], mlp_fc_b,
// mlp_proj_w [L, 4D, D], mlp_proj_b, all of h's type; caches [L, B, T_cap, D]
// int8; scales [L, B, T_cap] f32; key_mask [B, T_cap] int32. dtype: 0 =
// float32, 1 = bfloat16. Returns the CUDA error of the set-up or the launch (0 on success).
// The caller validates shapes and bounds.
extern "C" int mmtg_decode_block_fused(
    const void* h_in, const void* const* params, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* key_mask, void* h_out, int L, int B,
    int T_cap, int D, int n_head, int position, float eps, float q_scale, int dtype,
    void* stream) {
  Args a{};
  a.h_in = h_in;
  for (int i = 0; i < 12; ++i) a.params[i] = params[i];
  a.k_cache = k_cache; a.v_cache = v_cache; a.k_scale = k_scale; a.v_scale = v_scale;
  a.key_mask = key_mask; a.h_out = h_out;
  a.L = L; a.B = B; a.T_cap = T_cap; a.D = D; a.n_head = n_head; a.position = position;
  a.eps = eps; a.q_scale = q_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(a) : launch<float>(a);
  return static_cast<int>(err);
}
