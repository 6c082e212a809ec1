// Batch-invariant dense product: out[z, m, n] = sum_k x[z, m, k] w[z, k, n]
// (+ bias[n]), rounded to x's type as `x @ w + bias` rounds (the product once,
// then the sum with the bias once).
//
// Replaces no TPU kernel. It was added so that the decode's products give one
// row the same bits whatever the number of rows M beside it: the JAX package
// promises that a (request, seed) decodes to the same tokens in any batch, and
// cuBLAS, which `torch.matmul` calls on the card, picks its kernel, its tile
// and its split of K by the shape, M included. Here every output is summed by
// one warp (bf16) or one thread (f32) over K in one fixed order, in tiles of
// one fixed shape, with no split of K, whatever M is; a row's inputs are the
// only rows it reads. So the row's sum is the same at any M.
//
// What bounds it on the H100: at the decode's M (1-512 rows) bytes, the
// weight matrix read once ([K, N] at 2 or 4 bytes a value; 3.5 MB for the
// fused QKV at D = 768 in bf16), against 2 M K N operations; from M of about
// 300 (bf16) operations. The design streams the weights through a deep
// pipeline so that enough bytes are in flight with few blocks, and uses the
// tensor cores for bf16.
//
// Design:
//   * a block owns a tile of 64 weight columns x 64 input rows and walks all
//     of K in stages of 64 (bf16) or 32 (f32) values, four stages in flight by
//     cp.async (zero-filled past the edges of M, N and K);
//   * bf16: four warps, one 16-column slice of the weights each, on
//     mma.sync.m16n8k16 with f32 accumulation, the weights as the 16-row side
//     (ldmatrix.trans for [K, N] rows, plain ldmatrix for a weight stored as
//     [N, K], as the tied LM head is) and the input rows as the 8-wide side,
//     as the whole-step kernel (decode_block_fused.cu) does: at M = 1 it wastes
//     7/8 of a narrow side, not 15/16 of a wide one. Pieces of 8 rows past M
//     are skipped; the others do not depend on them.
//   * f32: CUDA-core FMAs (no TF32), a thread a 4 x 4 block of outputs summed
//     over k in order.
//   * a batch axis z (grid.z) for the attention's per-head products, with its
//     own strides: the same tile walk for each z.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBN = 64;      // weight columns a block
constexpr int kBM = 64;      // input rows a block
constexpr int kStages = 4;   // stages in flight
constexpr int kPad = 16;     // bytes after each staged row: no bank conflicts

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int M, N, K;
  long long sx, sw, so;  // batch strides, in elements
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with `ok` false the 16 bytes are zeros
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBK = 64, kThreads = 128, kVec = 8;
};
template <>
struct Cfg<float> {
  static constexpr int kBK = 32, kThreads = 256, kVec = 4;
};

// Bytes of one stage's tiles: weights (either layout) and input rows.
template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  constexpr int kk = Cfg<T>::kBK * static_cast<int>(sizeof(T)) + kPad;  // a row of K values
  constexpr int nn = kBN * static_cast<int>(sizeof(T)) + kPad;          // a row of N values
  constexpr int w_kn = Cfg<T>::kBK * nn, w_nk = kBN * kk;
  return w_kn > w_nk ? w_kn : w_nk;
}
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return tile_bytes<T>() + kBM * (Cfg<T>::kBK * static_cast<int>(sizeof(T)) + kPad);
}

// Queue the copies of K stage `kt` into `st`: the weight tile (rows of N
// values for [K, N], rows of K values for [N, K]) and the input rows.
template <typename T, bool TRANS>
__device__ __forceinline__ void load_stage(const T* x, const T* w, int M, int N, int K, int m0,
                                           int n0, int kt, unsigned char* st) {
  constexpr int BK = Cfg<T>::kBK, V = Cfg<T>::kVec, NT = Cfg<T>::kThreads;
  constexpr int E = static_cast<int>(sizeof(T));
  const int k0 = kt * BK;
  unsigned char* ws = st;
  unsigned char* xs = st + tile_bytes<T>();
  if constexpr (TRANS) {  // w is [N, K]: BN rows of BK values
    constexpr int CPR = BK / V;
    for (int c = threadIdx.x; c < kBN * CPR; c += NT) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = n0 + r < N && k0 + cc * V < K;
      cp_async16(ws + r * (BK * E + kPad) + cc * 16,
                 ok ? w + static_cast<size_t>(n0 + r) * K + k0 + cc * V : w, ok);
    }
  } else {  // w is [K, N]: BK rows of BN values
    constexpr int CPR = kBN / V;
    for (int c = threadIdx.x; c < BK * CPR; c += NT) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = k0 + r < K && n0 + cc * V < N;
      cp_async16(ws + r * (kBN * E + kPad) + cc * 16,
                 ok ? w + static_cast<size_t>(k0 + r) * N + n0 + cc * V : w, ok);
    }
  }
  constexpr int CPR = BK / V;
  for (int c = threadIdx.x; c < kBM * CPR; c += NT) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = m0 + r < M && k0 + cc * V < K;
    cp_async16(xs + r * (BK * E + kPad) + cc * 16,
               ok ? x + static_cast<size_t>(m0 + r) * K + k0 + cc * V : x, ok);
  }
}

// ---- bf16: mma.sync, a warp a 16-column slice --------------------------------

template <bool TRANS>
__device__ __forceinline__ void mma_stage(const unsigned char* st, int pieces, float (&c)[8][4]) {
  using T = __nv_bfloat16;
  constexpr int BK = Cfg<T>::kBK;
  constexpr int kRow = BK * 2 + kPad, nRow = kBN * 2 + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mat = lane >> 3, r8 = lane & 7;
  const unsigned char* ws = st;
  const unsigned char* xs = st + tile_bytes<T>();
  // the lane's row address in the weight tile's A fragment (16 columns x 16 k)
  const unsigned char* arow =
      TRANS ? ws + (warp * 16 + ((mat & 1) << 3) + r8) * kRow + ((mat >> 1) << 3) * 2
            : ws + (r8 + ((mat >> 1) << 3)) * nRow + (warp * 16 + ((mat & 1) << 3)) * 2;
  const unsigned char* brow = xs + r8 * kRow + ((mat & 1) << 3) * 2;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    unsigned a0, a1, a2, a3;
    if constexpr (TRANS)
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(arow + kk * 32)));
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(arow + kk * 16 * nRow)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < pieces) {  // warp-uniform: a piece of 8 rows holds a row below M
        unsigned b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
                     : "=r"(b0), "=r"(b1)
                     : "r"(smem_addr(brow + j * 8 * kRow + kk * 32)));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool TRANS>
__global__ void __launch_bounds__(128) matmul_bf16_kernel(const Args a) {
  using T = __nv_bfloat16;
  constexpr int BK = Cfg<T>::kBK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + z * a.sx;
  const T* w = static_cast<const T*>(a.w) + z * a.sw;
  T* out = static_cast<T*>(a.out) + z * a.so;
  const int nk = (a.K + BK - 1) / BK;
  const int pieces = min(8, (a.M - m0 + 7) / 8);
  float c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<T, TRANS>(x, w, a.M, a.N, a.K, m0, n0, s, smem + s * stage_bytes<T>());
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();         // ... and every thread's; stage kt - 1 is free
    mma_stage<TRANS>(smem + (kt % kStages) * stage_bytes<T>(), pieces, c);
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage<T, TRANS>(x, w, a.M, a.N, a.K, m0, n0, next,
                           smem + (next % kStages) * stage_bytes<T>());
    cp_commit();
  }
  cp_wait<0>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* bias = static_cast<const T*>(a.bias);
  const int n = n0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int b = m0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bb = b + (i & 1), nn = n + (i >> 1) * 8;
      if (bb < a.M && nn < a.N) {
        float v = round_bf16(c[j][i]);
        if (bias != nullptr) v = round_bf16(v + __bfloat162float(bias[nn]));
        out[static_cast<size_t>(bb) * a.N + nn] = __float2bfloat16_rn(v);
      }
    }
  }
}

// ---- f32: CUDA-core FMAs, a thread a 4 x 4 block ------------------------------

template <bool TRANS>
__global__ void __launch_bounds__(256) matmul_f32_kernel(const Args a) {
  using T = float;
  constexpr int BK = Cfg<T>::kBK;
  constexpr int kRow = BK + kPad / 4, nRow = kBN + kPad / 4;  // in floats
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + z * a.sx;
  const T* w = static_cast<const T*>(a.w) + z * a.sw;
  T* out = static_cast<T*>(a.out) + z * a.so;
  const int nk = (a.K + BK - 1) / BK;
  const int tn = threadIdx.x % (kBN / 4), tm = threadIdx.x / (kBN / 4);
  // a thread whose four rows all lie past M stages its share of the tiles
  // and waits at the barriers, but sums nothing (a row's sums do not change)
  const bool live = m0 + tm * 4 < a.M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<T, TRANS>(x, w, a.M, a.N, a.K, m0, n0, s, smem + s * stage_bytes<T>());
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const unsigned char* st = smem + (kt % kStages) * stage_bytes<T>();
    const float* ws = reinterpret_cast<const float*>(st);
    const float* xs = reinterpret_cast<const float*>(st + tile_bytes<T>()) + tm * 4 * kRow;
    if (live) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float wv[4];
        if constexpr (TRANS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = ws[(tn * 4 + j) * kRow + k];
        } else {
          const float4 w4 = *reinterpret_cast<const float4*>(ws + k * nRow + tn * 4);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[i * kRow + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage<T, TRANS>(x, w, a.M, a.N, a.K, m0, n0, next,
                           smem + (next % kStages) * stage_bytes<T>());
    cp_commit();
  }
  cp_wait<0>();
  const float* bias = static_cast<const float*>(a.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m0 + tm * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (b < a.M && n < a.N)
        out[static_cast<size_t>(b) * a.N + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.0f);
    }
  }
}

template <typename T, bool TRANS>
int launch(const Args& a, int Z, cudaStream_t stream) {
  void (*kernel)(const Args);
  if constexpr (std::is_same<T, float>::value)
    kernel = matmul_f32_kernel<TRANS>;
  else
    kernel = matmul_bf16_kernel<TRANS>;
  constexpr int smem = kStages * stage_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, Z);
  kernel<<<grid, Cfg<T>::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). x [Z, M, K], out [Z, M, N] (contiguous
// rows; batch strides sx, so in elements), w [Z, K, N] with rows of N values
// (trans = 0) or [Z, N, K] with rows of K values (trans = 1), batch stride
// sw; bias [N] or null; all of one type (dtype 0 = float32, 1 = bfloat16).
// Rows
// of K values (and of N values for trans = 0) are a multiple of 16 bytes and
// every matrix starts on a 16-byte boundary. Returns cudaGetLastError() after
// the launch (0 on success). The caller validates shapes and alignment.
extern "C" int mmtg_matmul(const void* x, const void* w, const void* bias, void* out, int Z,
                           int M, int N, int K, long long sx, long long sw, long long so,
                           int trans, int dtype, void* stream) {
  const Args a{x, w, bias, out, M, N, K, sx, sw, so};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return trans ? launch<__nv_bfloat16, true>(a, Z, s) : launch<__nv_bfloat16, false>(a, Z, s);
  return trans ? launch<float, true>(a, Z, s) : launch<float, false>(a, Z, s);
}
