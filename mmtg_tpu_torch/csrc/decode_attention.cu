// Single-query decode attention over the KV cache, with or without the fused
// append of the step's k/v row.
//
// Replaces the TPU kernel mmtg_tpu/ops/decode_attention_unified.py
// (_unified_kernel, built by build_call) as called through every wrapper of
// mmtg_tpu/ops/decode_attention.py. As there, the cache kind, the append stage
// and the merged layout are options of ONE kernel:
//   decode_attention / _int8 / _int4           CACHE = fp/int8/int4, no append
//   decode_attention_fp_append                  fp,   append
//   decode_attention_int8_append                int8, append
//   decode_attention_int4_append                int4, append
//   decode_attention_int8_append_merged         int8, append, k||v in one
//                                               [L, B, T, 2D] buffer: a row
//                                               stride of 2D, v at +D
//
// What it computes, for one layer `layer` of a [L, B, T, row] cache (heads
// merged into D = H * hd):
//   1. append (when on): the step's k/v rows go into slot `position`,
//      quantized as the cache kind says (decode_attention.cuh), scales written.
//   2. attend: q (pre-scaled by 1/sqrt(hd) and rounded back to its own type,
//      as the TPU wrapper does) against slots t <= position with
//      key_mask[b, t] != 0. Scores, running max, sum and accumulator are f32
//      (online softmax); ctx is stored in q's type.
//
// What bounds it on the H100: bytes. Each call streams the live cache prefix
// of one layer, (position + 1) * D bytes of k and as many of v per row for
// int8, half that for int4 and 2x / 4x for bf16 / f32, and does 2 FLOPs per
// byte or less.
//
// Why the design before this one sat at 24% of that bound at B = 4096: it gave
// a block of 128 threads one (batch row, head), 49,152 blocks a launch, each
// streaming only (position + 1) * 64 bytes of k and of v (one or two rounds of
// loads). Around those loads every block paid a cost that did not shrink with
// its bytes, once per head: it recomputed and staged the codes of the whole
// row's append (D lanes, two barriers), read the row's mask word before each
// slot it loaded and the scales again, and merged its 32 groups through shared
// memory in a serial 32-deep loop. Most of a block's life had no load in
// flight.
//
// Design:
//   * a block owns a few heads (int4 head pairs) of one batch row and one
//     chunk of its slots, a few warps each head, as kShapes sets them for the
//     cache kind (never for the batch size): a grid of (head blocks, chunks,
//     B). Chunks hold 256 slots,
//     their number a function of `position` alone
//     (ops/decode_attention.split_slots); up to position 255 (the default
//     220-token call) that is one chunk. With more, each head's partial
//     (max, sum, accumulator) goes to scratch that the wrapper allocates, and
//     the block of the (row, head block) that finishes last (an atomic count,
//     reset by that block for the next call) merges them in chunk order.
//   * a lane loads 16 bytes of a slot's head row, neighbouring lanes the
//     neighbouring bytes: a group of G = hd * size / 16 lanes covers the row
//     (4 lanes for int8 at hd = 64, 8 for bf16), and each group keeps its own
//     online softmax. The head's warps * 32 / G groups take its slots in turn
//     (attend_range), kUnroll slots of k and v in flight a lane. The shape is a
//     trade: more warps a head finish a lone row in fewer rounds of loads
//     (B = 1), fewer warps a row pay less fixed work a warp (query, merges,
//     an unhidden first round) at B = 4096; each kind takes the shape that
//     timed best across both on an H100.
//   * the chunk's mask words and scales are read into shared memory once a
//     block (not once a head), so a round of the sweep waits on one load, not
//     on a mask word and then the slot it guards.
//   * the append: the row's scales are an abs-max over all of k_new / v_new, so
//     every block of the row whose chunk holds slot `position` computes them,
//     but only the codes of its own heads (stage_quantized), and writes those
//     codes (one writer a byte; head block 0 writes the scales; the odd-H int4
//     path, whose heads straddle bytes, stages the whole row and lets head
//     block 0 write it). No block reads slot `position` from the cache, so
//     nothing races; every kind takes slot `position` at the same point of its
//     sweep (after the chunk's other slots), so after an append the read-only
//     kernel gives the same ctx bit for bit.
//   * a head's groups merge inside each warp by shuffles in a fixed tree
//     (merge_warp), then its warps' states in warp order through shared memory
//     (merge_groups): a loop as deep as the warps a head, not 32 deep.
//   * int4: heads h and h + H/2 share their bytes (byte j holds lane j low and
//     lane j + D/2 high), so for even H (and 16 | hd) a unit is the head pair
//     and each 16-byte load gives the 32 codes of both heads. Odd H, where D/2
//     falls inside a head, takes a plain path: a unit a head, a lane reading
//     single bytes and picking its nibble.
// How slots split among a head's groups and into chunks is a function of the
// position, the cache kind, the dtype and the head width alone, never of B or
// of the other heads: a row's context has the same bits at any batch size, and
// a head the same bits in a tensor-parallel shard (fp cache; a quantized
// row's scale spans the shard's heads).

#include "decode_attention.cuh"


namespace {

using namespace mmtg;

// The block of each cache kind (fp, int8, int4 odd-H, int4 head pairs):
// units (heads; head pairs) of one batch row, warps a unit, and the launch
// bound's blocks an SM, which leaves a thread 65536 / (threads * blocks)
// registers.
constexpr int kShapes[4][3] = {{1, 4, 8}, {2, 2, 4}, {2, 2, 4}, {1, 4, 4}};

template <int KIND, bool PAIR>
struct Shape {
  static constexpr int kRow = KIND == kInt4 ? 2 + PAIR : KIND;
  static constexpr int kUnits = kShapes[kRow][0], kWarps = kShapes[kRow][1];
  static constexpr int kMinBlocks = kShapes[kRow][2], kThreads = 32 * kUnits * kWarps;
};

// Head `hh` of unit `u` (a head, or for a pair u and u + n_head/2).
template <bool PAIR>
__device__ __forceinline__ int head_of(int u, int hh, int n_head) {
  return PAIR ? u + hh * (n_head / 2) : u;
}

struct Args {
  const void *q, *k_new, *v_new;
  void *k_cache, *v_cache;
  float *k_scale, *v_scale;
  const int32_t* key_mask;
  void* ctx;
  float* scratch;
  int* counters;
  int B, T_cap, D, n_head, position, layer;
  float q_scale;
  int row_stride, chunk;
  int G;  // lanes a head row takes (group_lanes), set by launch
};

// One block: head block blockIdx.x (units kUnits * x ..), slot chunk
// blockIdx.y, batch row blockIdx.z.
template <typename T, int KIND, bool APPEND, bool PAIR, typename S = Shape<KIND, PAIR>>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
decode_attention_kernel(const __grid_constant__ Args a) {
  using K = Kind<T, KIND, PAIR>;
  using C = typename K::C;
  constexpr int NH = K::NH, EPL = K::EPL, NW = S::kWarps, NT = 32 * NW;
  extern __shared__ float4 smem4[];
  __shared__ float red[2 * 32];
  __shared__ int is_last;

  const int ub = blockIdx.x, s_idx = blockIdx.y, b = blockIdx.z;
  const int n_ub = gridDim.x, n_split = gridDim.y;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  // the block's units, and this thread's: unit ul of the block, warp wi of it
  const int D = a.D, n_head = a.n_head, hd = D / n_head, n_units = n_head / NH;
  const int u0 = ub * S::kUnits, nu = min(S::kUnits, n_units - u0);
  const int ul = tid / NT, utid = tid % NT, wi = utid >> 5, u = u0 + ul;
  const bool active = ul < nu;  // the last head block may hold fewer units
  const int G = a.G, n_groups = NW * (32 / G), grp = wi * (32 / G) + lane / G, lg = lane % G;
  const int position = a.position, chunk = a.chunk;
  const int W = position + 1;
  const int lo = s_idx * chunk, hi = min(lo + chunk, W);
  const bool has_pos = hi == W;  // this chunk holds slot `position`
  const int end = min(hi, position);  // the chunk's slots before `position`
  const size_t rs = static_cast<size_t>(a.row_stride);
  const int P = NH * (2 + hd);  // one unit's state: m[NH], l[NH], acc[NH][hd]

  // shared memory: the staged codes (append, quantized kinds), the chunk's
  // mask words and k / v scales, then each unit's kWarps warp states
  const int row_w = KIND == kInt4 ? D / 2 : D;
  const int stage_b = (row_w + 15) & ~15;
  int8_t* stage_k = reinterpret_cast<int8_t*>(smem4);
  int8_t* stage_v = stage_k + stage_b;
  int32_t* smask = reinterpret_cast<int32_t*>(stage_k + (APPEND && KIND != kFp ? 2 * stage_b : 0));
  float* sks = reinterpret_cast<float*>(smask + chunk);
  float* svs = sks + chunk;
  float* gm = svs + chunk + ul * NW * P;  // m[NH][NW], l[NH][NW], acc[NH][NW][hd]
  float* gl = gm + NH * NW;
  float* gacc = gl + NH * NW;

  const size_t row0 = (static_cast<size_t>(a.layer) * a.B + b) * a.T_cap;
  C* k_rows = static_cast<C*>(a.k_cache) + row0 * rs;
  C* v_rows = static_cast<C*>(a.v_cache) + row0 * rs;
  const int32_t* mask_row = a.key_mask + static_cast<size_t>(b) * a.T_cap;
  const auto sync = [] { __syncthreads(); };

  // the unit's query, loaded first: its wait hides under the block's set-up
  T q_raw[NH][EPL];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = lg * EPL + i;
      const size_t at = static_cast<size_t>(b) * D + head_of<PAIR>(u, h, n_head) * hd + e;
      q_raw[h][i] = active && e < hd ? static_cast<const T*>(a.q)[at] : from_f<T>(0.0f);
    }

  // ---- 1. the chunk's mask words and scales, once a block ---------------------
  for (int t = lo + tid; t < hi; t += nt) {
    smask[t - lo] = __ldg(mask_row + t);
    if constexpr (KIND != kFp) {  // an append overwrites slot `position`'s below
      sks[t - lo] = __ldg(a.k_scale + row0 + t);
      svs[t - lo] = __ldg(a.v_scale + row0 + t);
    }
  }

  // ---- 2. the step's row, where this block attends over `position` ------------
  if constexpr (APPEND) {
    if (has_pos) {
      const T* kn = static_cast<const T*>(a.k_new) + static_cast<size_t>(b) * D;
      const T* vn = static_cast<const T*>(a.v_new) + static_cast<size_t>(b) * D;
      if constexpr (KIND == kFp) {  // stored as it comes: the cache's type is q's
        for (int d = u0 * hd + tid; d < (u0 + nu) * hd; d += nt) {
          k_rows[static_cast<size_t>(position) * rs + d] = kn[d];
          v_rows[static_cast<size_t>(position) * rs + d] = vn[d];
        }
      } else {
        // the codes of the block's units (a head pair's are its hd bytes); the
        // odd-H int4 path stages the whole row and head block 0 writes it
        const int c_lo = K::kScalar ? 0 : u0 * hd;
        const int c_hi = K::kScalar ? row_w : (u0 + nu) * hd;
        const bool writer = !K::kScalar || ub == 0;
        float ks, vs;
        stage_quantized<KIND>(kn, vn, D, c_lo, c_hi, tid, nt, stage_k, stage_v,
                              writer ? k_rows + static_cast<size_t>(position) * rs : nullptr,
                              writer ? v_rows + static_cast<size_t>(position) * rs : nullptr,
                              red, sync, ks, vs);
        if (tid == 0) {  // the slot's scales, where the read-only kernel finds them
          sks[position - lo] = ks;
          svs[position - lo] = vs;
          if (ub == 0) {
            a.k_scale[row0 + position] = ks;
            a.v_scale[row0 + position] = vs;
          }
        }
      }
    }
  }
  __syncthreads();  // mask words and scales visible

  // ---- 3. attend: the unit's groups over the chunk's slots before `position`,
  //         then it; then the groups of each warp merge --------------------------
  State<NH, EPL> st;
  st.init();
  if (active) {
    const LaneMap lm = lane_map<T, KIND, PAIR>(lg, u, hd, D);
    float qv[NH][EPL];  // pre-scaled and rounded back to T, as the TPU wrapper does
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < EPL; ++i) qv[h][i] = round_to<T>(to_f(q_raw[h][i]) * a.q_scale);
    attend_range<T, KIND, PAIR, true, true>(st, qv, k_rows, v_rows, rs, sks, svs, smask, lo,
                                            end, n_groups, grp, lm, G);
    if (has_pos) {  // slot `position`, by group 0, at the same point in every kind:
                    // after an append the staged codes (fp: the step's row)
      const C* pos_k = k_rows + static_cast<size_t>(position) * rs;
      const C* pos_v = v_rows + static_cast<size_t>(position) * rs;
      if constexpr (APPEND && KIND == kFp) {
        pos_k = static_cast<const T*>(a.k_new) + static_cast<size_t>(b) * D;
        pos_v = static_cast<const T*>(a.v_new) + static_cast<size_t>(b) * D;
      } else if constexpr (APPEND) {
        pos_k = reinterpret_cast<const C*>(stage_k);
        pos_v = reinterpret_cast<const C*>(stage_v);
      }
      const bool live = smask[position - lo] != 0;
      if constexpr (KIND == kFp)
        attend_pos<T, KIND, PAIR>(st, qv, pos_k, pos_v, 0.0f, 0.0f, live, grp, lm, G);
      else
        attend_pos<T, KIND, PAIR>(st, qv, pos_k, pos_v, sks[position - lo], svs[position - lo],
                                  live, grp, lm, G);
    }
    merge_warp(st, G);
  }

  // ---- 4. the unit's warps merge in warp order: ctx, or the chunk's partial ----
  float* part = n_split > 1
                    ? a.scratch + ((static_cast<size_t>(b) * n_split + s_idx) * n_units + u) * P
                    : nullptr;
  T* ctx = static_cast<T*>(a.ctx) + static_cast<size_t>(b) * D;
  merge_groups<NH, EPL, NT>(st, gm, gl, gacc, NW, wi, lane % G, active && lane < G, hd, utid,
                            sync, [&](int h, int d, int, float M, float Lsum, float A) {
                              if (!active) return;
                              if (part == nullptr) {
                                ctx[head_of<PAIR>(u, h, n_head) * hd + d] =
                                    from_f<T>(Lsum > 0.0f ? A / Lsum : 0.0f);
                                return;
                              }
                              if (d == 0) {
                                part[h] = M;
                                part[NH + h] = Lsum;
                              }
                              part[2 * NH + h * hd + d] = A;
                            });
  if (n_split == 1) return;

  // ---- 5. the (row, head block)'s last chunk to finish merges them, in order ----
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(a.counters + b * n_ub + ub, 1);
    is_last = prev == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = a.scratch + static_cast<size_t>(b) * n_split * n_units * P;
  const size_t split_stride = static_cast<size_t>(n_units) * P;
  for (int idx = tid; idx < nu * NH * hd; idx += nt) {
    const int uu = u0 + idx / (NH * hd), r = idx % (NH * hd), hh = r / hd, d = r % hd;
    const float* pu = parts + static_cast<size_t>(uu) * P;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(pu + s * split_stride + hh));
    float Lsum = 0.0f, A = 0.0f;
    if (M != -INFINITY)
      for (int s = 0; s < n_split; ++s) {
        const float ms = __ldcg(pu + s * split_stride + hh);
        const float f = ms == -INFINITY ? 0.0f : expf(ms - M);
        Lsum += __ldcg(pu + s * split_stride + NH + hh) * f;
        A += __ldcg(pu + s * split_stride + 2 * NH + r) * f;
      }
    ctx[head_of<PAIR>(uu, hh, n_head) * hd + d] = from_f<T>(Lsum > 0.0f ? A / Lsum : 0.0f);
  }
  if (tid == 0) a.counters[b * n_ub + ub] = 0;  // ready for the next call
}

// Launch: a block of kWarps warps for each of min(units, kUnits) units.
// Shared memory: the staged codes (append, quantized kinds), the chunk's mask
// words and k / v scales, then the units' warp states.
template <typename T, int KIND, bool APPEND, bool PAIR>
int launch(Args a, int n_split, cudaStream_t stream) {
  using S = Shape<KIND, PAIR>;
  constexpr int NH = Kind<T, KIND, PAIR>::NH;
  const int hd = a.D / a.n_head, units = a.n_head / NH;
  a.G = group_lanes<T, KIND, PAIR>(hd);
  if (a.G > 32 || a.chunk % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = units < S::kUnits ? units : S::kUnits;
  const int row_w = KIND == kInt4 ? a.D / 2 : a.D;
  const size_t stage = APPEND && KIND != kFp ? 2 * static_cast<size_t>((row_w + 15) & ~15) : 0;
  const size_t smem = stage + 3 * sizeof(float) * static_cast<size_t>(a.chunk) +
                      sizeof(float) * per_block * S::kWarps * NH * (2 + hd);
  const dim3 grid((units + S::kUnits - 1) / S::kUnits, n_split, a.B);
  decode_attention_kernel<T, KIND, APPEND, PAIR>
      <<<grid, 32 * S::kWarps * per_block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool APPEND>
int launch_kind(const Args& a, int kind, bool pair, int n_split, cudaStream_t s) {
  if (kind == kFp) return launch<T, kFp, APPEND, false>(a, n_split, s);
  if (kind == kInt8) return launch<T, kInt8, APPEND, false>(a, n_split, s);
  return pair ? launch<T, kInt4, APPEND, true>(a, n_split, s)
              : launch<T, kInt4, APPEND, false>(a, n_split, s);
}

template <typename T>
int launch_dtype(const Args& a, int kind, bool append, bool pair, int n_split, cudaStream_t s) {
  return append ? launch_kind<T, true>(a, kind, pair, n_split, s)
                : launch_kind<T, false>(a, kind, pair, n_split, s);
}

}  // namespace

// C entry point (bound with ctypes). Shapes: q/k_new/v_new/ctx [B, D] (k_new /
// v_new unused without `append`); caches [L, B, T_cap, row_stride] of q's type
// (cache_kind 0), int8 (1) or int8 holding two int4 codes a byte (2);
// `row_stride` is the cache's last dimension in elements: D, D/2 for int4, or
// 2D for the merged k||v buffer, whose v half the caller passes as
// v_cache = k_cache + D. Scales [L, B, T_cap] f32 (ignored for kind 0);
// key_mask [B, T_cap] int32. dtype: 0 = float32, 1 = bfloat16. The slots
// 0..position are taken in n_split chunks of `chunk` slots (a multiple of 4;
// the last chunk holds `position`); with n_split > 1, `scratch` holds B *
// n_split * n_head * (hd + 2) f32 and `counters` B * n_head int32 that are
// ZERO (each call leaves them zero). `pair` (int4 only, even n_head, 16 | hd):
// a unit is the head pair h, h + n_head/2. Cache rows and their head slices
// start on 16-byte boundaries. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a chunk or head width the kernel
// does not take. The caller validates shapes and bounds.
extern "C" int mmtg_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* key_mask, void* ctx, void* scratch,
    void* counters, int B, int T_cap, int D, int n_head, int position, int layer,
    float q_scale, int cache_kind, int append, int row_stride, int dtype, int n_split,
    int chunk, int pair, void* stream) {
  const Args a{q,        k_new,    v_new,   k_cache,    v_cache,
               static_cast<float*>(k_scale),   static_cast<float*>(v_scale),
               static_cast<const int32_t*>(key_mask), ctx, static_cast<float*>(scratch),
               static_cast<int*>(counters),   B,        T_cap,   D,          n_head,
               position, layer,    q_scale, row_stride, chunk, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(a, cache_kind, append != 0, pair != 0, n_split, s);
  return launch_dtype<float>(a, cache_kind, append != 0, pair != 0, n_split, s);
}
