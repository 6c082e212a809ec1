// Device functions shared by the decode kernels: one-query attention of a
// head (or int4 head pair) over the live slots of a cache, with the step's k/v
// row appended where the cache kind asks for it. Two callers, two
// decompositions over the same pieces, so the arithmetic of a slot cannot
// drift apart:
//   * decode_attention.cu (the per-layer kernel): a block owns a few heads of
//     one batch row and a chunk of its slots, a few warps each head; it reads
//     the chunk's mask words and scales into shared memory once, and merges a
//     head's groups by shuffles inside each warp (merge_warp, its own) and then
//     across the head's warps (merge_groups);
//   * decode_block_fused.cu (the whole-step kernel): a 64-thread item owns one
//     (batch row, head) and merges its groups with merge_groups alone.
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
// The pieces, in the order a head runs them:
//   * lane_map: a lane loads 16 bytes of a slot's head row, neighbouring lanes
//     the neighbouring bytes: a group of G = hd * size / 16 lanes covers the
//     row, and each group keeps its own online softmax (State, sweep);
//   * stage_quantized (the append, recomputed where it is read): the row's
//     scale is an abs-max over ALL heads of k_new / v_new, so every block or
//     item that attends over slot `position` computes it, and the codes of its
//     own heads into shared memory; exactly one writer stores each code and
//     the scales, and no one reads slot `position` from the cache, so nothing
//     races;
//   * attend_range, then attend_pos: the slots before `position`, then slot
//     `position` (by group 0) at the same point of every sweep, so a read-only
//     call after an append gives the same ctx bit for bit;
//   * merge_warp / merge_groups: the groups of a head merge in a fixed order.
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

constexpr int kFp = 0, kInt8 = 1, kInt4 = 2;
constexpr int kUnroll = 4;  // slots a lane loads before it reduces

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

// The lane's view of one cache kind: EPL elements of each of NH heads come
// out of one 16-byte raw value.
template <typename T, int KIND, bool PAIR>
struct Kind {
  using C = typename CacheElem<T, KIND>::type;
  static constexpr int NH = PAIR ? 2 : 1;
  static constexpr int EPL =
      KIND == kFp ? 16 / static_cast<int>(sizeof(T)) : (KIND == kInt4 && !PAIR ? 8 : 16);
  static constexpr bool kScalar = KIND == kInt4 && !PAIR;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Where this lane's elements live in a stored row: `off` is the element (fp,
// int8) or byte (int4) offset of its 16 bytes; for the plain int4 path `col`
// / `high` give each element's byte and nibble. `valid`: the lane holds
// elements of the head at all (the group is rounded up to a power of two).
struct LaneMap {
  int off;
  bool valid;
  int col[8];
  unsigned high;  // bit i: element i is a high nibble
  unsigned live;  // bit i: element i lies inside the head
};

// The map of lane `lg` of its group for head (or head pair) `hb`.
template <typename T, int KIND, bool PAIR>
__device__ __forceinline__ LaneMap lane_map(int lg, int hb, int hd, int D) {
  constexpr int EPL = Kind<T, KIND, PAIR>::EPL;
  LaneMap lm;
  lm.high = 0u;
  lm.live = 0u;
  lm.valid = lg * EPL < hd;
  if constexpr (Kind<T, KIND, PAIR>::kScalar) {
    const int half = D >> 1;
    lm.off = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lg * EPL + i;
      const int g = hb * hd + e;
      lm.col[i] = g >= half ? g - half : g;
      if (g >= half) lm.high |= 1u << i;
      if (e < hd) lm.live |= 1u << i;
    }
  } else {
    // elements of head hb (fp, int8), or bytes of head pair hb (int4)
    lm.off = hb * hd + lg * EPL;
  }
  return lm;
}

template <typename T, int KIND, bool PAIR>
__device__ __forceinline__ uint4 load_raw(const typename Kind<T, KIND, PAIR>::C* row,
                                          const LaneMap& lm, bool nc) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (Kind<T, KIND, PAIR>::kScalar) {
    const int8_t* bytes = reinterpret_cast<const int8_t*>(row);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lm.live >> i & 1u) {
        const uint32_t b = static_cast<uint8_t>(nc ? __ldg(bytes + lm.col[i]) : bytes[lm.col[i]]);
        w[i >> 2] |= b << (8 * (i & 3));
      }
    r.x = w[0];
    r.y = w[1];
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(row + lm.off);
    r = nc ? __ldg(p) : *p;
  }
  return r;
}

// raw 16 bytes -> f[h][i] as floats (codes for the quantized kinds)
template <typename T, int KIND, bool PAIR>
__device__ __forceinline__ void unpack(const uint4& r, const LaneMap& lm,
                                       float (&f)[Kind<T, KIND, PAIR>::NH][Kind<T, KIND, PAIR>::EPL]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (KIND == kFp) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[0][i] = __uint_as_float(w[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[0][2 * i] = bf16_lo(w[i]);
        f[0][2 * i + 1] = bf16_hi(w[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < Kind<T, KIND, PAIR>::EPL; ++i) {
      const int b = static_cast<int>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
      if constexpr (KIND == kInt8) {
        f[0][i] = static_cast<float>(b);
      } else {
        const float lo = static_cast<float>(static_cast<int>(static_cast<int8_t>(b << 4)) >> 4);
        const float hi = static_cast<float>(b >> 4);  // arithmetic shift: signed
        if constexpr (PAIR) {
          f[0][i] = lo;
          f[1][i] = hi;
        } else {
          f[0][i] = (lm.high >> i & 1u) ? hi : lo;
        }
      }
    }
  }
}

// Per-group online-softmax state of NH heads; a lane holds EPL accumulator
// entries of each.
template <int NH, int EPL>
struct State {
  float m[NH], l[NH], acc[NH][EPL];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[h][i] = 0.0f;
    }
  }
};

// One sweep step over U slots of the lane's group: scores (summed over the
// group's G lanes), then the online-softmax update. `kr` / `vr` hold the
// slots' raw k / v bytes (zero where not loaded), `ok` whether the slot is
// live, `ks` / `vs` its scales. Every lane of the warp calls it.
template <typename T, int KIND, bool PAIR, int U>
__device__ __forceinline__ void sweep(
    State<Kind<T, KIND, PAIR>::NH, Kind<T, KIND, PAIR>::EPL>& st,
    const float (&qv)[Kind<T, KIND, PAIR>::NH][Kind<T, KIND, PAIR>::EPL], const uint4 (&kr)[U],
    const uint4 (&vr)[U], const bool (&ok)[U], const float (&ks)[U], const float (&vs)[U],
    const LaneMap& lm, int G) {
  using K = Kind<T, KIND, PAIR>;
  constexpr int NH = K::NH, EPL = K::EPL;
  float s[U][NH];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[NH][EPL];
    unpack<T, KIND, PAIR>(kr[u], lm, kf);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) part += qv[h][i] * kf[h][i];
      for (int o = G >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if constexpr (KIND != kFp) part *= ks[u];
      s[u][h] = ok[u] ? part : -INFINITY;
    }
  }
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) any |= ok[u];
  if (!any) return;  // no live slot in this step (uniform over the group)
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float cmax = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) cmax = fmaxf(cmax, s[u][h]);
    const float m_new = fmaxf(st.m[h], cmax);
    const float corr = expf(st.m[h] - m_new);  // m == -inf gives 0
    st.l[h] *= corr;
#pragma unroll
    for (int i = 0; i < EPL; ++i) st.acc[h][i] *= corr;
    st.m[h] = m_new;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!ok[u]) continue;
    float vf[NH][EPL];
    unpack<T, KIND, PAIR>(vr[u], lm, vf);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float p = expf(s[u][h] - st.m[h]);
      st.l[h] += p;
      if constexpr (KIND != kFp) p *= vs[u];
#pragma unroll
      for (int i = 0; i < EPL; ++i) st.acc[h][i] += p * vf[h][i];
    }
  }
}

// The append stage of the quantized kinds, recomputed by every item that
// attends over slot `position`: the row's scales (abs-max over the WHOLE row
// of `kn` / `vn`, D values of type S) and its codes lo..hi-1 (int4: packed
// bytes lo..hi-1 of D/2), into `sk` / `sv` in shared memory at their offsets
// in the row and, where `dk` / `dv` are not null, into the cache row there.
// Called by the caller's `nt` threads (`tid` 0..nt-1, whole warps); `red` is
// 2 * (nt / 32) floats of shared memory; `sync()` is the callers' barrier. The
// staged codes are visible to them when it returns.
template <int KIND, typename S, typename Sync>
__device__ __forceinline__ void stage_quantized(const S* kn, const S* vn, int D, int lo, int hi,
                                                int tid, int nt, int8_t* sk, int8_t* sv,
                                                int8_t* dk, int8_t* dv, float* red, Sync sync,
                                                float& ks, float& vs) {
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  float mk = 0.0f, mv = 0.0f;
  for (int d = tid; d < D; d += nt) {
    mk = fmaxf(mk, fabsf(to_f(kn[d])));
    mv = fmaxf(mv, fabsf(to_f(vn[d])));
  }
  mk = warp_max(mk);
  mv = warp_max(mv);
  if (lane == 0) {
    red[warp] = mk;
    red[n_warps + warp] = mv;
  }
  sync();
  mk = 0.0f;
  mv = 0.0f;
  for (int w = 0; w < n_warps; ++w) {  // a maximum: the order does not matter
    mk = fmaxf(mk, red[w]);
    mv = fmaxf(mv, red[n_warps + w]);
  }
  constexpr float qmax = KIND == kInt8 ? 127.0f : 7.0f;
  ks = fmaxf(mk, 1e-6f) / qmax;
  vs = fmaxf(mv, 1e-6f) / qmax;
  if constexpr (KIND == kInt8) {
    for (int d = lo + tid; d < hi; d += nt) {
      sk[d] = static_cast<int8_t>(quantize(to_f(kn[d]), ks, qmax));
      sv[d] = static_cast<int8_t>(quantize(to_f(vn[d]), vs, qmax));
      if (dk != nullptr) {
        dk[d] = sk[d];
        dv[d] = sv[d];
      }
    }
  } else {
    const int half = D >> 1;
    for (int j = lo + tid; j < hi; j += nt) {
      const int klo = quantize(to_f(kn[j]), ks, qmax), khi = quantize(to_f(kn[j + half]), ks, qmax);
      const int vlo = quantize(to_f(vn[j]), vs, qmax), vhi = quantize(to_f(vn[j + half]), vs, qmax);
      sk[j] = static_cast<int8_t>(((khi & 15) << 4) | (klo & 15));
      sv[j] = static_cast<int8_t>(((vhi & 15) << 4) | (vlo & 15));
      if (dk != nullptr) {
        dk[j] = sk[j];
        dv[j] = sv[j];
      }
    }
  }
  sync();
}

// The slots lo..end-1 of one item (all before `position`), group `grp` of
// `n_groups`, kUnroll slots a lane in flight. `k_rows` / `v_rows`: slot 0 of
// the (layer, batch row); `ks_row` / `vs_row`: that row's [T_cap] scales;
// `rs`: the row stride in cache elements. Masked slots cost no bytes.
// `mask_row` is the row's [T_cap] words in global memory, or with SMEM_MASK
// shared memory that holds slots lo.. from its start; SMEM_SCALES does the
// same for `ks_row` / `vs_row`.
template <typename T, int KIND, bool PAIR, bool SMEM_MASK = false, bool SMEM_SCALES = false>
__device__ __forceinline__ void attend_range(
    State<Kind<T, KIND, PAIR>::NH, Kind<T, KIND, PAIR>::EPL>& st,
    const float (&qv)[Kind<T, KIND, PAIR>::NH][Kind<T, KIND, PAIR>::EPL],
    const typename Kind<T, KIND, PAIR>::C* k_rows, const typename Kind<T, KIND, PAIR>::C* v_rows,
    size_t rs, const float* ks_row, const float* vs_row, const int32_t* mask_row, int lo,
    int end, int n_groups, int grp, const LaneMap& lm, int G) {
  for (int base = lo; base < end; base += n_groups * kUnroll) {  // uniform trip count
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * n_groups + grp;
      ok[u] = t < end && (SMEM_MASK ? mask_row[t - lo] : __ldg(mask_row + t)) != 0;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 0.0f;
      if (ok[u]) {  // masked slots cost no bytes (loading them too was slower)
        if (lm.valid) {
          kr[u] = load_raw<T, KIND, PAIR>(k_rows + t * rs, lm, true);
          vr[u] = load_raw<T, KIND, PAIR>(v_rows + t * rs, lm, true);
        }
        if constexpr (KIND != kFp) {
          ks[u] = SMEM_SCALES ? ks_row[t - lo] : __ldg(ks_row + t);
          vs[u] = SMEM_SCALES ? vs_row[t - lo] : __ldg(vs_row + t);
        }
      }
    }
    sweep<T, KIND, PAIR, kUnroll>(st, qv, kr, vr, ok, ks, vs, lm, G);
  }
}

// Slot `position`, by group 0: its row at `pos_k` / `pos_v` (the staged row
// after an append, else the cache's) with scales `pos_ks` / `pos_vs`.
template <typename T, int KIND, bool PAIR>
__device__ __forceinline__ void attend_pos(
    State<Kind<T, KIND, PAIR>::NH, Kind<T, KIND, PAIR>::EPL>& st,
    const float (&qv)[Kind<T, KIND, PAIR>::NH][Kind<T, KIND, PAIR>::EPL],
    const typename Kind<T, KIND, PAIR>::C* pos_k, const typename Kind<T, KIND, PAIR>::C* pos_v,
    float pos_ks, float pos_vs, bool live, int grp, const LaneMap& lm, int G) {
  uint4 kr[1] = {make_uint4(0u, 0u, 0u, 0u)}, vr[1] = {make_uint4(0u, 0u, 0u, 0u)};
  bool ok[1] = {grp == 0 && live};
  float ks[1] = {pos_ks}, vs[1] = {pos_vs};
  if (ok[0] && lm.valid) {
    kr[0] = load_raw<T, KIND, PAIR>(pos_k, lm, false);
    vr[0] = load_raw<T, KIND, PAIR>(pos_v, lm, false);
  }
  sweep<T, KIND, PAIR, 1>(st, qv, kr, vr, ok, ks, vs, lm, G);
}

// Merge the groups of one head (or head pair) in group order. `gm` / `gl`:
// [NH][n_groups] floats, `gacc`: [NH][n_groups][hd] floats of shared memory;
// the lanes with `store` write their group's state there. Then for every
// (head h, lane d) out(h, d, idx = h * hd + d, M, Lsum, A): the running max,
// the sum and the accumulator of the merged softmax (ctx = A / Lsum). Called
// by the head's NT threads (`tid` 0..NT-1); `sync()` is their barrier.
template <int NH, int EPL, int NT, typename Sync, typename Out>
__device__ __forceinline__ void merge_groups(const State<NH, EPL>& st, float* gm, float* gl,
                                             float* gacc, int n_groups, int grp, int lg,
                                             bool store, int hd, int tid, Sync sync, Out out) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (!store) break;
    if (lg == 0) {
      gm[h * n_groups + grp] = st.m[h];
      gl[h * n_groups + grp] = st.l[h];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (lg * EPL + i < hd) gacc[(h * n_groups + grp) * hd + lg * EPL + i] = st.acc[h][i];
  }
  sync();
  for (int idx = tid; idx < NH * hd; idx += NT) {
    const int h = idx / hd, d = idx % hd;
    float M = -INFINITY;
    for (int g = 0; g < n_groups; ++g) M = fmaxf(M, gm[h * n_groups + g]);
    float Lsum = 0.0f, A = 0.0f;
    if (M != -INFINITY)
      for (int g = 0; g < n_groups; ++g) {
        const float mg = gm[h * n_groups + g];
        const float f = mg == -INFINITY ? 0.0f : expf(mg - M);
        Lsum += gl[h * n_groups + g] * f;
        A += gacc[(h * n_groups + g) * hd + d] * f;
      }
    out(h, d, idx, M, Lsum, A);
  }
}

// The per-layer kernel's merge of the groups of one warp (G lanes each) by
// shuffles: group g takes group g ^ 1, then the pair g ^ 2, ... One fixed
// tree; each step's two terms are added in either order to the same bits, so
// every group ends with the warp's merged state.
template <int NH, int EPL>
__device__ __forceinline__ void merge_warp(State<NH, EPL>& st, int G) {
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float mo = __shfl_xor_sync(0xffffffffu, st.m[h], o);
      const float lo = __shfl_xor_sync(0xffffffffu, st.l[h], o);
      const float M = fmaxf(st.m[h], mo);
      const float f = st.m[h] == -INFINITY ? 0.0f : expf(st.m[h] - M);
      const float fo = mo == -INFINITY ? 0.0f : expf(mo - M);
      st.l[h] = st.l[h] * f + lo * fo;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, st.acc[h][i], o);
        st.acc[h][i] = st.acc[h][i] * f + ao * fo;
      }
      st.m[h] = M;
    }
  }
}

// Lanes a head row takes, a power of two: the group size G.
template <typename T, int KIND, bool PAIR>
__host__ __device__ __forceinline__ int group_lanes(int hd) {
  int G = 1;
  while (G * Kind<T, KIND, PAIR>::EPL < hd) G <<= 1;
  return G;
}

}  // namespace mmtg
