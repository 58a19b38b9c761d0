// The per-group weighted row sums that segment_sum.cu (K4) and
// segment_aggregate.cu (K1) share:
//
//   sums[m, c] = sum_{n: g(n) = m} w[n] x[n, c],   weights[m] = sum_{n: g(n) = m} w[n]
//
// over one block's TILE consecutive columns of the (N, F) row-major x, and
// their one-group case (accumulate_one: every row in the one group, no
// group ids), which cloud_aggregate.cu (K2) and weighted_mean.cu (K3) use.
//
// Layout: a block of `warps` warps (at most MAX_WARPS) owns one column tile;
// lane l holds the tile's columns 4l .. 4l + 3 and loads them VEC elements
// at a time (VEC = 4, 2 or 1: 16-, 8- or 4-byte loads for fp32, 8, 4 or 2
// bytes for bf16), as wide as the row pitch and the address of x allow (the
// wrapper picks VEC).  The warps split the rows: warp k takes rows first + k,
// first + k + warps, ...  Each warp adds into its own (M, TILE) slot of
// sums in shared memory (and, for K1, lane 0 into its own (M,) slot of
// weights), ROWS rows at a time: the ROWS rows' loads are all issued before
// the first add, lanes 0 .. ROWS-1 read the rows' group ids and weights
// once and the warp shares them by shuffles.  No two warps share a slot,
// so rows of one group chain only within a warp, and the slots are then
// added in warp order: a fixed order, no atomics, the same bits from run
// to run.  Rows whose group id lies outside [0, M) add nothing.
//
// One group (accumulate_one) differs in three ways.  A lane keeps its 4
// column sums (and every lane the weight sum) in registers and writes them
// to its warp's slot once, at the end.  Its 4 columns are spread
// (spread_offset): 4 / VEC runs of VEC columns, 32 VEC columns apart, so
// that each load of the warp reads 32 VEC consecutive elements (with 4
// consecutive columns a lane, each 8- or 4-byte load of a warp touches
// every 32-byte sector of its span, and the next load touches them again).
// And a batch holds the loads' bits as loaded, 32 registers of them:
// 8 rows of fp32 and 16 of packed bf16, the same bytes in flight.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace seg {

constexpr int TILE = 128;       // columns per block: 4 per lane
constexpr int ROWS = 8;         // rows a warp loads before it adds them
constexpr int MAX_WARPS = 16;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// VEC consecutive elements at p (aligned to VEC elements) as floats.  x is
// read once: the loads ask the L2 to evict its lines first.
template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (VEC == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  } else if constexpr (VEC == 2) {
    const unsigned a = __ldcs(reinterpret_cast<const unsigned*>(p));
    v[0] = bf16_lo(a); v[1] = bf16_hi(a);
  } else {
    v[0] = __uint_as_float((unsigned)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

// VEC consecutive floats v to p (aligned to VEC floats).
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Columns of the lane whose first column is `col` that lie inside the row
// (0 to 4; a multiple of VEC, since VEC divides the row's length).
__device__ __forceinline__ int live_columns(int64_t n_cols, int64_t col) {
  const int64_t left = n_cols - col;
  return left <= 0 ? 0 : left >= 4 ? 4 : (int)left;
}

// Asks the L2 for the 128-byte line at p.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Zeroes the lane's columns of the warp's slot (and lane 0 the warp's
// weights): no lane reads another's, so no barrier is needed after it.
__device__ __forceinline__ void zero_slot(float* slot, float* weights, int n_groups) {
  const int lane = threadIdx.x & 31;
  for (int m = 0; m < n_groups; ++m)
    *reinterpret_cast<float4*>(slot + m * TILE + 4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
  if (weights != nullptr && lane == 0)
    for (int m = 0; m < n_groups; ++m) weights[m] = 0.f;
}

// Adds w[n] * x[n, col .. col + 3] into slot[g(n)][4 lane .. 4 lane + 3] for
// the rows n = first, first + step, ... < last, and where `weights` is not
// null, w[n] into weights[g(n)] (lane 0).  `slot` is this warp's (M, TILE)
// sums and `weights` its (M,) weight sums, both in shared memory, zeroed
// here while the first rows' loads are in flight.  Every lane of the warp
// calls it (the shuffles need them all); `live` is the count of the lane's
// columns inside the row.
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const T* __restrict__ x, const float* __restrict__ w,
                                           const int32_t* __restrict__ gid, int64_t n_cols,
                                           int64_t col, int live, int64_t first, int64_t last,
                                           int step, int n_groups, float* slot, float* weights) {
  const int lane = threadIdx.x & 31;
  bool zeroed = false;
  for (int64_t n0 = first; n0 < last; n0 += (int64_t)ROWS * step) {
    const int64_t mine = n0 + (int64_t)(lane % ROWS) * step;
    int g_lane = -1;
    float w_lane = 0.f;
    if (lane < ROWS && mine < last) {
      g_lane = __ldg(gid + mine);
      w_lane = __ldg(w + mine);
    }
    // x's loads are issued with the group ids' and weights', not after
    float v[ROWS][4];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t n = n0 + (int64_t)u * step;
      const T* p = x + n * n_cols + col;
#pragma unroll
      for (int i = 0; i < 4; i += VEC) {
        if (n < last && i < live) {
          load<VEC>(p + i, &v[u][i]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[u][i + j] = 0.f;
        }
      }
    }
    if (!zeroed) {
      zero_slot(slot, weights, n_groups);
      zeroed = true;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int g = __shfl_sync(FULL, g_lane, u);
      const float wt = __shfl_sync(FULL, w_lane, u);
      if (g < 0 || g >= n_groups) continue;
      float4* s = reinterpret_cast<float4*>(slot + g * TILE + 4 * lane);
      float4 a = *s;
      a.x = fmaf(wt, v[u][0], a.x);
      a.y = fmaf(wt, v[u][1], a.y);
      a.z = fmaf(wt, v[u][2], a.z);
      a.w = fmaf(wt, v[u][3], a.w);
      *s = a;
      if (weights != nullptr && lane == 0) weights[g] += wt;
    }
  }
  if (!zeroed) zero_slot(slot, weights, n_groups);
}

// The bits of one load of VEC elements of T, kept as loaded until they
// are added.
template <typename T, int VEC> struct Bits;
template <> struct Bits<float, 4> { using type = float4; };
template <> struct Bits<float, 2> { using type = float2; };
template <> struct Bits<float, 1> { using type = float; };
template <> struct Bits<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Bits<__nv_bfloat16, 2> { using type = unsigned; };
template <> struct Bits<__nv_bfloat16, 1> { using type = unsigned short; };

// The floats that a load's bits hold, into v.
__device__ __forceinline__ void unpack(float4 b, float* v) {
  v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
}
__device__ __forceinline__ void unpack(float2 b, float* v) { v[0] = b.x; v[1] = b.y; }
__device__ __forceinline__ void unpack(float b, float* v) { v[0] = b; }
__device__ __forceinline__ void unpack(uint2 b, float* v) {
  v[0] = bf16_lo(b.x); v[1] = bf16_hi(b.x); v[2] = bf16_lo(b.y); v[3] = bf16_hi(b.y);
}
__device__ __forceinline__ void unpack(unsigned b, float* v) { v[0] = bf16_lo(b); v[1] = bf16_hi(b); }
__device__ __forceinline__ void unpack(unsigned short b, float* v) {
  v[0] = __uint_as_float((unsigned)b << 16);
}

// One load of x, which is read once: evict-first in the caches (__ldcs) or
// through the read-only data path (__ldg).
template <bool EVICT_FIRST, typename B>
__device__ __forceinline__ B ld(const B* p) {
  if constexpr (EVICT_FIRST) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

// Offset from the lane's first column of its element i (0 to 3) in the
// spread layout: run i / VEC, 32 VEC columns a run.
template <int VEC>
__device__ __forceinline__ int spread_offset(int i) {
  return 32 * VEC * (i / VEC);
}

// Elements of the lane whose first column is `col` that lie inside the row
// in the spread layout: VEC times its runs inside the row (a prefix of
// them, since VEC divides the row's length).
template <int VEC>
__device__ __forceinline__ int live_spread(int64_t n_cols, int64_t col) {
  int live = 0;
#pragma unroll
  for (int i = 0; i < 4; i += VEC)
    if (col + spread_offset<VEC>(i) < n_cols) live += VEC;
  return live;
}

// The one-group case of accumulate: w[n] * x[n, c] summed over the rows
// n = first, first + step, ... < last in that order for the lane's 4
// columns c in the spread layout from `col` (its first `live` inside the
// row), written to this warp's (TILE,) slot (4 lane .. 4 lane + 3, in the
// lane's order) and, by lane 0, the sum of those w[n] to *weight, once,
// after the last row.  The sums stay in registers until then: no group
// ids, no per-row read-modify-write of shared memory.  Every lane of the
// warp calls it; EVICT_FIRST picks x's loads (ld).
template <typename T, int VEC, bool EVICT_FIRST>
__device__ __forceinline__ void accumulate_one(const T* __restrict__ x,
                                               const float* __restrict__ w, int64_t n_cols,
                                               int64_t col, int live, int64_t first,
                                               int64_t last, int step, float* slot,
                                               float* weight) {
  using B = typename Bits<T, VEC>::type;
  constexpr int LOADS = 4 / VEC;                                    // a row
  constexpr int BATCH = ROWS * 4 / (LOADS * ((sizeof(B) + 3) / 4));  // rows
  const int lane = threadIdx.x & 31;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float ws = 0.f;
  for (int64_t n0 = first; n0 < last; n0 += (int64_t)BATCH * step) {
    const int64_t mine = n0 + (int64_t)(lane % BATCH) * step;
    const float w_lane = lane < BATCH && mine < last ? __ldg(w + mine) : 0.f;
    B b[BATCH][LOADS];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int64_t n = n0 + (int64_t)u * step;
      const T* p = x + n * n_cols + col;
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        const B* q = reinterpret_cast<const B*>(p + spread_offset<VEC>(k * VEC));
        b[u][k] = n < last && k * VEC < live ? ld<EVICT_FIRST>(q) : B{};
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (n0 + (int64_t)u * step >= last) break;    // (the same on every lane)
      const float wt = __shfl_sync(FULL, w_lane, u);
#pragma unroll
      for (int k = 0; k < LOADS; ++k) {
        float v[VEC];
        unpack(b[u][k], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[k * VEC + j] = fmaf(wt, v[j], s[k * VEC + j]);
      }
      ws += wt;
    }
  }
  *reinterpret_cast<float4*>(slot + 4 * lane) = make_float4(s[0], s[1], s[2], s[3]);
  if (lane == 0) *weight = ws;
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The warps' slots (`stride` floats apart) at float e, added in warp order.
__device__ __forceinline__ float warp_order_sum(const float* slots, int stride, int warps, int e) {
  float s = slots[e];
  for (int k = 1; k < warps; ++k) s += slots[k * stride + e];
  return s;
}

// The same for the float4 at i of float4 slots `stride` float4s apart.
__device__ __forceinline__ float4 warp_order_sum(const float4* slots, int stride, int warps,
                                                 int i) {
  float4 s = slots[i];
  for (int k = 1; k < warps; ++k) s = s + slots[k * stride + i];
  return s;
}

// The n values (float4 or float) at p, p + stride, ..., added in that
// order, read from the L2 (__ldcg: they are other blocks' partials, fenced
// before those blocks counted in): SPAN loads in flight at a time.
template <int SPAN, typename V>
__device__ __forceinline__ V slice_order_sum(const V* p, int64_t stride, int n) {
  V s{};
  for (int k0 = 0; k0 < n; k0 += SPAN) {
    V v[SPAN];
#pragma unroll
    for (int j = 0; j < SPAN; ++j) v[j] = k0 + j < n ? __ldcg(p + (k0 + j) * stride) : V{};
#pragma unroll
    for (int j = 0; j < SPAN; ++j)
      if (k0 + j < n) s = s + v[j];
  }
  return s;
}

}  // namespace seg
