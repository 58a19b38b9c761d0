// The per-group weighted row sums that segment_sum.cu (K4) and
// segment_aggregate.cu (K1) share:
//
//   sums[m, c] = sum_{n: g(n) = m} w[n] x[n, c],   weights[m] = sum_{n: g(n) = m} w[n]
//
// over one block's TILE consecutive columns of the (N, F) row-major x.
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

}  // namespace seg
