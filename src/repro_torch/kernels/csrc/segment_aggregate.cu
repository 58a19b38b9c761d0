// Edge aggregation, eq. 6: per-edge weighted segment mean, scattered back
// to every member row.
//
//   out[n, f] = sum_{i: g(i) = g(n)} w[i] x[i, f] / max(sum_{i: g(i) = g(n)} w[i], 1e-12)
//
// Replaces the TPU kernel hier_segment_aggregate_2d
// (src/repro/kernels/hier_aggregate.py:182, wrapper src/repro/kernels/ops.py:133).
//
// Bound on the card: bytes.  The event reads the (N, F) buffer once and
// writes it once and does two flops per element read, far below the
// H100's ~20 flops per byte balance point, so the least time is
// 2 * N * F * 4 bytes / 3.35 TB/s (10.6 us at N = 100, F = 44,426).
//
// Design: the TPU kernel turned membership into a dense (M, N) one-hot so
// that the reduction and the scatter-back became MXU matmuls; here that
// would only add work, so the kernel reads group_ids directly.  One launch,
// one block per TILE = 128 columns, and every row of those columns in the
// block.  The read pass is segment_core.cuh's: lanes hold 4 columns (8- or
// 16-byte loads where x allows), the warps split the rows and add into
// per-warp slots of group sums and group weights, which are then summed in
// warp order and turned into the tile's (M, TILE) group means in shared
// memory.  Then each warp writes its own rows, each row's group mean, ROWS
// rows' group ids read at once: the write pass runs on all warps of the
// block, and blocks of other tiles overlap it.  The buffer is read once and
// written once; no atomics, a fixed summation order.  A group whose weights
// are all 0 gives 0 / 1e-12 = 0, never NaN; a group with no members is
// never read.  Rows whose group id lies outside [0, M) add nothing and get
// zeros, so the kernel never leaves its buffers.

#include "segment_core.cuh"

namespace {

using seg::ROWS;
using seg::TILE;

// Writes the group mean of each of the rows n = first, first + step, ...
// < last into out[n, col .. col + 3] (its `live` columns), zeros for a row
// whose group id lies outside [0, M).  `mean` is the tile's (M, TILE)
// means in shared memory.  Every lane of the warp calls it.
template <int VEC>
__device__ __forceinline__ void scatter(const int32_t* __restrict__ gid, float* __restrict__ out,
                                        int64_t n_cols, int64_t col, int live, int64_t first,
                                        int64_t last, int step, int n_groups,
                                        const float* mean) {
  const int lane = threadIdx.x & 31;
  for (int64_t n0 = first; n0 < last; n0 += (int64_t)ROWS * step) {
    const int64_t mine = n0 + (int64_t)(lane % ROWS) * step;
    const int g_lane = lane < ROWS && mine < last ? __ldg(gid + mine) : -1;
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int g = __shfl_sync(seg::FULL, g_lane, u);
      const int64_t n = n0 + (int64_t)u * step;
      if (n >= last) break;                         // (the same on every lane)
      const float4 m = g >= 0 && g < n_groups
                           ? *reinterpret_cast<const float4*>(mean + g * TILE + 4 * lane)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      const float v[4] = {m.x, m.y, m.z, m.w};
      float* p = out + n * n_cols + col;
#pragma unroll
      for (int i = 0; i < 4; i += VEC)
        if (i < live) seg::store<VEC>(p + i, v + i);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(seg::MAX_THREADS)
segment_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const int32_t* __restrict__ gid, float* __restrict__ out,
                         int64_t n_rows, int64_t n_cols, int n_groups) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int entries = n_groups * TILE;
  float* sums = reinterpret_cast<float*>(smem4);    // [warps][n_groups][TILE]
  float* weights = sums + warps * entries;          // [warps][n_groups]
  const int64_t col = (int64_t)blockIdx.x * TILE + 4 * lane;
  const int live = seg::live_columns(n_cols, col);

  seg::accumulate<T, VEC>(x, w, gid, n_cols, col, live, warp, n_rows, warps, n_groups,
                          sums + warp * entries, weights + warp * n_groups);
  __syncthreads();
  // The groups' weights and then their means, summed in warp order, in
  // place of warp 0's slots.
  for (int m = threadIdx.x; m < n_groups; m += blockDim.x)
    weights[m] = fmaxf(seg::warp_order_sum(weights, n_groups, warps, m), 1e-12f);
  __syncthreads();
  float4* sums4 = reinterpret_cast<float4*>(sums);
  for (int i = threadIdx.x; i < entries / 4; i += blockDim.x) {
    const float4 s = seg::warp_order_sum(sums4, entries / 4, warps, i);
    const float d = weights[i / (TILE / 4)];
    sums4[i] = make_float4(s.x / d, s.y / d, s.z / d, s.w / d);
  }
  __syncthreads();
  scatter<VEC>(gid, out, n_cols, col, live, warp, n_rows, warps, n_groups, sums);
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* gid, void* out, int64_t n_rows,
           int64_t n_cols, int n_groups, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)warps * n_groups * (TILE + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_aggregate_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_cols + TILE - 1) / TILE);
  segment_aggregate_kernel<T, VEC><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(gid), static_cast<float*>(out), n_rows, n_cols, n_groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const void* w, const void* gid, void* out,
               int64_t n_rows, int64_t n_cols, int n_groups, int warps, cudaStream_t stream) {
  switch (vec) {
    case 4: return launch<T, 4>(x, w, gid, out, n_rows, n_cols, n_groups, warps, stream);
    case 2: return launch<T, 2>(x, w, gid, out, n_rows, n_cols, n_groups, warps, stream);
    case 1: return launch<T, 1>(x, w, gid, out, n_rows, n_cols, n_groups, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1), loaded
// `vec` elements at a time (4, 2 or 1: the row pitch and the address of x
// are multiples of vec elements); w: (n_rows,) fp32; gid: (n_rows,) int32;
// out: (n_rows, n_cols) fp32; `warps` warps a block (1 to 16).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int segment_aggregate(const void* x, const void* w, const void* gid, void* out,
                                 int64_t n_rows, int64_t n_cols, int n_groups, int warps,
                                 int vec, int x_is_bf16, int device, void* stream) {
  if (warps < 1 || warps > seg::MAX_WARPS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? launch_vec<__nv_bfloat16>(vec, x, w, gid, out, n_rows, n_cols, n_groups, warps, s)
             : launch_vec<float>(vec, x, w, gid, out, n_rows, n_cols, n_groups, warps, s);
}
