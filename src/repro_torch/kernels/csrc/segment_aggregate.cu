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
// would only add work, so the kernel reads group_ids directly.  Each block
// owns TILE consecutive columns and each thread one column.  The thread
// walks the rows in order, ROWS loads at a time, adding w[n] * x[n, col]
// into its own slot of the (M, TILE) group sums in shared memory; it then
// turns its M sums into means and walks the rows again, writing each row's
// group mean.  Neighbouring threads touch neighbouring addresses
// (coalesced), no two threads share an accumulator (no atomics, a fixed
// summation order), and the buffer is read once and written once.  The row
// loop runs inside the block, so any N takes one launch (the TPU version
// split at N > 512).  Thread 0 also sums the group weights in the same
// pass.  A group whose weights are all 0 gives 0 / 1e-12 = 0, never NaN;
// a group with no members is never read.  Rows whose group id lies outside
// [0, M) add nothing and get zeros, so the kernel never leaves its
// buffers.  Later work: more columns per thread, rows split across warps,
// TMA loads.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int ROWS = 16;  // rows loaded per step of the sum loop

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(TILE)
segment_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const int32_t* __restrict__ gid, float* __restrict__ out,
                         int64_t n_rows, int64_t n_cols, int n_groups) {
  extern __shared__ float smem[];
  float* acc = smem;                          // [n_groups][TILE]
  float* gw = smem + (int64_t)n_groups * TILE;  // [n_groups]
  const int t = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * TILE + t;
  const bool live = col < n_cols;

  for (int m = 0; m < n_groups; ++m) acc[m * TILE + t] = 0.f;
  for (int m = t; m < n_groups; m += TILE) gw[m] = 0.f;
  __syncthreads();

  // ROWS loads in flight per thread before the first add: with one warp
  // per 32 columns there are only ~10 warps per SM at F = 44,426, so the
  // memory system is kept busy by each thread's independent loads.
  for (int64_t n0 = 0; n0 < n_rows; n0 += ROWS) {
    float xv[ROWS], wv[ROWS];
    int gv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t n = n0 + u;
      const bool ok = n < n_rows;
      gv[u] = ok ? gid[n] : -1;
      wv[u] = ok ? w[n] : 0.f;
      xv[u] = (ok && live) ? to_f32(x[n * n_cols + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int g = gv[u];
      if (g < 0 || g >= n_groups) continue;
      acc[g * TILE + t] += wv[u] * xv[u];
      if (t == 0) gw[g] += wv[u];
    }
  }
  __syncthreads();
  if (!live) return;
  // the group means of this thread's column, in place of its sums
  for (int m = 0; m < n_groups; ++m) acc[m * TILE + t] /= fmaxf(gw[m], 1e-12f);

#pragma unroll 4
  for (int64_t n = 0; n < n_rows; ++n) {
    const int g = gid[n];
    out[n * n_cols + col] = (g >= 0 && g < n_groups) ? acc[g * TILE + t] : 0.f;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* gid, void* out,
           int64_t n_rows, int64_t n_cols, int n_groups, cudaStream_t stream) {
  const size_t smem = ((size_t)n_groups * TILE + n_groups) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_aggregate_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((n_cols + TILE - 1) / TILE);
  segment_aggregate_kernel<T><<<blocks, TILE, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(gid), static_cast<float*>(out), n_rows, n_cols, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1);
// w: (n_rows,) fp32; gid: (n_rows,) int32; out: (n_rows, n_cols) fp32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int segment_aggregate(const void* x, const void* w, const void* gid, void* out,
                                 int64_t n_rows, int64_t n_cols, int n_groups,
                                 int x_is_bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, w, gid, out, n_rows, n_cols, n_groups, s)
                   : launch<float>(x, w, gid, out, n_rows, n_cols, n_groups, s);
}
