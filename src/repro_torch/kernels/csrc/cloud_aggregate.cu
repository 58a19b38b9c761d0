// Cloud aggregation, eq. 10: the global weighted mean, broadcast back to
// every row.
//
//   out[n, f] = sum_i w[i] x[i, f] / sum_i w[i]      for every n
//
// No 1e-12 guard on the denominator, as in the JAX reference
// (src/repro/kernels/ref.py::hier_bcast_aggregate_ref): all-zero weights
// give NaN there and here.
//
// Replaces the TPU kernel hier_bcast_aggregate_2d
// (src/repro/kernels/hier_aggregate.py:117, wrapper src/repro/kernels/ops.py:116).
//
// Bound on the card: bytes, as for the edge event: 2 * N * F * 4 bytes /
// 3.35 TB/s (10.6 us at N = 100, F = 44,426); two flops per element read.
//
// Design: each block owns TILE consecutive columns and each thread one
// column.  The thread walks the rows once, ROWS loads at a time, keeping
// the weighted sum and the weight sum in registers, then walks them again writing the mean: one
// coalesced read and one coalesced write of the buffer, no shared memory,
// no atomics, a fixed summation order.  The row loop runs inside the block,
// so any N takes one launch (the TPU version fell through to the segment
// kernel for N > 512).  Later work: more columns per thread, rows split
// across warps, TMA loads.

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
cloud_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int64_t n_rows, int64_t n_cols) {
  const int64_t col = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (col >= n_cols) return;
  float acc = 0.f, wsum = 0.f;
  // ROWS independent loads in flight per thread before the first add (see
  // segment_aggregate.cu: few warps per SM at this width).
  for (int64_t n0 = 0; n0 < n_rows; n0 += ROWS) {
    float xv[ROWS], wv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t n = n0 + u;
      const bool ok = n < n_rows;
      wv[u] = ok ? w[n] : 0.f;
      xv[u] = ok ? to_f32(x[n * n_cols + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      acc += wv[u] * xv[u];
      wsum += wv[u];
    }
  }
  const float mean = acc / wsum;
#pragma unroll 4
  for (int64_t n = 0; n < n_rows; ++n) out[n * n_cols + col] = mean;
}

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t n_rows, int64_t n_cols,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_cols + TILE - 1) / TILE);
  cloud_aggregate_kernel<T><<<blocks, TILE, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      n_rows, n_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1);
// w: (n_rows,) fp32; out: (n_rows, n_cols) fp32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cloud_aggregate(const void* x, const void* w, void* out, int64_t n_rows,
                               int64_t n_cols, int x_is_bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, w, out, n_rows, n_cols, s)
                   : launch<float>(x, w, out, n_rows, n_cols, s);
}
