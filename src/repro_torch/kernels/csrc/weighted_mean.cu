// Reduce-only weighted mean over the client rows: the local step of the
// sharded cloud event (eq. 10 split over data shards).
//
//   out[f] = sum_n w[n] x[n, f] / sum_n w[n]
//
// No 1e-12 guard on the denominator, as in the JAX reference
// (src/repro/kernels/ref.py::hier_aggregate_ref): all-zero weights give
// 0/0 = NaN there and here.  The caller (repro_torch.fl.aggregate's sharded
// cloud event) guards an all-padding shard with `den > 0`.
//
// Replaces the TPU kernel hier_aggregate_2d
// (src/repro/kernels/hier_aggregate.py:62, bodies _agg_kernel :40 and
// _agg_kernel_blocked :46, wrapper src/repro/kernels/ops.py:102).
//
// Bound on the card: bytes.  The slab is read once and only F floats are
// written; two flops per element read, far below the H100's balance point:
// (N * F * elem + N * 4 + F * 4) bytes / 3.35 TB/s (3.2 us for a 60 x 44,426
// fp32 slab, 0.87 ms for a 16,384 x 44,426 fp32 fleet shard).
//
// Design: this is cloud_aggregate.cu's reduce pass without the broadcast.
// Each block owns TILE consecutive columns and each thread one column,
// walking its rows ROWS loads at a time with the weighted sum and the
// weight sum in registers: one coalesced read of the slab, no shared
// memory, no atomics.  The TPU kernel split N > 512 into client blocks of
// 256 for VMEM's sake; here the row loop runs inside the block, so any N
// takes one launch.  A fleet-scale shard has many rows and, where F is
// small, few column tiles, so the rows are also split into `n_slices`
// slices (grid.y; the wrapper's `weighted_mean_slices` rule aims at a
// number of blocks per SM).  With one slice a block writes the mean
// directly.  With more, block (i, s) writes its partial sums to row s of an
// (S, F) scratch and its slice's weight sum to entry s of an (S,) tail, and
// a second kernel adds the S partials of every column in slice order: the
// result does not change from run to run.  Later work: 16-byte loads of
// several columns per thread, TMA loads.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int ROWS = 16;  // rows loaded per step of the sum loop

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (column tiles, slices).  Block (i, s) sums rows
// [s * rows_per_slice, min((s + 1) * rows_per_slice, n_rows)) of columns
// [i * TILE, (i + 1) * TILE).
template <typename T>
__global__ void __launch_bounds__(TILE)
weighted_mean_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, float* __restrict__ partial,
                     int64_t n_rows, int64_t n_cols, int64_t rows_per_slice) {
  const int64_t col = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (col >= n_cols) return;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t r1 = r0 + rows_per_slice < n_rows ? r0 + rows_per_slice : n_rows;
  float acc = 0.f, wsum = 0.f;
  // ROWS independent loads in flight per thread before the first add.
  for (int64_t n0 = r0; n0 < r1; n0 += ROWS) {
    float xv[ROWS], wv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t n = n0 + u;
      const bool ok = n < r1;
      wv[u] = ok ? w[n] : 0.f;
      xv[u] = ok ? to_f32(x[n * n_cols + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      acc += wv[u] * xv[u];
      wsum += wv[u];
    }
  }
  if (gridDim.y == 1) {
    out[col] = acc / wsum;
    return;
  }
  partial[(int64_t)blockIdx.y * n_cols + col] = acc;
  if (col == 0) partial[(int64_t)gridDim.y * n_cols + blockIdx.y] = wsum;
}

// out[f] = sum_s partial[s, f] / sum_s wsum[s], both in slice order.
__global__ void __launch_bounds__(TILE)
combine_slices_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      int64_t n_cols, int n_slices) {
  const int64_t col = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (col >= n_cols) return;
  const float* wpart = partial + (int64_t)n_slices * n_cols;
  float acc = 0.f, wsum = 0.f;
  for (int s = 0; s < n_slices; ++s) {
    acc += partial[(int64_t)s * n_cols + col];
    wsum += wpart[s];
  }
  out[col] = acc / wsum;
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* partial, int64_t n_rows,
           int64_t n_cols, int64_t rows_per_slice, int n_slices, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((n_cols + TILE - 1) / TILE);
  weighted_mean_kernel<T><<<dim3(tiles, (unsigned)n_slices), TILE, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float*>(partial), n_rows, n_cols, rows_per_slice);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_slices == 1) return (int)e;
  combine_slices_kernel<<<tiles, TILE, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_cols, n_slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1);
// w: (n_rows,) fp32; out: (n_cols,) fp32; partial: fp32 scratch of
// n_slices * (n_cols + 1) floats, unused (may be null) when n_slices == 1.
// Rows are split into n_slices slices of rows_per_slice rows (the last may
// be shorter).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int weighted_mean(const void* x, const void* w, void* out, void* partial,
                             int64_t n_rows, int64_t n_cols, int64_t rows_per_slice,
                             int n_slices, int x_is_bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(x, w, out, partial, n_rows, n_cols,
                                           rows_per_slice, n_slices, s)
                   : launch<float>(x, w, out, partial, n_rows, n_cols, rows_per_slice,
                                   n_slices, s);
}
