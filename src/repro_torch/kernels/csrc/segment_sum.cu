// Streaming edge accumulation: per-group weighted sums of one chunk of
// client rows, added into the (M, F) accumulator.  No normalisation, no
// scatter-back.
//
//   out[m, f] += sum_{n: g(n) = m} w[n] x[n, f]
//
// The kernel adds INTO `out` in place: the caller's accumulator (or a
// zeroed tensor) is read and written once per launch.  Each column's chunk
// sum is formed first and then added to `out`, so the association is the
// JAX package's `num + segment_sum(...)`.
//
// Replaces the TPU kernel hier_segment_sum_2d
// (src/repro/kernels/hier_aggregate.py:263, wrapper src/repro/kernels/ops.py:159).
//
// Bound on the card: bytes.  The chunk is read once (N * F * 4 bytes for
// fp32), the (M, F) accumulator read and written once, and the work is two
// flops per element read, far below the H100's ~20 flops per byte balance
// point: (N * F + 2 * M * F) * 4 bytes / 3.35 TB/s (10.1 us at N = 8192,
// F = 1024, M = 16).
//
// Design: the TPU kernel multiplied a dense (M, N) one-hot by the chunk on
// the MXU and carried the (M, blk_f) sums in VMEM across a sequential
// client-block grid axis.  Here, as in segment_aggregate.cu, membership is
// read from group_ids directly: each block owns TILE consecutive columns
// and each thread one column, keeping its M sums in its own slot of an
// (M, TILE) array in shared memory and walking the rows ROWS loads at a
// time.  At the streaming shape (8192 x 1024) 128-column tiles give only 8
// blocks for 132 SMs, so the rows are also split into `n_slices` slices
// (grid.y), each block summing its slice.  With one slice the block adds
// its sums to `out` directly.  With more, each block writes its partial
// sums to the (S, M, F) scratch, and a second kernel sums the S partials of
// every (m, f) in slice order and adds the result to `out`.  No atomics:
// every sum runs in a fixed order, so a result does not change from run to
// run.  A group with no members, or only zero weights, adds exactly 0.
// Rows whose group id lies outside [0, M) add nothing.  Later work: more
// columns per thread (16-byte loads), TMA loads, the partial sums kept on
// chip in a thread-block cluster.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int ROWS = 16;     // rows loaded per step of the sum loop
constexpr int REDUCE = 256;  // threads per block of the slice reduction

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (column tiles, slices).  Block (i, s) sums rows
// [s * rows_per_slice, min((s + 1) * rows_per_slice, n_rows)) of columns
// [i * TILE, (i + 1) * TILE).  With n_slices == 1 it adds into out; else it
// writes partial[s] (an (M, F) slab of the scratch).
template <typename T>
__global__ void __launch_bounds__(TILE)
segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const int32_t* __restrict__ gid, float* __restrict__ out,
                   float* __restrict__ partial, int64_t n_rows, int64_t n_cols,
                   int n_groups, int64_t rows_per_slice, int n_slices) {
  extern __shared__ float acc[];              // [n_groups][TILE]
  const int t = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * TILE + t;
  const bool live = col < n_cols;
  const int64_t row0 = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t row1 = row0 + rows_per_slice < n_rows ? row0 + rows_per_slice : n_rows;

  for (int m = 0; m < n_groups; ++m) acc[m * TILE + t] = 0.f;
  // each thread touches only its own column of acc: no barrier needed

  // ROWS independent loads in flight per thread before the first add (see
  // segment_aggregate.cu: one warp per 32 columns leaves few warps per SM).
  for (int64_t n0 = row0; n0 < row1; n0 += ROWS) {
    float xv[ROWS], wv[ROWS];
    int gv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t n = n0 + u;
      const bool ok = n < row1;
      gv[u] = ok ? gid[n] : -1;
      wv[u] = ok ? w[n] : 0.f;
      xv[u] = (ok && live) ? to_f32(x[n * n_cols + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int g = gv[u];
      if (g < 0 || g >= n_groups) continue;
      acc[g * TILE + t] += wv[u] * xv[u];
    }
  }
  if (!live) return;
  if (n_slices == 1) {
    for (int m = 0; m < n_groups; ++m) out[m * n_cols + col] += acc[m * TILE + t];
  } else {
    float* p = partial + (int64_t)blockIdx.y * n_groups * n_cols;
    for (int m = 0; m < n_groups; ++m) p[m * n_cols + col] = acc[m * TILE + t];
  }
}

// out[i] += sum_{s = 0..S-1} partial[s][i], over the M * F entries, in
// slice order.
__global__ void __launch_bounds__(REDUCE)
sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int64_t n_entries, int n_slices) {
  const int64_t i = (int64_t)blockIdx.x * REDUCE + threadIdx.x;
  if (i >= n_entries) return;
  float s = 0.f;
  for (int k = 0; k < n_slices; ++k) s += partial[k * n_entries + i];
  out[i] += s;
}

template <typename T>
int launch(const void* x, const void* w, const void* gid, void* out, void* partial,
           int64_t n_rows, int64_t n_cols, int n_groups, int64_t rows_per_slice,
           int n_slices, cudaStream_t stream) {
  const size_t smem = (size_t)n_groups * TILE * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n_cols + TILE - 1) / TILE), (unsigned)n_slices);
  segment_sum_kernel<T><<<grid, TILE, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(gid), static_cast<float*>(out),
      static_cast<float*>(partial), n_rows, n_cols, n_groups, rows_per_slice, n_slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_slices == 1) return (int)e;
  const int64_t n_entries = (int64_t)n_groups * n_cols;
  sum_slices_kernel<<<(unsigned)((n_entries + REDUCE - 1) / REDUCE), REDUCE, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_entries, n_slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1);
// w: (n_rows,) fp32; gid: (n_rows,) int32; out: (n_groups, n_cols) fp32,
// added into; partial: (n_slices, n_groups, n_cols) fp32 scratch, unused
// (may be null) when n_slices == 1.  Rows are split into n_slices slices
// of rows_per_slice rows (the last may be shorter).  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int segment_sum(const void* x, const void* w, const void* gid, void* out,
                           void* partial, int64_t n_rows, int64_t n_cols, int n_groups,
                           int64_t rows_per_slice, int n_slices, int x_is_bf16, int device,
                           void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? launch<__nv_bfloat16>(x, w, gid, out, partial, n_rows, n_cols, n_groups,
                                     rows_per_slice, n_slices, s)
             : launch<float>(x, w, gid, out, partial, n_rows, n_cols, n_groups,
                             rows_per_slice, n_slices, s);
}
