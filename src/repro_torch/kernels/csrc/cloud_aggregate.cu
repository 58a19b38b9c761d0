// Cloud aggregation, eq. 10: the global weighted mean, broadcast back to
// every row.
//
//   out[n, f] = sum_i w[i] x[i, f] / sum_i w[i]      for every n
//
// No 1e-12 guard on the denominator, as in the JAX reference
// (src/repro/kernels/ref.py::hier_bcast_aggregate_ref): all-zero weights
// give NaN there and here, at every N.  (The TPU kernel falls through to
// the segment kernel for N > 512, which does apply the guard, so there
// all-zero weights give 0; off the TPU the JAX package takes the plain
// route, NaN like this kernel.)
//
// Replaces the TPU kernel hier_bcast_aggregate_2d
// (src/repro/kernels/hier_aggregate.py:117, wrapper src/repro/kernels/ops.py:116).
//
// Bound on the card: bytes, as for the edge event: 2 * N * F * 4 bytes /
// 3.35 TB/s (10.6 us at N = 100, F = 44,426); two flops per element read.
//
// Design: the edge kernel (segment_aggregate.cu) at one group, on
// segment_core.cuh.  One launch, one block per TILE = 128 columns and
// every row of those columns in the block; lanes hold 4 columns each in
// the core's spread layout, loaded 16, 8 or 4 bytes at a time as x's row
// length and address allow, each load of a warp 32 consecutive runs.  The
// warps split the rows and keep their sums in registers
// (seg::accumulate_one), write them to their shared-memory slots once,
// and after one barrier every warp adds the slots in warp order itself:
// the same bits in every warp, no atomics, the same result from run to
// run.  The mean then stays in the lane's registers while each warp writes
// its own rows, in stores as wide as the loads (out is a fresh contiguous
// tensor, so its rows are aligned as x's are or better), each store of a
// warp 32 consecutive runs.

#include "segment_core.cuh"

namespace {

using seg::TILE;

// `warps` warps a block (blockDim.x / 32); VEC elements a load and a store.
template <typename T, int VEC>
__global__ void __launch_bounds__(seg::MAX_THREADS)
cloud_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int64_t n_rows, int64_t n_cols) {
  __shared__ float4 sums[seg::MAX_WARPS][TILE / 4];
  __shared__ float weights[seg::MAX_WARPS];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * TILE + VEC * lane;
  const int live = seg::live_spread<VEC>(n_cols, col);

  // evict-first loads: 18.4 us against 19.2 us through the read-only path
  // at 100 x 44,426 (the write of out follows the read)
  seg::accumulate_one<T, VEC, true>(x, w, n_cols, col, live, warp, n_rows, warps,
                                    reinterpret_cast<float*>(sums[warp]), weights + warp);
  __syncthreads();
  const float4 s = seg::warp_order_sum(&sums[0][0], TILE / 4, warps, lane);
  const float d = seg::warp_order_sum(weights, 1, warps, 0);
  const float mean[4] = {s.x / d, s.y / d, s.z / d, s.w / d};
  for (int64_t n = warp; n < n_rows; n += warps) {
    float* p = out + n * n_cols + col;
#pragma unroll
    for (int i = 0; i < 4; i += VEC)
      if (i < live) seg::store<VEC>(p + seg::spread_offset<VEC>(i), mean + i);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int64_t n_rows, int64_t n_cols, int warps,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_cols + TILE - 1) / TILE);
  cloud_aggregate_kernel<T, VEC><<<blocks, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      n_rows, n_cols);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const void* w, void* out, int64_t n_rows,
               int64_t n_cols, int warps, cudaStream_t stream) {
  switch (vec) {
    case 4: return launch<T, 4>(x, w, out, n_rows, n_cols, warps, stream);
    case 2: return launch<T, 2>(x, w, out, n_rows, n_cols, warps, stream);
    case 1: return launch<T, 1>(x, w, out, n_rows, n_cols, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1), loaded
// `vec` elements at a time (4, 2 or 1: the row pitch and the address of x
// are multiples of vec elements); w: (n_rows,) fp32; out: (n_rows, n_cols)
// fp32, stored vec floats at a time (its address a multiple of 16 bytes);
// `warps` warps a block (1 to 16).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int cloud_aggregate(const void* x, const void* w, void* out, int64_t n_rows,
                               int64_t n_cols, int warps, int vec, int x_is_bf16, int device,
                               void* stream) {
  if (warps < 1 || warps > seg::MAX_WARPS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? launch_vec<__nv_bfloat16>(vec, x, w, out, n_rows, n_cols, warps, s)
             : launch_vec<float>(vec, x, w, out, n_rows, n_cols, warps, s);
}
