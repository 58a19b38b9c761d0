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
// Design: the streaming segment sum (segment_sum.cu) at one group, on
// segment_core.cuh, divided by the weights' sum.  One launch: a grid of
// TILE = 128-column tiles x row slices (the wrapper's weighted_mean_plan
// picks the slices and the warps a block so that the grid is one wave of
// the warps an SM holds); lanes hold 4 columns each in the core's spread
// layout, loaded 16, 8 or 4 bytes at a time as x's row length and address
// allow, each load of a warp 32 consecutive runs; the block's warps
// split the slice's rows, keep their sums in registers
// (seg::accumulate_one) and write them to shared memory once; warp 0 adds
// them in warp order.  With one slice it writes sum / weight sum.  With
// more, it writes the slice's (TILE,) sums and its weight sum to its entry
// of the `partial` workspace and counts itself in on its tile's counter;
// the block that counts last adds the tile's S entries in slice order,
// divides, writes the mean and puts the counter back to 0.  No float
// atomics: every sum runs in a fixed order, so a result does not change
// from run to run.

#include "segment_core.cuh"

namespace {

using seg::TILE;

// A workspace entry: a slice's TILE sums, then a float4 whose x is the
// slice's weight sum.
constexpr int ENTRY4 = TILE / 4 + 1;

// grid (column tiles, slices), `warps` warps a block (blockDim.x / 32).
// Block (i, s) sums rows [s * rows_per_slice, min((s + 1) * rows_per_slice,
// n_rows)) of columns [i * TILE, (i + 1) * TILE).
template <typename T, int VEC>
__global__ void __launch_bounds__(seg::MAX_THREADS)
weighted_mean_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, float4* __restrict__ partial,
                     int* __restrict__ counters, int64_t n_rows, int64_t n_cols,
                     int64_t rows_per_slice, int n_slices) {
  __shared__ float4 sums[seg::MAX_WARPS][TILE / 4];
  __shared__ float weights[seg::MAX_WARPS];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col = (int64_t)blockIdx.x * TILE + VEC * lane;
  const int live = seg::live_spread<VEC>(n_cols, col);
  const int64_t row0 = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t row1 = row0 + rows_per_slice < n_rows ? row0 + rows_per_slice : n_rows;

  // loads through the read-only path: 965 us against 994 us evict-first at
  // a 16,384 x 44,426 fp32 shard
  seg::accumulate_one<T, VEC, false>(x, w, n_cols, col, live, row0 + warp, row1, warps,
                                     reinterpret_cast<float*>(sums[warp]), weights + warp);
  __syncthreads();
  if (warp != 0) return;                  // warp 0 finishes the block alone
  float4 s = seg::warp_order_sum(&sums[0][0], TILE / 4, warps, lane);
  float d = seg::warp_order_sum(weights, 1, warps, 0);

  if (n_slices > 1) {
    float4* tile = partial + (int64_t)blockIdx.x * n_slices * ENTRY4;
    float4* mine = tile + (int64_t)blockIdx.y * ENTRY4;
    __stcg(mine + lane, s);
    if (lane == 0) __stcg(mine + TILE / 4, make_float4(d, 0.f, 0.f, 0.f));
    __threadfence();                      // (releases this block's entry)
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(counters + blockIdx.x, 1) == n_slices - 1;
    if (!__shfl_sync(seg::FULL, last, 0)) return;
    // The other slices' entries, fenced before they counted, are read from
    // the L2 (__ldcg in slice_order_sum), past this SM's L1; 8 loads in
    // flight, not K4's 16, keep the kernel within 64 registers.
    s = seg::slice_order_sum<8>(tile + lane, ENTRY4, n_slices);
    d = seg::slice_order_sum<8>(reinterpret_cast<const float*>(tile + TILE / 4), 4 * ENTRY4,
                                n_slices);
    if (lane == 0) counters[blockIdx.x] = 0;
  }
  const float v[4] = {s.x / d, s.y / d, s.z / d, s.w / d};
#pragma unroll
  for (int i = 0; i < 4; i += VEC)
    if (i < live) seg::store<VEC>(out + col + seg::spread_offset<VEC>(i), v + i);
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, void* partial, void* counters,
           int64_t n_rows, int64_t n_cols, int64_t rows_per_slice, int n_slices, int warps,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((n_cols + TILE - 1) / TILE), (unsigned)n_slices);
  weighted_mean_kernel<T, VEC><<<grid, 32 * warps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      static_cast<float4*>(partial), static_cast<int*>(counters), n_rows, n_cols,
      rows_per_slice, n_slices);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const void* w, void* out, void* partial, void* counters,
               int64_t n_rows, int64_t n_cols, int64_t rows_per_slice, int n_slices, int warps,
               cudaStream_t stream) {
  switch (vec) {
    case 4: return launch<T, 4>(x, w, out, partial, counters, n_rows, n_cols, rows_per_slice,
                                n_slices, warps, stream);
    case 2: return launch<T, 2>(x, w, out, partial, counters, n_rows, n_cols, rows_per_slice,
                                n_slices, warps, stream);
    case 1: return launch<T, 1>(x, w, out, partial, counters, n_rows, n_cols, rows_per_slice,
                                n_slices, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1), loaded
// `vec` elements at a time (4, 2 or 1: the row pitch and the address of x
// are multiples of vec elements); w: (n_rows,) fp32; out: (n_cols,) fp32,
// stored vec floats at a time (its address a multiple of 16 bytes).  Rows
// are split into n_slices slices of rows_per_slice rows (the last may be
// shorter), `warps` warps a block (1 to 16).  With n_slices > 1: partial,
// at least (column tiles * n_slices * 132) fp32 of workspace, 16-byte
// aligned, and counters, one int32 a column tile, 0 before the launch and
// 0 again after it; both unused (may be null) when n_slices == 1.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int weighted_mean(const void* x, const void* w, void* out, void* partial,
                             void* counters, int64_t n_rows, int64_t n_cols,
                             int64_t rows_per_slice, int n_slices, int warps, int vec,
                             int x_is_bf16, int device, void* stream) {
  if (warps < 1 || warps > seg::MAX_WARPS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_vec<__nv_bfloat16>(vec, x, w, out, partial, counters, n_rows,
                                               n_cols, rows_per_slice, n_slices, warps, s)
                   : launch_vec<float>(vec, x, w, out, partial, counters, n_rows, n_cols,
                                       rows_per_slice, n_slices, warps, s);
}
