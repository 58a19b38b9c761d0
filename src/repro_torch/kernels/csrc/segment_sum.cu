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
// client-block grid axis.  Here membership is read from group_ids directly
// and the sums are segment_core.cuh's: a block owns TILE = 128 columns
// (4 a lane, 8- or 16-byte loads where x allows), its warps split the rows
// and add into per-warp slots that are then summed in warp order.  One
// launch per call: at the streaming shape (8192 x 1024) the column tiles
// give only 8 blocks, so the rows are also split into `n_slices` slices
// (grid.y), about one block per SM in all.  With one slice the block adds
// its sums to `out` directly.  With more, each block writes its sums to its
// (M, TILE) entry of the `partial` workspace and counts itself in on its
// tile's counter; the block that counts last adds the tile's S partials in
// slice order, adds the result to `out` and puts the counter back to 0.
// No float atomics: every sum runs in a fixed order, so a result does not
// change from run to run.  A group with no members, or only zero weights,
// adds exactly 0.  Rows whose group id lies outside [0, M) add nothing.

#include "segment_core.cuh"

namespace {

using seg::TILE;

// out[m, col0 + c .. c + 3] += s for the float4 i = m * TILE / 4 + c / 4 of
// a tile's (M, TILE) sums, the columns past `width` left out.
__device__ __forceinline__ void add_to_out(float* __restrict__ out, int64_t n_cols,
                                           int64_t col0, int width, int i, float4 s) {
  const int m = i / (TILE / 4), c = 4 * (i % (TILE / 4));
  float* p = out + m * n_cols + col0 + c;
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < width) p[j] += v[j];
}

// grid (column tiles, slices), `warps` warps a block.  Block (i, s) sums
// rows [s * rows_per_slice, min((s + 1) * rows_per_slice, n_rows)) of
// columns [i * TILE, (i + 1) * TILE).
template <typename T, int VEC>
__global__ void __launch_bounds__(seg::MAX_THREADS)
segment_sum_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const int32_t* __restrict__ gid, float* __restrict__ out,
                   float* __restrict__ partial, int* __restrict__ counters, int64_t n_rows,
                   int64_t n_cols, int n_groups, int64_t rows_per_slice, int n_slices) {
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);   // [warps][n_groups][TILE]
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int entries = n_groups * TILE;
  const int64_t col0 = (int64_t)blockIdx.x * TILE;
  const int64_t row0 = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t row1 = row0 + rows_per_slice < n_rows ? row0 + rows_per_slice : n_rows;

  // The tile's lines of `out`, which the block that adds into it reads
  // last, are asked for while x streams in.
  if (blockIdx.y == 0)
    for (int l = threadIdx.x; l < n_groups * (TILE / 32); l += blockDim.x) {
      const int64_t c = col0 + 32 * (l % (TILE / 32));
      if (c < n_cols) seg::prefetch_l2(out + (l / (TILE / 32)) * n_cols + c);
    }
  seg::accumulate<T, VEC>(x, w, gid, n_cols, col0 + 4 * lane,
                          seg::live_columns(n_cols, col0 + 4 * lane), row0 + warp, row1, warps,
                          n_groups, slots + warp * entries, nullptr);
  __syncthreads();

  const int width = n_cols - col0 < TILE ? (int)(n_cols - col0) : TILE;
  const int entries4 = entries / 4;
  const float4* slots4 = reinterpret_cast<const float4*>(slots);
  if (n_slices == 1) {
    for (int i = threadIdx.x; i < entries4; i += blockDim.x)
      add_to_out(out, n_cols, col0, width, i, seg::warp_order_sum(slots4, entries4, warps, i));
    return;
  }

  float4* tile_partials = reinterpret_cast<float4*>(partial) + (int64_t)blockIdx.x * n_slices * entries4;
  for (int i = threadIdx.x; i < entries4; i += blockDim.x)
    __stcg(tile_partials + (int64_t)blockIdx.y * entries4 + i,
           seg::warp_order_sum(slots4, entries4, warps, i));
  __threadfence();                    // (releases this block's partial)
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) last = atomicAdd(counters + blockIdx.x, 1) == n_slices - 1;
  if (!__syncthreads_or(last)) return;
  // The other slices' partials, fenced before they counted, are read from
  // the L2 (__ldcg), past this SM's L1.
  for (int i = threadIdx.x; i < entries4; i += blockDim.x)
    add_to_out(out, n_cols, col0, width, i,
               seg::slice_order_sum<16>(tile_partials + i, entries4, n_slices));
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* gid, void* out, void* partial,
           void* counters, int64_t n_rows, int64_t n_cols, int n_groups,
           int64_t rows_per_slice, int n_slices, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)warps * n_groups * TILE * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n_cols + TILE - 1) / TILE), (unsigned)n_slices);
  segment_sum_kernel<T, VEC><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(gid), static_cast<float*>(out),
      static_cast<float*>(partial), static_cast<int*>(counters), n_rows, n_cols, n_groups,
      rows_per_slice, n_slices);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const void* w, const void* gid, void* out,
               void* partial, void* counters, int64_t n_rows, int64_t n_cols, int n_groups,
               int64_t rows_per_slice, int n_slices, int warps, cudaStream_t stream) {
  switch (vec) {
    case 4: return launch<T, 4>(x, w, gid, out, partial, counters, n_rows, n_cols, n_groups,
                                rows_per_slice, n_slices, warps, stream);
    case 2: return launch<T, 2>(x, w, gid, out, partial, counters, n_rows, n_cols, n_groups,
                                rows_per_slice, n_slices, warps, stream);
    case 1: return launch<T, 1>(x, w, gid, out, partial, counters, n_rows, n_cols, n_groups,
                                rows_per_slice, n_slices, warps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (n_rows, n_cols) row-major, fp32 (x_is_bf16 = 0) or bf16 (1), loaded
// `vec` elements at a time (4, 2 or 1: the row pitch and the address of x
// are multiples of vec elements); w: (n_rows,) fp32; gid: (n_rows,) int32;
// out: (n_groups, n_cols) fp32, added into.  Rows are split into n_slices
// slices of rows_per_slice rows (the last may be shorter), `warps` warps a
// block (1 to 16).  With n_slices > 1: partial, at least (column tiles *
// n_slices * n_groups * 128) fp32 of workspace, and counters, one int32 a
// column tile, 0 before the launch and 0 again after it; both unused (may
// be null) when n_slices == 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_sum(const void* x, const void* w, const void* gid, void* out,
                           void* partial, void* counters, int64_t n_rows, int64_t n_cols,
                           int n_groups, int64_t rows_per_slice, int n_slices, int warps, int vec,
                           int x_is_bf16, int device, void* stream) {
  if (warps < 1 || warps > seg::MAX_WARPS) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? launch_vec<__nv_bfloat16>(vec, x, w, gid, out, partial, counters, n_rows, n_cols,
                                         n_groups, rows_per_slice, n_slices, warps, s)
             : launch_vec<float>(vec, x, w, gid, out, partial, counters, n_rows, n_cols,
                                 n_groups, rows_per_slice, n_slices, warps, s);
}
