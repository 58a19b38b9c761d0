// RG-LRU linear recurrence (RecurrentGemma eq. 3) over (B, S, D):
//
//   h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + b[b, t, d],   h[b, -1, d] = 0
//
// Replaces the TPU kernel rglru_scan_blocked
// (src/repro/kernels/rglru_scan.py:41, wrapper src/repro/kernels/ops.py:87).
//
// Bound on the card: bytes.  a and b are read once and h written once,
// 3 * B * S * D * 4 bytes for fp32 (403 MB at B = 2, S = 4096, D = 4096:
// 120 us at 3.35 TB/s); one FMA per element.
//
// Design: the TPU kernel walked (batch, channel block, sequence block) with
// the sequence innermost and carried h across sequence blocks in VMEM.  On
// Hopper the blocks run in no order, so a thread owns one (batch, channel)
// chain and walks the time steps itself; neighbouring threads sit on
// neighbouring channels, so every load and store of a warp is one 128-byte
// line.  The loads of a_t and b_t do not depend on h: each thread keeps the
// next UNROLL steps' loads in flight while it runs the FMA chain of the
// current UNROLL steps.  One chain per (batch, channel) is only B * D
// threads (8,192 at the serving shape, 2 warps per SM), each with an
// S-step chain, so the sequence is also cut into `n_chunks` chunks, as the
// reference's rglru_scan_chunked (src/repro/models/recurrent.py:78) does:
//   1. chunk_summary_kernel: each (batch, chunk, channel) thread runs its
//      chunk from h = 0 and writes the chunk's final h and the product of
//      its a's (the chunk as one affine map h -> A h + H);
//   2. scan_kernel: each thread folds the maps of the chunks before its
//      own into its entry state (a short sequential loop over at most
//      n_chunks - 1 carries) and runs its chunk again from there, writing h.
// With n_chunks = 1 only scan_kernel runs, from h = 0.  a and b are read
// twice when n_chunks > 1 (5 passes of B * S * D instead of 3) in exchange
// for n_chunks times the threads.  No atomics: a result does not change
// from run to run.  Ragged D and S are masked, not padded.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;    // channels (threads) per block
constexpr int UNROLL = 16;   // time steps loaded ahead per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Runs h through steps [t0, t1) of one (batch, channel) chain whose element
// t sits at a[t * D], b[t * D].  Writes h to out[t * D] when out is not
// null; multiplies each a into *prod when prod is not null.
template <typename T>
__device__ __forceinline__ float walk(const T* __restrict__ a, const T* __restrict__ b,
                                      float* __restrict__ out, float* prod, float h,
                                      int64_t t0, int64_t t1, int64_t D) {
  float an[UNROLL], bn[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t t = t0 + u;
    an[u] = t < t1 ? to_f32(a[t * D]) : 0.f;
    bn[u] = t < t1 ? to_f32(b[t * D]) : 0.f;
  }
  float p = 1.f;
  for (int64_t g = t0; g < t1; g += UNROLL) {
    float ac[UNROLL], bc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {   // the next group, in flight meanwhile
      const int64_t t = g + UNROLL + u;
      an[u] = t < t1 ? to_f32(a[t * D]) : 0.f;
      bn[u] = t < t1 ? to_f32(b[t * D]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (g + u < t1) {
        h = fmaf(ac[u], h, bc[u]);
        if (out != nullptr) out[(g + u) * D] = h;
        p *= ac[u];
      }
    }
  }
  if (prod != nullptr) *prod = p;
  return h;
}

// grid (channel tiles, n_chunks - 1, B): chunk c's map h -> A h + H.
// carry_h, carry_a: (B, n_chunks, D); the last chunk's slot is unused.
template <typename T>
__global__ void __launch_bounds__(TILE)
chunk_summary_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ carry_h, float* __restrict__ carry_a,
                     int64_t S, int64_t D, int64_t chunk_len, int n_chunks) {
  const int64_t d = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (d >= D) return;
  const int64_t bi = blockIdx.z;
  const int c = blockIdx.y;
  const int64_t t0 = (int64_t)c * chunk_len;
  const int64_t t1 = t0 + chunk_len < S ? t0 + chunk_len : S;
  const int64_t base = bi * S * D + d;
  float prod;
  const float h = walk<T>(a + base, b + base, nullptr, &prod, 0.f, t0, t1, D);
  const int64_t slot = (bi * n_chunks + c) * D + d;
  carry_h[slot] = h;
  carry_a[slot] = prod;
}

// grid (channel tiles, n_chunks, B): chunk c from its entry state.
template <typename T>
__global__ void __launch_bounds__(TILE)
scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ out,
            const float* __restrict__ carry_h, const float* __restrict__ carry_a,
            int64_t S, int64_t D, int64_t chunk_len, int n_chunks) {
  const int64_t d = (int64_t)blockIdx.x * TILE + threadIdx.x;
  if (d >= D) return;
  const int64_t bi = blockIdx.z;
  const int c = blockIdx.y;
  float h = 0.f;
  for (int k = 0; k < c; ++k) {
    const int64_t slot = (bi * n_chunks + k) * D + d;
    h = fmaf(carry_a[slot], h, carry_h[slot]);
  }
  const int64_t t0 = (int64_t)c * chunk_len;
  const int64_t t1 = t0 + chunk_len < S ? t0 + chunk_len : S;
  const int64_t base = bi * S * D + d;
  walk<T>(a + base, b + base, out + base, nullptr, h, t0, t1, D);
}

template <typename T>
int launch(const void* a, const void* b, void* out, void* carry_h, void* carry_a,
           int64_t B, int64_t S, int64_t D, int64_t chunk_len, int n_chunks,
           cudaStream_t stream) {
  const unsigned tiles = (unsigned)((D + TILE - 1) / TILE);
  if (n_chunks > 1) {
    chunk_summary_kernel<T><<<dim3(tiles, n_chunks - 1, (unsigned)B), TILE, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(carry_h),
        static_cast<float*>(carry_a), S, D, chunk_len, n_chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<T><<<dim3(tiles, n_chunks, (unsigned)B), TILE, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(out),
      static_cast<const float*>(carry_h), static_cast<const float*>(carry_a), S, D,
      chunk_len, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (B, S, D) contiguous, fp32 (is_bf16 = 0) or bf16 (1); out: (B, S, D)
// fp32; carry_h, carry_a: (B, n_chunks, D) fp32 scratch, unused (may be
// null) when n_chunks == 1.  The sequence is cut into n_chunks chunks of
// chunk_len steps (the last may be shorter; n_chunks * chunk_len >= S).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan(const void* a, const void* b, void* out, void* carry_h,
                          void* carry_a, int64_t B, int64_t S, int64_t D, int64_t chunk_len,
                          int n_chunks, int is_bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, b, out, carry_h, carry_a, B, S, D, chunk_len,
                                         n_chunks, s)
                 : launch<float>(a, b, out, carry_h, carry_a, B, S, D, chunk_len, n_chunks,
                                 s);
}
