// One-token GQA attention over a ring KV cache (the decode step), in fp32:
//
//   o[b, h] = sum_w softmax_w(q[b, h] . k[b, w, h / g] / sqrt(hd)) v[b, w, h / g]
//
// over the slots w that count: 0 <= slot_pos[w] <= pos and, with a window,
// pos - slot_pos[w] < window.  When no slot counts, every score is the
// finite NEG_INF and the softmax is uniform: o is the mean of v over all W
// slots, as in the reference.
//
// Replaces the TPU kernel decode_attention_bk
// (src/repro/kernels/decode_attention.py:66, wrapper
// src/repro/kernels/ops.py:187).
//
// Bound on the card: bytes.  Each slot that counts costs one K and one V
// row (2 * hd elements) and 4 * g * hd flops; at B = 2 and fp32 the
// full-width serving shapes read 8.4 MB (RecurrentGemma, a full 2,048-slot
// ring, 2.5 us at 3.35 TB/s) and 16.8 MB (ChatGLM3, 4,097 of 8,192 slots
// written, 5.0 us), for 2 to 4 flops per byte.
//
// Design.  The TPU kernel walks the W axis in order on one core, one grid
// row per (batch, KV head).  Here B * K is 2 to 4 at the serving shapes, so
// the slots are split across blocks too: grid (splits, B * K), each block
// taking a run of 32-slot tiles for all g query heads of its KV head.
//   Partial pass: the block copies its g query rows into shared memory
//     (rows padded to warps * ROWS with zeros) and, per tile, first reads
//     the 32 slot positions (one per lane).  A tile in which no slot counts
//     is skipped without loading K or V (every warp reads the same
//     positions, so the skip is uniform).  Otherwise the K and V rows of
//     the tile are copied into shared memory with cp.async, every copy of
//     the block in flight at once (row stride hd + 4, so the 8 lanes of a
//     quarter-warp reading their own rows as float4s fall on distinct
//     banks), and each warp runs FlashAttention's online softmax for ROWS
//     query heads, lane l scoring slot l, as csrc/flash_attention.cu does.
//     The block writes its unnormalised (m, l, acc[g, hd]) to a workspace;
//     a block that skipped every tile writes m = NEG_INF and no acc.
//   Combine pass: one block per (batch, query head).  It computes every
//     split's weight exp(m_i - max m) at once into shared memory; then its
//     warps take the splits in turn, each adding its splits' acc rows so
//     weighted, and the warps' sums are added in warp order: deterministic,
//     no atomics.  A skipped split (m_i = NEG_INF) weighs 0
//     and its acc is not read.  If every split skipped, no slot counts and
//     the block writes the mean of V over all W slots, summed the same way.
//     o = acc / max(l, 1e-30), as the reference.
// pos and slot_pos are read from device memory (the counterpart of the
// TPU kernel's scalar prefetch), so the decode step never waits on the
// host.  q and the caches are read in place through their strides; the
// ragged end of W is masked, not padded.  Later work: fewer, longer splits
// (the workspace costs g * hd floats per split), a prefetch of the next
// tile while this one is scored, bf16 caches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;           // slots per tile: one per lane
constexpr int MAX_WARPS = 4;
constexpr int MAX_HD = 256;
constexpr int COMBINE_WARPS = 8;
constexpr int MAX_SPLITS = 1024;
constexpr float NEG_INF = -2.0e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ void add4(float4& a, float w, float4 v) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}

// Asynchronous copy of 4 elements (16 bytes of fp32, 8 of bf16) from device
// memory into shared memory; cp_async_wait_all() waits for this thread's.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [r0, r0 + n) of an operand with row stride `rs` (in
// elements) into dst[n][ld]; rows at or past `rows_valid` are set to 0.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src, int64_t r0, int n,
                                                int64_t rows_valid, int64_t rs, int hd,
                                                int ld) {
  const int per_row = hd / 4;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = 4 * (i - r * per_row);
    if (r0 + r < rows_valid) {
      cp_async4(dst + r * ld + c, src + (r0 + r) * rs + c);
    } else {
      store4(dst + r * ld + c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// grid (splits, B * K); 32 * warps threads, warps * ROWS >= g; dynamic
// shared memory (warps * ROWS + 2 * TILE) * (hd + 4) elements of T.  NG:
// float4 column groups per lane (hd <= 128 * NG).  Workspace row r =
// (split * B * K + bk) * g + j holds acc[r][hd], m[r] and l[r].
template <typename T, int ROWS, int NG>
__global__ void __launch_bounds__(32 * MAX_WARPS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ slot_pos,
                      const int* __restrict__ pos_ptr, float* __restrict__ ws_m,
                      float* __restrict__ ws_l, float* __restrict__ ws_acc, int64_t W,
                      int64_t K, int g, int hd, int64_t tiles_per_split, int64_t q_sb,
                      int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                      int64_t v_ss, int64_t v_sh, int64_t sp_s, int64_t window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + 4;
  const int rows = (blockDim.x >> 5) * ROWS;
  T* qs = reinterpret_cast<T*>(smem_raw);   // [rows][ld]
  T* ks = qs + rows * ld;                   // [TILE][ld]
  T* vs = ks + TILE * ld;                   // [TILE][ld]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t bk = blockIdx.y;
  const int64_t b = bk / K;
  const int64_t kh = bk - b * K;
  const int64_t pos = *pos_ptr;
  const float sqrt_hd = sqrtf((float)hd);

  copy_rows_async<T>(qs, q + b * q_sb + kh * g * q_sh, 0, rows, g, q_sh, hd, ld);

  float m[ROWS], l[ROWS];
  float4 acc[ROWS][NG];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) acc[r][gi] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const T* qw = qs + warp * ROWS * ld;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  const int64_t n_tiles = (W + TILE - 1) / TILE;
  const int64_t t0 = blockIdx.x * tiles_per_split;
  const int64_t t1 = t0 + tiles_per_split < n_tiles ? t0 + tiles_per_split : n_tiles;

  for (int64_t t = t0; t < t1; ++t) {
    const int64_t slot = t * TILE + lane;
    bool valid = false;
    if (slot < W) {
      const int64_t sp = slot_pos[slot * sp_s];
      valid = sp >= 0 && sp <= pos && (window <= 0 || pos - sp < window);
    }
    if (!__any_sync(FULL, valid)) continue;      // the same answer in every warp
    __syncthreads();                             // the last tile is used up
    copy_rows_async<T>(ks, kb, t * TILE, TILE, W, k_ss, hd, ld);
    copy_rows_async<T>(vs, vb, t * TILE, TILE, W, v_ss, hd, ld);
    cp_async_wait_all();                         // (and the query rows)
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const T* kr = ks + lane * ld;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = load4(kr + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = load4(qw + r * ld + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // some lane of a visited tile counts, so each row's tile max is a real
    // score and the first visited tile wipes the initial (NEG_INF, 0, 0)
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sc = valid ? s[r] / sqrt_hd : NEG_INF;
      float mt = sc;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, w));
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);
      p[r] = expf(sc - m_new);
      l[r] = l[r] * alpha + p[r];
      m[r] = m_new;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        acc[r][gi].x *= alpha;
        acc[r][gi].y *= alpha;
        acc[r][gi].z *= alpha;
        acc[r][gi].w *= alpha;
      }
    }

#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, p[r], j);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int c = 4 * (lane + 32 * gi);
        if (c < hd) {
          const float4 vv = load4(vs + j * ld + c);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) add4(acc[r][gi], pj[r], vv);
        }
      }
    }
  }
  cp_async_wait_all();                           // the query rows, if no tile ran

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float lt = l[r];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) lt += __shfl_xor_sync(FULL, lt, w);
    const int j = warp * ROWS + r;
    if (j >= g) continue;
    const int64_t row = ((int64_t)blockIdx.x * gridDim.y + bk) * g + j;
    if (lane == 0) {
      ws_m[row] = m[r];
      ws_l[row] = lt;
    }
    if (m[r] == NEG_INF) continue;               // skipped every tile
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int c = 4 * (lane + 32 * gi);
      if (c < hd) store4(ws_acc + row * hd + c, acc[r][gi]);
    }
  }
}

// Block-wide reductions over COMBINE_WARPS warps, in a fixed order.
__device__ __forceinline__ float block_max(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, w));
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
#pragma unroll
  for (int w = 1; w < COMBINE_WARPS; ++w) x = fmaxf(x, scratch[w]);
  __syncthreads();
  return x;
}
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(FULL, x, w);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = 0.f;
#pragma unroll
  for (int w = 0; w < COMBINE_WARPS; ++w) x += scratch[w];
  return x;
}

// grid (B * K * g): one output row (b, query head) per block of
// COMBINE_WARPS warps.  The split weights exp(m_i - max m) are computed
// first, all splits at once, into shared memory (0 for a skipped split);
// then warp w adds the acc rows of splits w, w + COMBINE_WARPS, ..., lane l
// owning columns 4l..4l+3 and 128+4l..128+4l+3.
template <typename T>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
decode_combine_kernel(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                      const float* __restrict__ ws_acc, const T* __restrict__ v,
                      T* __restrict__ o, int64_t splits, int64_t n_rows, int g, int hd,
                      int64_t K, int64_t W, int64_t v_sb, int64_t v_ss, int64_t v_sh) {
  __shared__ __align__(16) float red[COMBINE_WARPS][MAX_HD];
  __shared__ float weight[MAX_SPLITS];
  __shared__ float scratch[COMBINE_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x;
  float M = NEG_INF;
  for (int64_t i = threadIdx.x; i < splits; i += blockDim.x) {
    weight[i] = ws_m[i * n_rows + row];
    M = fmaxf(M, weight[i]);
  }
  M = block_max(M, scratch);                    // (also orders weight[])

  float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  float L;
  if (M == NEG_INF) {                            // no slot counts anywhere
    const int64_t bk = row / g;
    const int64_t b = bk / K;
    const T* vb = v + b * v_sb + (bk - b * K) * v_sh;
    for (int64_t w = warp; w < W; w += COMBINE_WARPS) {
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int c = 4 * (lane + 32 * gi);
        if (c < hd) add4(a[gi], 1.f, load4(vb + w * v_ss + c));
      }
    }
    L = (float)W;
  } else {
    float lsum = 0.f;
    for (int64_t i = threadIdx.x; i < splits; i += blockDim.x) {
      const float mi = weight[i];
      const float wi = mi == NEG_INF ? 0.f : expf(mi - M);
      weight[i] = wi;
      if (wi != 0.f) lsum = fmaf(wi, ws_l[i * n_rows + row], lsum);
    }
    L = block_sum(lsum, scratch);               // (also orders weight[])
#pragma unroll 4
    for (int64_t i = warp; i < splits; i += COMBINE_WARPS) {
      const float wi = weight[i];
      if (wi == 0.f) continue;
      const float* ai = ws_acc + (i * n_rows + row) * hd;
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        const int c = 4 * (lane + 32 * gi);
        if (c < hd) add4(a[gi], wi, load4(ai + c));
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int c = 4 * (lane + 32 * gi);
    if (c < hd) store4(&red[warp][c], a[gi]);
  }
  __syncthreads();
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int c = 4 * threadIdx.x; c < hd; c += 4 * blockDim.x) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < COMBINE_WARPS; ++w) add4(s, 1.f, load4(&red[w][c]));
    store4(o + row * hd + c, make_float4(s.x * inv, s.y * inv, s.z * inv, s.w * inv));
  }
}

template <typename T, int ROWS, int NG>
int launch_partial(const T* q, const T* k, const T* v, const int* sp, const int* pos,
                   float* ws_m, float* ws_l, float* ws_acc, int64_t splits, int64_t BK,
                   int64_t W, int64_t K, int g, int hd, int64_t tiles_per_split,
                   const int64_t* st, int64_t window, cudaStream_t stream) {
  const int warps = (g + ROWS - 1) / ROWS;
  const size_t smem = (size_t)(warps * ROWS + 2 * TILE) * (hd + 4) * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(decode_partial_kernel<T, ROWS, NG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_partial_kernel<T, ROWS, NG><<<dim3((unsigned)splits, (unsigned)BK), 32 * warps,
                                       smem, stream>>>(
      q, k, v, sp, pos, ws_m, ws_l, ws_acc, W, K, g, hd, tiles_per_split, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], window);
  return (int)cudaGetLastError();
}

template <typename T, int NG>
int dispatch_rows(const T* q, const T* k, const T* v, const int* sp, const int* pos,
                  float* ws_m, float* ws_l, float* ws_acc, int64_t splits, int64_t BK,
                  int64_t W, int64_t K, int g, int hd, int64_t tiles_per_split,
                  const int64_t* st, int64_t window, cudaStream_t stream) {
  // the fewest query rows per warp that fit g rows into MAX_WARPS warps
  if (g <= MAX_WARPS)
    return launch_partial<T, 1, NG>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W, K,
                                    g, hd, tiles_per_split, st, window, stream);
  if (g <= 2 * MAX_WARPS)
    return launch_partial<T, 2, NG>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W, K,
                                    g, hd, tiles_per_split, st, window, stream);
  if (g <= 4 * MAX_WARPS)
    return launch_partial<T, 4, NG>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W, K,
                                    g, hd, tiles_per_split, st, window, stream);
  return launch_partial<T, 8, NG>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W, K, g,
                                  hd, tiles_per_split, st, window, stream);
}

template <typename T>
int run(const void* q_, const void* k_, const void* v_, const int* sp, const int* pos,
        void* o_, float* ws, int64_t splits, int64_t B, int64_t W, int64_t K, int g, int hd,
        int64_t tiles_per_split, const int64_t* st, int64_t window, cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const int64_t BK = B * K;
  const int64_t n_rows = BK * g;
  float* ws_acc = ws;                           // first: float4-aligned rows
  float* ws_m = ws_acc + splits * n_rows * hd;
  float* ws_l = ws_m + splits * n_rows;
  const int e = hd <= 128
                    ? dispatch_rows<T, 1>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W,
                                          K, g, hd, tiles_per_split, st, window, stream)
                    : dispatch_rows<T, 2>(q, k, v, sp, pos, ws_m, ws_l, ws_acc, splits, BK, W,
                                          K, g, hd, tiles_per_split, st, window, stream);
  if (e != 0) return e;
  if (splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  decode_combine_kernel<T><<<(unsigned)n_rows, 32 * COMBINE_WARPS, 0, stream>>>(
      ws_m, ws_l, ws_acc, v, static_cast<T*>(o_), splits, n_rows, g, hd, K, W, st[5], st[6],
      st[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, 1, H, hd) with (batch, head) strides q_sb, q_sh; k and v: (B, W,
// K, hd) with (batch, slot, head) strides; all with a contiguous last
// dimension, all fp32 (is_bf16 = 0) or all bf16 (1); hd a multiple of 4, at
// most 256; g = H / K at most 8 * 4 = 32; every stride a multiple of 4 and
// every pointer 16-byte aligned.  slot_pos: (W,) int32 with stride sp_s;
// pos: one int32, both in device memory.  o: (B, 1, H, hd) contiguous, of
// q's type.  ws: fp32 workspace of splits * B * K * g * (hd + 2) floats;
// the slots are cut into `splits` <= 1024 runs of tiles_per_split 32-slot
// tiles (splits * tiles_per_split * 32 >= W).  window <= 0 means no window.
// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* slot_pos, const void* pos, void* o, void* ws,
                                int64_t B, int64_t W, int64_t H, int64_t K, int64_t hd,
                                int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int64_t sp_s, int64_t window, int64_t splits,
                                int64_t tiles_per_split, int is_bf16, int device,
                                void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t st[9] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sp_s};
  const int* sp = static_cast<const int*>(slot_pos);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = (int)(H / K);
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, sp, p, o, w, splits, B, W, K, g, (int)hd,
                                      tiles_per_split, st, window, s)
                 : run<float>(q, k, v, sp, p, o, w, splits, B, W, K, g, (int)hd,
                              tiles_per_split, st, window, s);
}
