// Blocked online-softmax GQA attention with causal and sliding-window masks
// (FlashAttention's scheme), in fp32:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(hd)) v[b, j, h / g]
//
// over the keys j that query i sees: with p = i + offset (offset = Sk - Sq
// aligns the sequence ends), j < Sk, j <= p if causal, p - j < window if
// window > 0.
//
// Replaces the TPU kernel flash_attention_bkh
// (src/repro/kernels/flash_attention.py:89, wrapper src/repro/kernels/ops.py:57).
//
// Bound on the card: operations.  Each unmasked (query, key) pair costs
// 4 * hd flops (q . k and p * v), fp32 on the CUDA cores (the port computes
// in fp32 and TF32 would keep ~3 digits): 2.06e11 flops at the serving shape
// (B = 2, S = 4096, H = 16 over one KV head, hd = 256, window 2048) is
// 3.08 ms at 67 TFLOP/s, while its bytes (q and o 134 MB each, k and v
// 8.4 MB each) take 85 us.
//
// Design: one block of 256 threads per (64-row query tile, query head,
// batch).  The query tile stays in shared memory; key tiles of 32 rows
// (one key per lane) pass through one shared buffer, first as K, then as V.
// Each warp owns 8 query rows:
//   S = Q K^T: lane l scores its key against the warp's 8 rows, reading
//     the rows as broadcast float4s and its key row as a float4 (the row
//     stride hd + 4 keeps the 8 lanes of a quarter-warp on distinct banks);
//   online softmax: per row, the tile max by warp shuffles, then
//     alpha = exp(m_old - m_new), p = exp(s - m_new), each lane keeping its
//     own part of the row sum l;
//   O += P V: lane l owns columns 4l..4l+3 and 128+4l..128+4l+3 of the 8
//     rows (64 fp32 accumulators in registers); p of key j comes from lane
//     j by shuffle, V's row j as float4s.
// Masked scores are NEG_INF = -2e38, the reference's finite value, not
// -inf: in a visited tile a row whose keys are all masked gets
// exp(NEG_INF - NEG_INF) = 1 per key, which the row's first live tile wipes
// with alpha = exp(NEG_INF - m) = 0, as in the reference; -inf would make
// that row NaN.  Each block loops only over the key tiles that hold a key
// some row of it sees (from causal, window and offset): the counterpart of
// the reference's pl.when(live), without visiting the dead tiles.  The
// result is o = acc / max(l, 1e-30), as the reference's _finish.  q, k and
// v are read in place through their strides (last dimension contiguous);
// the ragged ends of Sq and Sk are masked, not padded.  Later work: several
// query heads of a KV group per block (with MQA all 16 heads read the same
// K/V tiles), larger per-thread score tiles, TMA / cp.async double
// buffering of the key tiles.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per tile: one per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
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

// rows [r0, r0 + n) of a (.., S, .., hd) operand, row stride `rs` (in
// elements), into dst[n][ld] as fp32; rows at or past `rows_valid` are 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t r0, int n,
                                          int64_t rows_valid, int64_t rs, int hd, int ld) {
  const int per_row = hd / 4;
  for (int i = threadIdx.x; i < n * per_row; i += THREADS) {
    const int r = i / per_row;
    const int c = 4 * (i - r * per_row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows_valid) v = load4(src + (r0 + r) * rs + c);
    store4(dst + r * ld + c, v);
  }
}

// grid (ceil(Sq / BQ), H, B); dynamic shared memory (BQ + BK) * (hd + 4)
// floats.  NG: float4 column groups per lane (hd <= 128 * NG).
template <typename T, int NG>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t Sq, int64_t Sk,
                       int64_t H, int64_t group, int hd, int64_t q_sb, int64_t q_ss,
                       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh, int causal, int64_t window,
                       int64_t offset) {
  extern __shared__ float smem[];
  const int ld = hd + 4;
  float* qs = smem;              // [BQ][ld]
  float* kvs = smem + BQ * ld;   // [BK][ld], K then V
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z;
  const int64_t h = blockIdx.y;
  const int64_t kh = h / group;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const float sqrt_hd = sqrtf((float)hd);

  // keys some row of this block sees
  const int64_t q_last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int64_t k_lo = 0, k_hi = Sk - 1;
  if (window > 0 && q0 + offset - window + 1 > k_lo) k_lo = q0 + offset - window + 1;
  if (causal && q_last + offset < k_hi) k_hi = q_last + offset;

  load_tile<T>(qs, q + b * q_sb + h * q_sh, q0, BQ, Sq, q_ss, hd, ld);

  float m[ROWS], l[ROWS];
  float4 acc[ROWS][NG];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) acc[r][gi] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* qw = qs + warp * ROWS * ld;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  for (int64_t kt = k_lo / BK; kt <= k_hi / BK && k_lo <= k_hi; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();                              // the last V tile is used up
    load_tile<T>(kvs, kb, k0, BK, Sk, k_ss, hd, ld);
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* kr = kvs + lane * ld;
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

    const int64_t key = k0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t pos = q0 + warp * ROWS + r + offset;
      bool live = key < Sk;
      if (causal) live = live && key <= pos;
      if (window > 0) live = live && pos - key < window;
      const float sc = live ? s[r] / sqrt_hd : NEG_INF;
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

    __syncthreads();                              // every warp is done with K
    load_tile<T>(kvs, vb, k0, BK, Sk, v_ss, hd, ld);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, p[r], j);
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int c = 4 * (lane + 32 * gi);
        if (c < hd) {
          const float4 vv = load4(kvs + j * ld + c);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc[r][gi].x = fmaf(pj[r], vv.x, acc[r][gi].x);
            acc[r][gi].y = fmaf(pj[r], vv.y, acc[r][gi].y);
            acc[r][gi].z = fmaf(pj[r], vv.z, acc[r][gi].z);
            acc[r][gi].w = fmaf(pj[r], vv.w, acc[r][gi].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float lt = l[r];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) lt += __shfl_xor_sync(FULL, lt, w);
    const int64_t row = q0 + warp * ROWS + r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    T* orow = o + ((b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int c = 4 * (lane + 32 * gi);
      if (c < hd) {
        const float4 a = acc[r][gi];
        store4(orow + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
      }
    }
  }
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Sk, int64_t H, int64_t K, int hd, const int64_t* st, int causal,
           int64_t window, int64_t offset, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + BK) * (hd + 4) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, NG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, NG><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, H / K, hd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], causal, window, offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
             int64_t Sk, int64_t H, int64_t K, int hd, const int64_t* st, int causal,
             int64_t window, int64_t offset, cudaStream_t stream) {
  return hd <= 128 ? launch<T, 1>(q, k, v, o, B, Sq, Sk, H, K, hd, st, causal, window,
                                  offset, stream)
                   : launch<T, 2>(q, k, v, o, B, Sq, Sk, H, K, hd, st, causal, window,
                                  offset, stream);
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, K, hd), each with its own (batch,
// sequence, head) strides in elements and a contiguous last dimension, all
// fp32 (is_bf16 = 0) or all bf16 (1); hd a multiple of 4, at most 256;
// every stride a multiple of 4 and every pointer 16-byte aligned; H a
// multiple of K.  o: (B, Sq, H, hd) contiguous, of q's type.  offset is the
// position of query row 0 (Sk - Sq aligns the ends); window <= 0 means no
// window.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t K,
                               int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                               int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                               int64_t v_ss, int64_t v_sh, int causal, int64_t window,
                               int64_t offset, int is_bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, K, (int)hd, st, causal,
                                           window, offset, s)
                 : dispatch<float>(q, k, v, o, B, Sq, Sk, H, K, (int)hd, st, causal, window,
                                   offset, s);
}
