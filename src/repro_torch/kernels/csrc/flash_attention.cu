// Blocked online-softmax GQA attention with causal and sliding-window masks
// (FlashAttention's scheme), in fp32 on the CUDA cores (bf16 operands take
// flash_attention_bf16.cu, on the tensor cores):
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
// 4 * hd flops (q . k and p * v), fp32 outside the tensor cores at
// 67 TFLOP/s (the port computes in fp32, and TF32 keeps ~3 digits, short of
// the 2e-5 the kernel is held to).  At RecurrentGemma-9B's prefill (B = 2,
// S = 4096, 16 query heads over one KV head of 256, window 2048) that is
// 3.077 ms, at ChatGLM3-6B's (32 over 2 KV heads of 128, causal) 4.104 ms;
// their bytes take under 0.1 ms.
//
// What held the first version back (one block per 64 query rows of one
// query head, 256 threads, a lane per key; 10.011 and 14.375 ms at those
// shapes on an NVIDIA H100 80GB HBM3 at 700.00 W, 3.25 and 3.50 times the
// bound):
//   - shared-memory loads and shuffles, not FMAs, set the pace: in S = QK^T
//     each lane scored one key against 8 rows, ~3.6 FMAs per load; in P V
//     p came from lane j by __shfl_sync; the row max took 5 shuffles per row
//     and tile;
//   - one shared buffer held K and then V, filled synchronously, with four
//     __syncthreads per 32-key tile;
//   - __launch_bounds__(256, 2) capped a thread at 128 registers, and two
//     instantiations spilled;
//   - each query head was its own block, so the 16 heads of a KV group each
//     reloaded the same K/V tiles;
//   - at hd <= 64 half the lanes of P V idled (a lane owned 4 columns).
//
// What bounds a CUDA-core attention here: shared memory hands a thread at
// most 128 bytes per clock per SM, whether its lanes read one address or 32
// (a 16-byte load takes a wavefront per quarter-warp), while the FMA units
// take 128 FMAs per clock.  A lane therefore needs 4 FMAs per float it
// loads.  An outer product of a TR x TK lane tile does TR TK FMAs per
// TR + TK floats: 8 x 8 reaches it, 8 x 4 does 2/3 of it, 4 x 4 half.
//
// The design, and what each part answers:
//   - One block serves a (batch, KV head)'s whole query group: its R rows
//     are consecutive (position, head) pairs of the flattened (Sq, g) index
//     (R need not be a multiple of g), as the TPU kernel's (blk_q, g, hd)
//     blocks.  Each K/V tile is loaded once for all g heads.  The block's
//     live keys come from its first and last positions (causal, window,
//     offset); tiles outside them are never visited, and only the tiles at
//     the edges of that range are masked.  Blocks are issued heaviest first
//     (last positions first), so the short causal blocks fill the tail.
//   - Register tiles, no shuffles in the inner loops.  A row group of L
//     lanes shares TR rows; lane c of it owns keys c + L t of the 64-key
//     tile (TK = 64 / L) and columns 4 c + 4 L u of the output (hd / L), the
//     same rows in both products, so the softmax rescale stays in
//     registers.  hd <= 128: L = 16, TR = 8: S is 8 x 4 (2/3 of the FMA
//     rate from shared memory), O 8 x 8 (all of it, 64 accumulators);
//     hd = 256: L = 16, TR = 4: S 4 x 4, O 4 x 16; hd <= 64: L = 8, TR = 4.
//     S = Q K^T is an outer product over d, Q and K read as float4s along d;
//     P goes through a warp-private shared buffer, [key][row], each lane's
//     rows contiguous (float4s).  The row max takes log2(L) shuffles per row
//     and tile, run over all TR rows at once; each lane keeps its own part
//     of the row sum until the end.  Rows are padded to hd + 4 floats, so
//     the 8 keys or 8 column groups a quarter-warp reads fall on distinct
//     banks (Q and P reads are broadcasts).
//   - A pipelined K/V ring: a K and a V buffer, filled by 16-byte cp.async
//     copies (zero-filled past Sk and past hd).  V of tile t is in flight
//     while S of tile t is computed, K of tile t + 1 while P V of tile t is:
//     one __syncthreads per buffer and tile (two per 64 keys, where the
//     first version had four per 32).
//   - Instantiations by head dim, HD = 64, 128 or 256 (any hd that is a
//     multiple of 4 and at most 256 takes the smallest HD >= hd, its extra
//     columns zero), __launch_bounds__(256, 1): no spill (ptxas -v; 168,
//     244 and 196 registers).  At 8 warps a block takes 110,592, 176,128
//     and 224,256 bytes of shared memory: one block an SM.  The wrapper
//     picks the warps per block (1, 2, 4 or 8; 2 at least for HD = 256), so
//     that short prompts still give the card >= 132 blocks.
//
// Measured (chip_smoke.py phase 2, CUDA-event medians, L2 flushed; NVIDIA
// H100 80GB HBM3, 700.00 W): 5.728 ms at RecurrentGemma-9B's shape (1.86
// times the bound), 6.984 ms at ChatGLM3-6B's (1.70 times; SDPA with
// is_causal=True 6.106 ms), 16 us at StableLM-1.6B's CLI prefill.  Half
// the warps per block (4, one block an SM) take 8.067 and 8.832 ms at the
// two large shapes; at the CLI's shape (Sq = 64, g = 1) 8 warps leave half
// of each block's rows empty and are slower than the wrapper's 2 (phase 2
// times every count).
//
// Masked scores are NEG_INF = -2e38, the reference's finite value, not
// -inf: in a visited tile a row whose keys are all masked gets
// exp(NEG_INF - NEG_INF) = 1 per key, which the row's first live tile wipes
// with alpha = exp(NEG_INF - m) = 0, as in the reference; -inf would make
// that row NaN.  Scores are scaled by log2(e) / sqrt(hd) and exponentiated
// with exp2f, which is exp of the scaled scores.  The result is
// o = acc / max(l, 1e-30), as the reference's _finish.  q, k and v are read
// in place through their strides (last dimension contiguous).  No atomics:
// two launches agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;            // keys per tile
constexpr int MAX_THREADS = 256;
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The lane tiles of head-dim class HD: L lanes share a row group, each
// owning TR rows, TK = BK / L keys of S and TC = HD / (4 L) float4 columns
// of O; RPW rows a warp; LD the padded row (floats) of Q, K and V; PLD the
// row of a P buffer.
template <int HD> struct Tile {
  static constexpr int L = HD == 64 ? 8 : 16;
  static constexpr int TR = HD == 128 ? 8 : 4;
  static constexpr int TK = BK / L;
  static constexpr int TC = HD / (4 * L);
  static constexpr int RPW = 32 / L * TR;
  static constexpr int LD = HD + 4;
  static constexpr int PLD = RPW + 4;
  static constexpr int UNROLL_D = HD == 64 ? 2 : 4;
};

// Shared memory of a block of `warps` warps: Q [R][LD], a K and a V buffer
// [BK][LD], one P buffer [BK][PLD] per warp.
template <int HD>
constexpr size_t smem_bytes(int warps) {
  using C = Tile<HD>;
  return sizeof(float) * ((size_t)warps * C::RPW * C::LD + 2 * BK * C::LD +
                          (size_t)warps * BK * C::PLD);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 4 floats of src (if ok, else zeros) into dst by a 16-byte cp.async
// (zero-filled when !ok).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [k0, k0 + BK) of K or V (row stride ss) into dst [BK][LD]; rows past
// Sk and columns past hd are zeros.  A thread copies one 4-column group of
// every (blockDim.x / (HD / 4))-th row (blockDim.x is a multiple of HD / 4).
template <int HD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int64_t k0, int64_t Sk,
                                          int64_t ss, int hd) {
  constexpr int PER_ROW = HD / 4;
  const int c = 4 * (threadIdx.x % PER_ROW);
  const int step = blockDim.x / PER_ROW;
  for (int r = threadIdx.x / PER_ROW; r < BK; r += step) {
    const bool ok = k0 + r < Sk && c < hd;
    copy4(dst + r * Tile<HD>::LD + c, ok ? src + (k0 + r) * ss + c : src, ok);
  }
}

// grid: row_tiles * B * K blocks of 32 * warps threads; dynamic shared
// memory smem_bytes<HD>(warps).
template <int HD>
__global__ void __launch_bounds__(MAX_THREADS, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int64_t Sq, int64_t Sk,
                       int64_t H, int64_t K, int64_t group, int hd, int64_t row_tiles,
                       int64_t heads, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                       int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int causal, int64_t window, int64_t offset) {
  using C = Tile<HD>;
  constexpr int L = C::L, TR = C::TR, TK = C::TK, TC = C::TC, LD = C::LD, PLD = C::PLD;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int R = (blockDim.x >> 5) * C::RPW;
  float* const qs = smem;                        // [R][LD]
  float* const ks = qs + R * LD;                 // [BK][LD]: K of the tile
  float* const vs = ks + BK * LD;                // [BK][LD]: V of the tile
  float* const ps = vs + BK * LD;                // [warps][BK][PLD]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane / L;
  const int cg = lane % L;

  // heaviest row tiles (last positions) first
  const int64_t bk = blockIdx.x % heads;
  const int64_t tile = row_tiles - 1 - blockIdx.x / heads;
  const int64_t b = bk / K, kh = bk % K;
  const int64_t n_rows = Sq * group;
  const int64_t f0 = tile * R;
  const int64_t f_end = f0 + R < n_rows ? f0 + R : n_rows;

  // keys some row of this block sees
  int64_t k_lo = 0, k_hi = Sk - 1;
  if (window > 0 && f0 / group + offset - window + 1 > k_lo)
    k_lo = f0 / group + offset - window + 1;
  if (causal && (f_end - 1) / group + offset < k_hi) k_hi = (f_end - 1) / group + offset;
  const int64_t kt0 = k_lo / BK;
  const int n_tiles = k_lo <= k_hi ? (int)(k_hi / BK - kt0 + 1) : 0;
  // a tile whose keys every row of the block sees needs no mask
  const int64_t all_hi = causal ? f0 / group + offset : Sk - 1;
  const int64_t all_lo = window > 0 ? (f_end - 1) / group + offset - window + 1 : 0;

  const float* const qb = q + b * q_sb + kh * group * q_sh;
  const float* const kb = k + b * k_sb + kh * k_sh;
  const float* const vb = v + b * v_sb + kh * v_sh;
  {
    constexpr int PER_ROW = HD / 4;
    for (int i = threadIdx.x; i < R * PER_ROW; i += blockDim.x) {
      const int r = i / PER_ROW;
      const int c = 4 * (i % PER_ROW);
      const int64_t f = f0 + r;
      const bool ok = f < n_rows && c < hd;
      copy4(qs + r * LD + c, ok ? qb + (f / group) * q_ss + (f % group) * q_sh + c : qb, ok);
    }
  }
  if (n_tiles > 0) copy_tile<HD>(ks, kb, kt0 * BK, Sk, k_ss, hd);
  cp_async_commit();

  const int row0 = warp * C::RPW + rg * TR;      // this lane's rows: row0 + i
  int pos[TR];                                   // positions fit an int (wrapper)
  float m[TR], l[TR];
  float4 acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    pos[i] = (int)((f0 + row0 + i) / group + offset);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < TC; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float scale = LOG2E / sqrtf((float)hd);
  const float* const qr = qs + row0 * LD;
  const float* const kr = ks + cg * LD;
  const float* const vr = vs + 4 * cg;
  float* const pw = ps + warp * BK * PLD + rg * TR;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t k0 = (kt0 + it) * BK;
    cp_async_wait_all();
    __syncthreads();            // K landed; every warp is done with the last V
    copy_tile<HD>(vs, vb, k0, Sk, v_ss, hd);
    cp_async_commit();

    // S = Q K^T on this lane's TR rows x TK keys (keys cg + L t)
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int t = 0; t < TK; ++t) s[i][t] = 0.f;
#pragma unroll C::UNROLL_D
    for (int d = 0; d < HD; d += 4) {
      float4 kf[TK];
#pragma unroll
      for (int t = 0; t < TK; ++t) kf[t] = lds4(kr + t * L * LD + d);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 qf = lds4(qr + i * LD + d);
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          s[i][t] = fmaf(qf.x, kf[t].x, s[i][t]);
          s[i][t] = fmaf(qf.y, kf[t].y, s[i][t]);
          s[i][t] = fmaf(qf.z, kf[t].z, s[i][t]);
          s[i][t] = fmaf(qf.w, kf[t].w, s[i][t]);
        }
      }
    }

    // online softmax; masks only on the tiles at the edges of the block's
    // key range.  Each step runs over all TR rows, so they overlap.
    if (k0 < all_lo || k0 + BK - 1 > all_hi) {
      const int key0 = (int)k0 + cg;
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const int key = key0 + t * L;
          bool live = key < Sk;
          if (causal) live = live && key <= pos[i];
          if (window > 0) live = live && pos[i] - key < window;
          s[i][t] = live ? s[i][t] * scale : NEG_INF;
        }
    } else {
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int t = 0; t < TK; ++t) s[i][t] *= scale;
    }
    float mt[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      mt[i] = s[i][0];
#pragma unroll
      for (int t = 1; t < TK; ++t) mt[i] = fmaxf(mt[i], s[i][t]);
    }
#pragma unroll
    for (int w = 1; w < L; w <<= 1)
#pragma unroll
      for (int i = 0; i < TR; ++i) mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL, mt[i], w));
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float m_new = fmaxf(m[i], mt[i]);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float ls = 0.f;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        s[i][t] = exp2f(s[i][t] - m_new);
        ls += s[i][t];
      }
      l[i] = l[i] * alpha + ls;
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        acc[i][u].x *= alpha;
        acc[i][u].y *= alpha;
        acc[i][u].z *= alpha;
        acc[i][u].w *= alpha;
      }
    }
    // P into the warp's buffer, [key][row]: this lane's rows are contiguous
#pragma unroll
    for (int t = 0; t < TK; ++t)
#pragma unroll
      for (int i = 0; i < TR; i += 4)
        store4(pw + (cg + t * L) * PLD + i,
               make_float4(s[i][t], s[i + 1][t], s[i + 2][t], s[i + 3][t]));

    cp_async_wait_all();
    __syncthreads();            // V landed; every warp is done with K (and P is written)
    if (it + 1 < n_tiles) copy_tile<HD>(ks, kb, k0 + BK, Sk, k_ss, hd);
    cp_async_commit();

    // O += P V on this lane's TR rows x 4 TC columns (columns 4 cg + 4 L u)
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pj[TR];
#pragma unroll
      for (int i = 0; i < TR; i += 4) {
        const float4 p4 = lds4(pw + j * PLD + i);
        pj[i] = p4.x;
        pj[i + 1] = p4.y;
        pj[i + 2] = p4.z;
        pj[i + 3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        const float4 vf = lds4(vr + j * LD + 4 * L * u);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          acc[i][u].x = fmaf(pj[i], vf.x, acc[i][u].x);
          acc[i][u].y = fmaf(pj[i], vf.y, acc[i][u].y);
          acc[i][u].z = fmaf(pj[i], vf.z, acc[i][u].z);
          acc[i][u].w = fmaf(pj[i], vf.w, acc[i][u].w);
        }
      }
    }
  }
  cp_async_wait_all();                           // the query rows, if no tile ran

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int w = 1; w < L; w <<= 1) lt += __shfl_xor_sync(FULL, lt, w);
    const int64_t f = f0 + row0 + i;
    if (f >= n_rows) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    float* const orow = o + ((b * Sq + f / group) * H + kh * group + f % group) * hd;
#pragma unroll
    for (int u = 0; u < TC; ++u) {
      const int c = 4 * cg + 4 * L * u;
      if (c < hd) {
        const float4 a = acc[i][u];
        store4(orow + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Sk, int64_t H, int64_t K, int hd, const int64_t* st, int causal,
           int64_t window, int64_t offset, int warps, cudaStream_t stream) {
  if (32 * warps < HD / 4) return (int)cudaErrorInvalidValue;  // see copy_tile
  const size_t smem = smem_bytes<HD>(warps);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)warps * Tile<HD>::RPW;
  const int64_t row_tiles = (Sq * (H / K) + rows - 1) / rows;
  const int64_t blocks = row_tiles * B * K;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<HD><<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, K, H / K, hd, row_tiles, B * K, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], causal, window, offset);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
             int64_t Sk, int64_t H, int64_t K, int hd, const int64_t* st, int causal,
             int64_t window, int64_t offset, int warps, cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, K, hd, st, causal, window, offset, warps,
                         stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, K, hd, st, causal, window, offset, warps,
                          stream);
  return launch<256>(q, k, v, o, B, Sq, Sk, H, K, hd, st, causal, window, offset, warps,
                        stream);
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, K, hd), each with its own (batch,
// sequence, head) strides in elements and a contiguous last dimension, all
// fp32; hd a multiple of 4, at most 256;
// every stride a multiple of 4 and every pointer 16-byte aligned; H a
// multiple of K.  o: (B, Sq, H, hd) contiguous fp32.  offset is the
// position of query row 0 (Sk - Sq aligns the ends); window <= 0 means no
// window.  warps: 1, 2, 4 or 8 warps per block (the block's rows are
// warps * RPW (query position, head) pairs: RPW = 32, 16, 8 at hd <= 64,
// <= 128, <= 256).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o,
                               int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t K,
                               int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                               int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                               int64_t v_ss, int64_t v_sh, int causal, int64_t window,
                               int64_t offset, int warps, int device, void* stream) {
  if (warps != 1 && warps != 2 && warps != 4 && warps != 8)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(q, k, v, o, B, Sq, Sk, H, K, (int)hd, st, causal, window, offset, warps, s);
}
