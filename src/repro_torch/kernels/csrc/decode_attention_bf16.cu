// One-token GQA attention over a ring KV cache (the decode step) for bf16
// operands, on Hopper's TMA and tensor cores:
//
//   o[b, h] = sum_w softmax_w(q[b, h] . k[b, w, h / g] / sqrt(hd)) v[b, w, h / g]
//
// over the slots w that count: 0 <= slot_pos[w] <= pos and, with a window,
// pos - slot_pos[w] < window.  When no slot counts, every score is the
// finite NEG_INF and the softmax is uniform: o is the mean of v over all W
// slots, as in the reference.  The fp32 path is decode_attention.cu.
//
// Replaces the TPU kernel decode_attention_bk
// (src/repro/kernels/decode_attention.py:66, wrapper
// src/repro/kernels/ops.py:187) for bf16 inputs, which that kernel casts
// to fp32 before both products.
//
// Bound on the card: bytes.  The K and V rows of the slots that count, q and
// o, at 3.35 TB/s: at InternVL2-26B's decode (B = 2, 4,097 of 8,192 slots,
// 48 query heads over 8 KV heads of 128) 33,644,548 bytes, 10.04 us.  A
// slot costs 4 g hd flops for 4 hd bytes: 6 flops a byte at g = 6, against
// the 295 at which the bf16 tensor cores would be the limit.  So wgmma,
// whose 64-row tiles would be 58 of 64 rows padding at g = 6, buys nothing
// here: the products are mma.sync m16n8k16 on 16 rows.
//
// What held the kernel that ran bf16 before back (decode_attention.cu, the
// fp32 design with its operands converted; a one-off probe on an NVIDIA
// H100 80GB HBM3 at 700 W, PERF.md): 48.0 us at InternVL2's shape.
// At one split a counted tile of 32 slots cost 2.56 us: its K and V rows
// copied one bulk copy a row by one warp (1.99 us a tile alone), and its
// split-TF32 products, scored by 8 warps that met at three block barriers
// a tile (1.57 us alone); the launch, the slot masks and the merge of the
// splits 12.8 us of the 48.
//
// Design, one launch per call (grid: splits x B K ceil(g / 16); a block
// serves 16 query heads of a group, so g above 16 takes two blocks, each
// reading the tiles; it has 8 consumer warps and one producer warp, 4 and
// one at hd 256; the launch is cooperative when there are splits to
// merge):
//   Tiles.  Split x of a (batch, KV head) takes the 64-slot tiles x,
//   x + splits, ... (dealt round-robin, so the slots written so far spread
//   over every block).  The block reads the slot positions of all its
//   tiles first (two ballots a tile) and skips a tile in which no slot
//   counts without copying anything.
//   Ring.  The producer warp fills STAGES stages (the wrapper's rule, from
//   the head dim: 128 KB in flight an SM; an even number, so a stage
//   always serves the same group of warps), each a K and a V tile, by TMA:
//   one box of 64 columns by 64 slots a panel through a 4-d tensor map of
//   the (hd, K, W, B) view (tma.cuh, shared with flash_attention_bf16.cu),
//   128-byte swizzled, slots past W and columns past hd arriving as zeros.
//   K and V complete on barriers of their own, so the scores start while V
//   is on its way; the stage is refilled once every consumer warp has
//   arrived on its "empty" barrier.  Where TMA cannot describe the rows
//   (hd not a multiple of 8, a stride not a multiple of 8 elements, a
//   start not 16-byte aligned) the producer warp copies the counted rows
//   8 bytes a lane into the same layout.
//   Products.  Consumer warp (h, s) takes the block's 16 query rows (zeros
//   past the group) and slots 16 s .. 16 s + 15 of every tile of its group
//   h (up to hd 128 two groups of 4 warps take alternate tiles, so two
//   warps of each SM quarter hide each other's latencies; at hd 256 one,
//   whose accumulator alone is 128 registers), with an online softmax
//   (log2 units, exp2f) of its own: no barrier between warps inside the
//   loop.  (A second m-tile in the block, for g up to 32, spilled at hd
//   256: 9 warps get 168 registers a thread.)  S = Q K^T: mma.sync
//   m16n8k16 on bf16 operands with fp32 sums, Q and K fragments by
//   ldmatrix from the swizzled tiles, 4 k-steps' fragments loaded before
//   their products (a product of two bf16 values is exact in fp32).  P V:
//   P is split into hi = bf16(p) and lo = bf16(p - hi), two products into
//   one fp32 accumulator (one bf16 P would move the output by ~1e-3 of
//   its scale, as in flash_attention_bf16.cu), V's fragments by
//   ldmatrix.trans.
//   Slots that do not count.  A copied tile may hold them, and their rows
//   anything (TMA copies the whole box): their scores are replaced by
//   NEG_INF, their P is 0, and their V values are zeroed in the fragment
//   before the product, so neither a huge value nor a NaN there reaches
//   the output, and the output's bits do not depend on those rows.
//   Merge.  The block's warps meet once, after the loop: each rescales its
//   partial to the rows' common max in shared memory, and the partials are
//   summed in warp order.  With one split the block writes o.
//   Otherwise it writes its partial (m, l, acc[16][hd]) to the workspace
//   and the splits meet at a barrier as in decode_attention.cu (the launch
//   is cooperative; one 64-bit word a block of the grid's y: the count,
//   and the generation the last arrival moves on), then block x merges
//   the x-th share of the output's elements over all partials in split
//   order, so two launches give the same bits.  The merge costs 2.1-2.7 us
//   at 8 and 16 splits (the probe, PERF.md); a thread-block cluster of the
//   8 splits merging through distributed shared memory took 40.1 us
//   against 26.6 with the barrier, so the barrier stays.
//   Host.  Two tensor maps a call (the caches' addresses change every
//   step); the dynamic shared-memory size set once per instantiation and
//   device; one launch.
// Instantiations: HD = 64, 128, 256 (the smallest that holds hd);
// chip_smoke.py phase 1 checks that ptxas reports no spill.
//
// Measured (chip_smoke.py phase 17 (c), CUDA-event median, L2 flushed by a
// 256 MB write; NVIDIA H100 80GB HBM3, 700.00 W): 31.4 us at InternVL2's
// shape, 3.1 times the bound (the old path 48 us; sdpa with enable_gqa 50
// us); 22.6 us a launch in a profiled decode step.  The probe's device
// times split its 26.5 us: the launch and the slot masks 4.3, the loop's
// waits and the merge 6.6, the copies ~13 (slowed by the flush's dirty
// lines written back beside them: 4 us less after a reading flush), the
// products ~2.5 not hidden.  Stages, two blocks an SM, spinning waits, a
// cluster merge and 8-slot boxes for partly counted tiles did not move it
// by more than 0.5 us (PERF.md).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

using tma::mbar_arrive;
using tma::mbar_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;

constexpr int TILE = tma::BOX_ROWS;  // slots a tile
constexpr int MAX_HD = 256;
constexpr int MAX_GROUP = 32;        // query heads per KV head: two blocks of 16
constexpr int MAX_TILES_PER_SPLIT = 2048;
constexpr int MAX_STAGES = 8;
constexpr int MASK_BATCH = 4;        // tiles whose masks a warp reads at once
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The tensor maps of k and v.
struct Maps {
  CUtensorMap k, v;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* slot_pos;
  const int* pos;
  __nv_bfloat16* o;
  float* ws;                         // the blocks' partials: acc rows, m, l
  int* counters;                     // a 64-bit (generation, count) a block of the grid's y
  int64_t W, K, H;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sp_s, window;
  int g, mb, hd, splits, n_my_max, stages, tma;   // mb: blocks of 16 of the g heads
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int HD>
struct Cfg {
  static constexpr int PANELS = HD / tma::PANEL;
  static constexpr int TILE_BYTES = PANELS * tma::PANEL_BYTES;  // a K or V tile
  // groups of warps taking alternate tiles: two up to HD 128 (9 warps:
  // ptxas allows them 168 registers a thread); at HD 256 one (its
  // accumulator alone is 128 registers)
  static constexpr int NG = HD <= 128 ? 2 : 1;
  static constexpr int WPT = 4;                       // consumer warps of a tile
  static constexpr int NC = WPT * NG;                 // consumer warps
  static constexpr int THREADS = 32 * (NC + 1);       // and the producer warp
  // k-steps (S) or column pairs (P V) whose fragments load at once
  static constexpr int KB = 4;
  static constexpr int Q_PANEL = 16 * 128;            // a panel of Q's 16 rows
  static constexpr int ACC_LD = HD + 4;               // floats a row of a warp's partial
};

// The merge's small arrays: each consumer warp's row max and sum, then the
// block's per row.
struct Misc {
  float wmax[8][16], wsum[8][16];                    // [consumer warp][row]
  float rowM[16], rowL[16];
};

// The carve-up of dynamic shared memory past its 1,024-byte aligned start,
// in bytes, the same on the host and the card: a region that holds the
// ring (stages x a K and a V tile), later the warps' partials; Q's rows;
// the tile masks; the barriers; Misc.  `total` adds the alignment slack.
template <int HD>
struct Layout {
  int q, masks, bars, misc, total;
  __host__ __device__ Layout(int stages, int n_my) {
    using C = Cfg<HD>;
    const int ring = stages * 2 * C::TILE_BYTES;
    const int merge = C::NC * 16 * C::ACC_LD * 4;
    q = round_up(ring > merge ? ring : merge, 1024);
    masks = q + C::PANELS * C::Q_PANEL;
    bars = masks + 8 * n_my;
    misc = bars + 3 * 8 * stages;
    total = 1024 + misc + (int)sizeof(Misc);
  }
};

// Byte offset of 16-byte chunk `chunk` (of 8 bf16 columns) of row `row` in
// a panelled, 128-byte swizzled tile whose panels are `panel` bytes.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int panel) {
  return (uint32_t)((chunk >> 3) * panel + row * 128 + (((chunk & 7) ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += A B, A 16 x 16 (a0..a3), B 16 x 8 (b0, b1), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p = hi + lo for a pair of P values (columns c, c + 1), each half bf16.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The 16-bit mask of a fragment register's two slots: lo and hi.
__device__ __forceinline__ uint32_t pair_mask(unsigned bits, int lo) {
  return (((bits >> lo) & 1u) ? 0x0000ffffu : 0u) | (((bits >> (lo + 1)) & 1u) ? 0xffff0000u : 0u);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void add4(float4& a, float w, float4 v) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}

__device__ __forceinline__ int next_tile(const unsigned long long* masks, int j, int n) {
  while (j < n && masks[j] == 0ull) ++j;
  return j;
}

// (m, l, a) <- (m, l, a) merged with another partial (mx, lx, x), as the
// online softmax rescales (m in log2 units): a partial with m = NEG_INF (no
// slot counted) weighs 0.
__device__ __forceinline__ void fold(float& m, float& l, float4& a, float mx, float lx, float4 x) {
  const float mn = fmaxf(m, mx);
  const float so = m == NEG_INF ? 0.f : exp2f(m - mn);
  const float sx = mx == NEG_INF ? 0.f : exp2f(mx - mn);
  a = make_float4(fmaf(a.x, so, x.x * sx), fmaf(a.y, so, x.y * sx), fmaf(a.z, so, x.z * sx),
                  fmaf(a.w, so, x.w * sx));
  l = fmaf(l, so, lx * sx);
  m = mn;
}

// Row j, columns c..c+3 of the output from its merged (M, L, acc); if no
// slot counts (M = NEG_INF), the mean of V over all W slots.
__device__ __forceinline__ void write_out(__nv_bfloat16* o, int hd, int j, int c, float4 a,
                                          float M, float L, const __nv_bfloat16* vb, int64_t W,
                                          int64_t v_ss) {
  if (M == NEG_INF) {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t w = 0; w < W; ++w) add4(a, 1.f, load4(vb + w * v_ss + c));
    L = (float)W;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + j * hd + c);
  dst[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
  dst[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
}

// The counted rows of a tile's K and V, copied by the producer warp 8 bytes a
// lane into the swizzled layout, where TMA cannot describe the rows.
__device__ __forceinline__ void copy_rows(uint8_t* kt, uint8_t* vt, const __nv_bfloat16* kb,
                                          const __nv_bfloat16* vb, int64_t row0,
                                          unsigned long long mask, const Params& p) {
  const int per_row = p.hd / 4, lane = threadIdx.x & 31;
  for (int i = lane; i < 2 * TILE * per_row; i += 32) {
    const int kv = i >= TILE * per_row;
    const int j = kv ? i - TILE * per_row : i;
    const int r = j / per_row, c = 4 * (j - r * per_row);
    if ((mask >> r) & 1ull) {
      const __nv_bfloat16* src = kv ? vb + (row0 + r) * p.v_ss + c : kb + (row0 + r) * p.k_ss + c;
      *reinterpret_cast<uint2*>((kv ? vt : kt) + swz(r, c / 8, tma::PANEL_BYTES) + (c & 4) * 2) =
          *reinterpret_cast<const uint2*>(src);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
decode_attention_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout<HD> lay(p.stages, p.n_my_max);
  uint8_t* const ring = smem;
  uint8_t* const qs = smem + lay.q;
  unsigned long long* const masks = reinterpret_cast<unsigned long long*>(smem + lay.masks);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  Misc& ms = *reinterpret_cast<Misc*>(smem + lay.misc);
  const int stages = p.stages;
  const uint32_t kbar = smem_u32(bars), vbar = kbar + 8 * stages, ebar = vbar + 8 * stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;       // the mma's group and thread in group
  const bool producer = warp == C::NC;
  const int sg = warp & 3, grp = warp >> 2;      // a consumer's slot group and tile group
  // blockIdx.y: the (batch, KV head) pair bk and its block m0 / 16 of 16
  // query heads, gl of them
  const int64_t bkm = blockIdx.y, bk = bkm / p.mb;
  const int64_t b = bk / p.K, kh = bk - b * p.K;
  const int m0 = 16 * (int)(bkm - bk * p.mb), gl = min(16, p.g - m0);
  const int S = p.splits, split_x = blockIdx.x;
  const int64_t n_tiles = (p.W + TILE - 1) / TILE;
  const int n_my = (int)((n_tiles - 1 - split_x) / S + 1);
  const int hd = p.hd;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + (kh * p.g + m0) * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kh * p.v_sh;

  if (producer && lane < 2 && p.tma) {          // the maps' descriptors, fetched early
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.k + lane))
                 : "memory");
  }
  // Which slots of this block's tiles count: two ballots a tile, the slot
  // positions of up to MASK_BATCH tiles a warp loaded at once.
  const int64_t pos = *p.pos;
  for (int j0 = warp; j0 < n_my; j0 += (C::NC + 1) * MASK_BATCH) {
    int64_t sp[MASK_BATCH][2];
#pragma unroll
    for (int u = 0; u < MASK_BATCH; ++u) {
      const int j = j0 + u * (C::NC + 1);
      const int64_t slot = ((int64_t)split_x + (int64_t)j * S) * TILE + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sp[u][h] = (j < n_my && slot + 32 * h < p.W)
                       ? (int64_t)p.slot_pos[(slot + 32 * h) * p.sp_s] : -1;
    }
#pragma unroll
    for (int u = 0; u < MASK_BATCH; ++u) {
      const int j = j0 + u * (C::NC + 1);
      unsigned m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t x = sp[u][h];
        m[h] = __ballot_sync(FULL, x >= 0 && x <= pos && (p.window <= 0 || pos - x < p.window));
      }
      if (lane == 0 && j < n_my) masks[j] = (unsigned long long)m[1] << 32 | m[0];
    }
  }
  // Q's 16 rows (zeros past gl and hd), 8 bytes a thread, into the
  // swizzled panels that ldmatrix reads.
  for (int i = tid; i < 16 * (HD / 4); i += C::THREADS) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    uint2 val = make_uint2(0u, 0u);
    if (r < gl && c < hd) val = *reinterpret_cast<const uint2*>(qb + r * p.q_sh + c);
    *reinterpret_cast<uint2*>(qs + swz(r, c / 8, C::Q_PANEL) + (c & 4) * 2) = val;
  }
  if (!p.tma) {                                  // rows copied by threads: the columns past
    for (int i = tid; i < stages * 2 * C::TILE_BYTES / 16; i += C::THREADS)  // hd stay 0
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(kbar + 8 * s, 1);
      mbar_init(vbar + 8 * s, 1);
      mbar_init(ebar + 8 * s, C::WPT);           // one arrival a warp of its group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (producer) {
    // ---- the ring: stage it % STAGES holds the it-th counted tile ----
    int it = 0;
    for (int jl = next_tile(masks, 0, n_my); jl < n_my; jl = next_tile(masks, jl + 1, n_my), ++it) {
      const int s = it % stages;
      if (it >= stages) mbar_wait(ebar + 8 * s, ((it / stages) - 1) & 1);
      const int64_t row0 = ((int64_t)split_x + (int64_t)jl * S) * TILE;
      uint8_t* const kt = ring + s * 2 * C::TILE_BYTES;
      uint8_t* const vt = kt + C::TILE_BYTES;
      if (p.tma) {
        if (lane == 0) {
          mbar_expect_tx(kbar + 8 * s, C::TILE_BYTES);
#pragma unroll
          for (int pp = 0; pp < C::PANELS; ++pp)
            tma::load_box(smem_u32(kt + pp * tma::PANEL_BYTES), &maps.k, kbar + 8 * s,
                          pp * tma::PANEL, (int)kh, (int)row0, (int)b);
          mbar_expect_tx(vbar + 8 * s, C::TILE_BYTES);
#pragma unroll
          for (int pp = 0; pp < C::PANELS; ++pp)
            tma::load_box(smem_u32(vt + pp * tma::PANEL_BYTES), &maps.v, vbar + 8 * s,
                          pp * tma::PANEL, (int)kh, (int)row0, (int)b);
        }
      } else {
        copy_rows(kt, vt, kb, vb, row0, masks[jl], p);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(kbar + 8 * s);
          mbar_arrive(vbar + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warp (grp, sg): the block's 16 rows, slots 16 sg.. of the
    // tiles it with it % NG == grp (stage it % STAGES: the stages are even
    // in number, so a stage always serves the same group) ----
    const float scale = LOG2E / sqrtf((float)hd);   // scores in log2 units: exp2f
    const int ks_n = (hd + 15) / 16;
    const int lr = lane & 7, lm = lane >> 3;       // ldmatrix: row, and matrix, of the lane
    const uint32_t q_addr = smem_u32(qs);
    const int q_row = (lm & 1) * 8 + lr;           // A: matrices (rows, k) 0-7/0, 8-15/0, 0-7/8, 8-15/8
    const int k_row = sg * 16 + (lm >> 1) * 8 + lr;  // B of S: (slots, k) 0-7/0, 0-7/8, 8-15/0, 8-15/8
    const int v_row = sg * 16 + (lm & 1) * 8 + lr;   // B of P V: (slots, cols) 0-7/0, 8-15/0, 0-7/8, 8-15/8
    int it = 0;
    for (int jc = next_tile(masks, 0, n_my); jc < n_my;
         jc = next_tile(masks, jc + 1, n_my), ++it) {
      if (it % C::NG != grp) continue;
      const int s = it % stages;
      const int phase = (it / stages) & 1;
      const unsigned wm = (unsigned)(masks[jc] >> (16 * sg)) & 0xffffu;  // this warp's slots
      const uint32_t kt = smem_u32(ring + s * 2 * C::TILE_BYTES);
      const uint32_t vt = kt + C::TILE_BYTES;
      mbar_wait(kbar + 8 * s, phase);            // every warp of the group waits
      float aa = 1.f, ab = 1.f;
      uint32_t ph[4], pl[4];
      if (wm) {
        // S = Q K^T for this warp's 16 slots: n-tile n holds slots 8 n + 2 tq
        // (+1) of rows gq and gq + 8; even and odd k-steps in two sums
        float sc[2][2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < HD / 16; k0 += C::KB) {
          uint32_t a[C::KB][4], b[C::KB][4];
#pragma unroll
          for (int u = 0; u < C::KB; ++u) {
            if (k0 + u < ks_n) {
              ldsm_x4(q_addr + swz(q_row, 2 * (k0 + u) + (lm >> 1), C::Q_PANEL), a[u][0],
                      a[u][1], a[u][2], a[u][3]);
              ldsm_x4(kt + swz(k_row, 2 * (k0 + u) + (lm & 1), tma::PANEL_BYTES), b[u][0],
                      b[u][1], b[u][2], b[u][3]);
            }
          }
#pragma unroll
          for (int u = 0; u < C::KB; ++u) {
            if (k0 + u < ks_n) {
              mma(sc[0][u & 1], a[u], b[u][0], b[u][1]);
              mma(sc[1][u & 1], a[u], b[u][2], b[u][3]);
            }
          }
        }
        // the slots that do not count: NEG_INF whatever their scores are
        float x[2][4];
        bool ok[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ok[n][e] = (wm >> (8 * n + 2 * tq + e)) & 1u;
            x[n][e] = ok[n][e] ? (sc[n][0][e] + sc[n][1][e]) * scale : NEG_INF;
            x[n][e + 2] = ok[n][e] ? (sc[n][0][e + 2] + sc[n][1][e + 2]) * scale : NEG_INF;
          }
        }
        float ta = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
        float tb = fmaxf(fmaxf(x[0][2], x[0][3]), fmaxf(x[1][2], x[1][3]));
        ta = fmaxf(ta, __shfl_xor_sync(FULL, ta, 1));
        ta = fmaxf(ta, __shfl_xor_sync(FULL, ta, 2));
        tb = fmaxf(tb, __shfl_xor_sync(FULL, tb, 1));
        tb = fmaxf(tb, __shfl_xor_sync(FULL, tb, 2));
        // some slot of the group counts, so ta and tb are real scores
        const float na = fmaxf(m_a, ta), nb = fmaxf(m_b, tb);
        aa = exp2f(m_a - na);
        ab = exp2f(m_b - nb);
        m_a = na;
        m_b = nb;
        float pv[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pv[n][e] = ok[n][e] ? exp2f(x[n][e] - na) : 0.f;
            pv[n][e + 2] = ok[n][e] ? exp2f(x[n][e + 2] - nb) : 0.f;
          }
        }
        l_a = fmaf(l_a, aa, (pv[0][0] + pv[0][1]) + (pv[1][0] + pv[1][1]));
        l_b = fmaf(l_b, ab, (pv[0][2] + pv[0][3]) + (pv[1][2] + pv[1][3]));
        // P's A fragment: (row gq, slots 2 tq..), (gq + 8, 2 tq..), (gq, 8 + 2 tq..),
        // (gq + 8, 8 + 2 tq..), each split into bf16 hi + lo
        split_pair(pv[0][0], pv[0][1], ph[0], pl[0]);
        split_pair(pv[0][2], pv[0][3], ph[1], pl[1]);
        split_pair(pv[1][0], pv[1][1], ph[2], pl[2]);
        split_pair(pv[1][2], pv[1][3], ph[3], pl[3]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[j][0] *= aa;
          acc[j][1] *= aa;
          acc[j][2] *= ab;
          acc[j][3] *= ab;
        }
      }
      mbar_wait(vbar + 8 * s, phase);
      if (wm) {
        // V's B fragments hold slots 2 tq, 2 tq + 1 (b0) and 8 + 2 tq, 9 + 2 tq
        // (b1): those that do not count are zeroed
        const uint32_t vm0 = pair_mask(wm, 2 * tq), vm1 = pair_mask(wm, 8 + 2 * tq);
#pragma unroll
        for (int j0 = 0; j0 < HD / 16; j0 += C::KB) {
          uint32_t b[C::KB][4];
#pragma unroll
          for (int u = 0; u < C::KB; ++u) {
            if (16 * (j0 + u) < hd) {
              ldsm_x4_trans(vt + swz(v_row, 2 * (j0 + u) + (lm >> 1), tma::PANEL_BYTES),
                            b[u][0], b[u][1], b[u][2], b[u][3]);
              b[u][0] &= vm0;
              b[u][1] &= vm1;
              b[u][2] &= vm0;
              b[u][3] &= vm1;
            }
          }
#pragma unroll
          for (int u = 0; u < C::KB; ++u) {
            if (16 * (j0 + u) < hd) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float(&c)[4] = acc[2 * (j0 + u) + h];
                mma(c, ph, b[u][2 * h], b[u][2 * h + 1]);
                mma(c, pl, b[u][2 * h], b[u][2 * h + 1]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ebar + 8 * s);  // this warp is done with the stage
    }
  }

  // The warps' partials.  l over the quad; each warp's row max and sum to
  // Misc.  Every counted tile is consumed, so the ring is free.
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  if (!producer && tq == 0) {
    ms.wmax[warp][gq] = m_a;
    ms.wmax[warp][gq + 8] = m_b;
    ms.wsum[warp][gq] = l_a;
    ms.wsum[warp][gq + 8] = l_b;
  }
  __syncthreads();
  // Each warp's acc rescaled to its rows' max over the NC warps, into
  // [warp][16][ACC_LD]; the block's m and l per row.
  float* const accw = reinterpret_cast<float*>(ring);
  if (!producer) {
    float Ma = ms.wmax[0][gq], Mb = ms.wmax[0][gq + 8];
#pragma unroll
    for (int w = 1; w < C::NC; ++w) {
      Ma = fmaxf(Ma, ms.wmax[w][gq]);
      Mb = fmaxf(Mb, ms.wmax[w][gq + 8]);
    }
    const float ca = m_a == NEG_INF ? 0.f : exp2f(m_a - Ma);
    const float cb = m_b == NEG_INF ? 0.f : exp2f(m_b - Mb);
    float* const dst = accw + warp * 16 * C::ACC_LD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < hd) {
        *reinterpret_cast<float2*>(dst + gq * C::ACC_LD + col) =
            make_float2(acc[j][0] * ca, acc[j][1] * ca);
        *reinterpret_cast<float2*>(dst + (gq + 8) * C::ACC_LD + col) =
            make_float2(acc[j][2] * cb, acc[j][3] * cb);
      }
    }
  }
  if (tid < gl) {
    float M = ms.wmax[0][tid];
    for (int w = 1; w < C::NC; ++w) M = fmaxf(M, ms.wmax[w][tid]);
    float L = 0.f;
    for (int w = 0; w < C::NC; ++w) {
      const float mw = ms.wmax[w][tid];
      L += mw == NEG_INF ? 0.f : ms.wsum[w][tid] * exp2f(mw - M);
    }
    ms.rowM[tid] = M;
    ms.rowL[tid] = L;
  }
  __syncthreads();

  // The block's acc[j][c..c+3]: the NC warp partials in warp order.
  const int hd4 = hd / 4;
  auto block_acc = [&](int j, int c) {
    const float* src = accw + j * C::ACC_LD + c;
    float4 a = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int w = 1; w < C::NC; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(src + w * 16 * C::ACC_LD);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    return a;
  };
  __nv_bfloat16* const o = p.o + (b * p.H + kh * p.g + m0) * hd;
  if (S == 1) {                                  // the block's partial is the answer
    for (int e = tid; e < gl * hd4; e += C::THREADS) {
      const int j = e / hd4, c = 4 * (e - j * hd4);
      write_out(o, hd, j, c, block_acc(j, c), ms.rowM[j], ms.rowL[j], vb, p.W, p.v_ss);
    }
    return;
  }
  // The partial to the workspace, rows (bkm * S + split) * 16 + j; then the
  // S blocks of this (batch, KV head, block of heads) meet at a barrier:
  // the last to count resets the counter and moves the generation on.  The
  // launch is cooperative, so all of them are resident and the wait ends.
  const int64_t n_rows = (int64_t)gridDim.y * S * 16;
  float* const ws_acc = p.ws;
  float* const ws_m = ws_acc + n_rows * hd;
  float* const ws_l = ws_m + n_rows;
  const int64_t prow = (bkm * S + split_x) * 16;
  for (int e = tid; e < gl * hd4; e += C::THREADS) {
    const int j = e / hd4, c = 4 * (e - j * hd4);
    *reinterpret_cast<float4*>(ws_acc + (prow + j) * hd + c) = block_acc(j, c);
  }
  if (tid < gl) {
    ws_m[prow + tid] = ms.rowM[tid];
    ws_l[prow + tid] = ms.rowL[tid];
  }
  __syncthreads();
  if (tid == 0) {
    unsigned long long* word = reinterpret_cast<unsigned long long*>(p.counters) + bkm;
    __threadfence();                             // (releases this block's partial)
    const unsigned long long old = atomicAdd(word, 1ull);
    if ((unsigned)old == (unsigned)(S - 1)) {
      atomicAdd(word, (1ull << 32) - (unsigned long long)S);
      __threadfence();                           // (acquires the others')
    } else {
      const unsigned gen = (unsigned)(old >> 32);
      unsigned long long now;
      do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(now) : "l"(word) : "memory");
      } while ((unsigned)(now >> 32) == gen);
    }
  }
  __syncthreads();

  // Block x merges the x-th share of the output's float4 elements over the
  // S partials: P consecutive lanes an element, lane q folding splits q,
  // q + P, ..., then a shuffle butterfly; lane 0's sequence of merges is the
  // same whichever block came last.
  const int n_el = gl * hd4;
  const int share = (n_el + S - 1) / S;
  const int e0 = split_x * share, e1 = min(n_el, e0 + share);
  const int ne = e1 > e0 ? e1 - e0 : 0;
  int P = 1;
  while (2 * P <= 32 && 2 * P <= S && 2 * P * ne <= C::THREADS) P *= 2;
  for (int i0 = 0; i0 < ne; i0 += C::THREADS / P) {
    const int i = i0 + tid / P, q = tid % P;
    float m = NEG_INF, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    int j = 0, c = 0;
    if (i < ne) {
      j = (e0 + i) / hd4;
      c = 4 * (e0 + i - j * hd4);
#pragma unroll 4
      for (int n = q; n < S; n += P) {
        const int64_t row = (bkm * S + n) * 16 + j;
        fold(m, l, a, __ldcg(ws_m + row), __ldcg(ws_l + row),
             __ldcg(reinterpret_cast<const float4*>(ws_acc + row * hd + c)));
      }
    }
    for (int d = P / 2; d > 0; d >>= 1) {
      const float mx = __shfl_xor_sync(FULL, m, d), lx = __shfl_xor_sync(FULL, l, d);
      const float4 x = make_float4(__shfl_xor_sync(FULL, a.x, d), __shfl_xor_sync(FULL, a.y, d),
                                   __shfl_xor_sync(FULL, a.z, d), __shfl_xor_sync(FULL, a.w, d));
      fold(m, l, a, mx, lx, x);
    }
    if (i < ne && q == 0) write_out(o, hd, j, c, a, m, l, vb, p.W, p.v_ss);
  }
}

template <int HD>
int launch(const Maps& maps, const Params& p, int64_t BK, int device, cudaStream_t stream) {
  using C = Cfg<HD>;
  const Layout<HD> lay(p.stages, p.n_my_max);
  static int smem_set[MAX_DEVICES] = {};
  if (lay.total > smem_set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_bf16_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               lay.total);
    if (e != cudaSuccess) {
      cudaGetLastError();                        // (not left for the next call to read)
      return (int)e;
    }
    smem_set[device] = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.splits, (unsigned)(BK * p.mb), 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // the splits meet at a barrier
  attr[0].val.cooperative = p.splits > 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_bf16_kernel<HD>, maps, p);
  const cudaError_t last = cudaGetLastError();   // (and clears a refused launch's error)
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// q: (B, 1, H, hd) with (batch, head) strides q_sb, q_sh; k and v: (B, W,
// K, hd) with (batch, slot, head) strides; all bf16 with a contiguous last
// dimension; hd a multiple of 4, at most 256; g = H / K at most 32; every
// stride a multiple of 4 and every pointer 8-byte aligned.  tma = 1 reads k
// and v through tensor maps (hd and their strides multiples of 8, their
// starts 16-byte aligned; a size-1 dimension's stride may be any multiple
// of 8), tma = 0 copies their rows by threads.  slot_pos: (W,) int32 with
// stride sp_s; pos: one int32, both in device memory.  o: (B, 1, H, hd)
// contiguous bf16.  The slots are dealt in 64-slot tiles to `splits`
// blocks per (batch, KV head, 16 query heads) (at most MAX_TILES_PER_SPLIT
// tiles a split; with splits > 1 the launch is cooperative, so all of the
// B * K * ceil(g / 16) * splits blocks must fit on the card at once),
// through a ring of `stages` stages (even, 2 to MAX_STAGES).  ws: fp32
// workspace of B * K * ceil(g / 16) * splits * 16 * (hd + 2) floats
// (unused with one split); counters: B * K * ceil(g / 16) 64-bit words
// (8-byte aligned), zero before the first launch, left ready for the
// next.  window <= 0 means no window.  One launch on `stream`; returns its
// cudaError_t (0 on success).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* slot_pos, const void* pos, void* o, void* ws,
                                     void* counters, int64_t B, int64_t W, int64_t H, int64_t K,
                                     int64_t hd, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                     int64_t v_sh, int64_t sp_s, int64_t window, int64_t splits,
                                     int stages, int use_tma, int device, void* stream) {
  const int64_t g = H / K;
  const int64_t n_tiles = (W + TILE - 1) / TILE;
  if (device < 0 || device >= MAX_DEVICES || hd % 4 || hd <= 0 || hd > MAX_HD || g < 1 ||
      g > MAX_GROUP || splits < 1 || splits > n_tiles ||
      (n_tiles + splits - 1) / splits > MAX_TILES_PER_SPLIT || stages < 2 ||
      stages > MAX_STAGES || stages % 2 || (use_tma && hd % 8) || W >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  Maps maps = {};
  if (use_tma) {
    int err = tma::make_map(&maps.k, k, hd, K, W, B, k_sh, k_ss, k_sb);
    if (err) return err;
    err = tma::make_map(&maps.v, v, hd, K, W, B, v_sh, v_ss, v_sb);
    if (err) return err;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.slot_pos = static_cast<const int*>(slot_pos);
  p.pos = static_cast<const int*>(pos);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.W = W;
  p.K = K;
  p.H = H;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.sp_s = sp_s;
  p.window = window;
  p.g = (int)g;
  p.mb = (int)((g + 15) / 16);
  p.hd = (int)hd;
  p.splits = (int)splits;
  p.n_my_max = (int)((n_tiles + splits - 1) / splits);
  p.stages = stages;
  p.tma = use_tma;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch<64>(maps, p, B * K, device, s);
  if (hd <= 128) return launch<128>(maps, p, B * K, device, s);
  return launch<256>(maps, p, B * K, device, s);
}
