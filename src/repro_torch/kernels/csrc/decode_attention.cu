// One-token GQA attention over a ring KV cache (the decode step):
//
//   o[b, h] = sum_w softmax_w(q[b, h] . k[b, w, h / g] / sqrt(hd)) v[b, w, h / g]
//
// over the slots w that count: 0 <= slot_pos[w] <= pos and, with a window,
// pos - slot_pos[w] < window.  When no slot counts, every score is the
// finite NEG_INF and the softmax is uniform: o is the mean of v over all W
// slots, as in the reference.  fp32 operands; the bf16 path is
// decode_attention_bf16.cu.
//
// Replaces the TPU kernel decode_attention_bk
// (src/repro/kernels/decode_attention.py:66, wrapper
// src/repro/kernels/ops.py:187).
//
// Bound on the card: bytes.  The K and V rows of the slots that count, q and
// o, at 3.35 TB/s: at B = 2 in fp32, 8.4 MB for RecurrentGemma-9B (a full
// 2,048-slot ring, 16 query heads over one KV head of 256; 2.53 us) and
// 16.8 MB for ChatGLM3-6B (4,097 of 8,192 slots written, 32 over 2 KV heads
// of 128; 5.04 us).  A slot costs 4 g hd flops for 8 hd bytes: 8 flops a
// byte at g = 16, 40 % of the byte bound on the CUDA cores (67 TFLOP/s),
// 16 % in split-TF32 on the tensor cores (495 / 3 TFLOP/s).
//
// What held the first version (PR 15) back, split by a one-off probe on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 18): 25.2 us at
// RecurrentGemma's shape and 36.5 us at ChatGLM3's, of which the second
// launch (the cross-split combine, one block per query row walking the
// splits in turn) took 11.7 and 12.3 us alone, and the two products on the
// CUDA cores 6.8 and 11.8 us; each tile's copy was waited for before it
// was scored; contiguous runs of tiles left half of ChatGLM3's blocks with
// no slot that counts; every call set the shared-memory attribute.
//
// Design, one launch per call (grid: splits x B K; a block has 8 compute
// warps and one copying warp):
//   Tiles.  Split x of a (batch, KV head) takes the 32-slot tiles x,
//   x + splits, ... (dealt round-robin, so the slots written so far spread
//   over every block).  A block reads the slot positions of all its tiles
//   first (one ballot a tile) and skips a tile in which no slot counts
//   without copying anything.
//   Ring.  The tiles that count stream through STAGES K/V buffers in shared
//   memory (2 at head dims above 128 in fp32, else 4): each row a Hopper
//   bulk copy (cp.async.bulk) completing on the buffer's K or V mbarrier
//   with its byte count, so the scores start when K has landed while V is
//   on its way.  The copies are issued by the copying warp alone, which
//   fills the buffers in turn and refills one once every compute warp has
//   arrived on its "empty" mbarrier: a bulk copy waits for the copy
//   engine's queue (~25 ns a row), and no compute warp waits with it.
//   Rows of slots that do not count are not copied; the scores of those
//   slots are masked and V's B fragment reads 0 there, so what the buffer
//   held before never reaches the output.
//   Products.  Tensor cores, mma.sync m16n8k8 TF32, in split-TF32 (x = hi +
//   lo; hi hi + hi lo + lo hi, fp32 accumulation).  The g query heads are the
//   M rows (zero rows pad g to 16; two m-tiles at g = 32).  S = Q K^T: the
//   W warps of an m-tile split the head dim's k-steps and keep their query
//   fragments in registers for the whole kernel; their partial scores meet
//   in shared memory, 4 warps each add up one 8-slot group and take its
//   max.  Softmax: FlashAttention's online softmax in log2 units (exp2f).
//   P stays in the mma's own layout: a lane holds slots 2t and 2t + 1 where
//   P V's A fragment wants columns t and t + 4, so P V's slot order is
//   permuted to match and V's B fragment reads rows 2t and 2t + 1.  P V:
//   the warps split the output's 8-column tiles.
//   Merge.  With one split the block writes o.  Otherwise every block
//   writes its partial (m, l, acc[g][hd]) to the workspace, and the
//   splits of a (batch, KV head) meet at a barrier: one 64-bit word a pair
//   counts them (low half) and the last adds 2^32 - splits, which resets
//   the count and moves the generation (high half) on in one atomic; the
//   others wait for the generation to move.  The launch is cooperative
//   (all blocks resident at once; the rule keeps a block per SM), so the
//   wait ends.  Then block x merges the x-th share of the output's
//   elements over all partials: P lanes an element fold their splits
//   online and a shuffle butterfly merges them, a fixed order whichever
//   block came last, so two launches give the same bits.  If no slot
//   counts, o is the mean of V (a slow path: each element reads its column
//   of all W rows; no decode step has an empty cache).  The counters
//   belong to the wrapper (zeroed once, cached per device): no call needs
//   a memset.  The port launches on one stream; two launches on two
//   streams at once would share them.
//   Host.  The dynamic shared-memory size is set once per instantiation
//   and device (again only if a larger one is asked for); cudaSetDevice
//   runs only when the device is not the current one; one call, one launch.
// pos and slot_pos are read in device memory (the counterpart of the TPU
// kernel's scalar prefetch), so the decode step never waits on the host;
// q and the caches are read in place through their strides.
// Resident blocks: one per SM at head dims above 64 (288 threads, 150-210
// KB of shared memory); about 90 KB below, so two fit (the split rule still
// asks for at most one per SM).  Registers: ptxas holds a 9-warp block to
// 168 a thread (warps are allocated four at a time); S keeps two
// accumulators a group (hi hi, and both cross terms), and no instantiation
// spills (chip_smoke.py phase 1 checks all 6).
//
// Measured by chip_smoke.py phase 2's time_decode on an NVIDIA H100 80GB
// HBM3 at 700 W (CUDA-event medians of 100 launches, a 256 MB flush before
// each), in one run: 19.71 us at RecurrentGemma's shape (bound 2.53 us),
// 22.91 us at ChatGLM3's (5.04 us) and 14.30 us at StableLM-1.6B's (B = 4,
// 65 of 128 slots, 32 heads of 64; 1.29 us), from 25.15, 37.02 and 15.55
// us.  An empty kernel takes 5.0 us under that timing, and the copies run
// at about 20 GB/s an SM whatever the mechanism; PERF.md (PR 18) has the
// split by phase and the other runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;           // slots per tile: 4 warps x 8
constexpr int MAX_HD = 256;
constexpr int MAX_GROUP = 32;      // query heads per KV head: 2 m-tiles
constexpr int MAX_TILES_PER_SPLIT = 4096;
constexpr int MASK_BATCH = 4;         // tiles whose masks a warp reads at once
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* slot_pos;
  const int* pos;
  float* o;
  float* ws;                       // the blocks' partials: acc rows, m, l
  int* counters;                   // a 64-bit (generation, count) per (batch, KV head)
  int64_t W, K, H;
  int64_t q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sp_s, window;
  int g, hd, splits, n_my_max;
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of a K or V tile in shared memory, in floats: 4 words past a
// multiple of 32 banks, so that the fragment loads of both products (K:
// slot = lane / 4, column = lane % 4; V: slots 2 (lane % 4) and + 1, column
// lane / 4) fall on 32 distinct banks.
__host__ __device__ constexpr int ring_ld(int hd) { return round_up(hd, 32) + 4; }

template <int MT, int NT>
struct Cfg {
  static constexpr int WARPS = 8;                  // compute warps; one more copies
  static constexpr int THREADS = 32 * (WARPS + 1);
  static constexpr int W = WARPS / MT;           // warps of an m-tile
  static constexpr int PER_WARP = (NT + W - 1) / W;   // most k-steps of S, and most
                                                    // 8-column tiles of P V, a warp takes
  static constexpr int STAGES = NT * 4 >= 128 ? 2 : 4;
};

// Small per-block arrays: the ring's K, V and empty barriers; the tile max of
// each 8-slot group and the share of l of the warp that scored it, for the
// 16 rows of each m-tile; the block's partial m and l per row (in the
// last merge, the m and l of the rows it writes).
struct Misc {
  uint64_t kbar[4], vbar[4], ebar[4];
  float mx[2][4][16], lw[2][4][16];
  float rowM[MAX_GROUP], rowL[MAX_GROUP];
};

// The carve-up of dynamic shared memory, in bytes, the same on the host
// and the card: the warps' partial scores of one tile ([m-tile][warp][8-slot
// group][lane] float4s); P's A fragments of one tile ([m-tile][group][hi,
// lo][lane] uint4s); a region that holds the K/V ring, then (with one
// split) the block's partial acc[g][hd]; the tile masks; Misc.
template <int MT, int NT>
struct Layout {
  int pf, region, masks, misc, total;
  __host__ __device__ Layout(int hd, int g, int n_my) {
    const int ring = Cfg<MT, NT>::STAGES * 2 * TILE * ring_ld(hd) * 4;
    const int merge = 4 * g * hd;
    pf = Cfg<MT, NT>::WARPS * 4 * 32 * 16;
    region = pf + MT * 4 * 64 * 16;
    masks = region + round_up(ring > merge ? ring : merge, 16);
    misc = masks + round_up(4 * n_my, 16);
    total = misc + round_up((int)sizeof(Misc), 16);
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void add4(float4& a, float w, float4 v) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo with both parts TF32: split-TF32 keeps fp32's accuracy.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += A B, A 16 x 8 (a0..a3), B 8 x 8 (b0, b1), TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c[0] += Ah Bh and c[1] += Ah Bl + Al Bh: the split-TF32 terms of A B in
// two accumulators, two independent chains.  A's parts in ah / al, B's
// (b0, b1) as floats.
__device__ __forceinline__ void mma3(float (&c)[2][4], const uint4& ah, const uint4& al,
                                     float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(c[0], ah.x, ah.y, ah.z, ah.w, h0, h1);
  mma(c[1], ah.x, ah.y, ah.z, ah.w, l0, l1);
  mma(c[1], al.x, al.y, al.z, al.w, h0, h1);
}

// acc += P V in split-TF32, the terms in one accumulator (the column tiles
// are independent chains already).  P's parts in ph / pl.
__device__ __forceinline__ void mma_pv(float (&acc)[4], const uint4& ph, const uint4& pl,
                                       float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(acc, pl.x, pl.y, pl.z, pl.w, h0, h1);
  mma(acc, ph.x, ph.y, ph.z, ph.w, l0, l1);
  mma(acc, ph.x, ph.y, ph.z, ph.w, h0, h1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// mbarriers in shared memory: `count` arrivals (each with the bytes it
// expects) per phase; the bulk copies complete the bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}
// One row of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Start filling one ring buffer with the K rows (then the V rows) of the
// tile's slots that count, one bulk copy a row and a lane of the copying
// warp, completing on kbar (vbar) with the bytes lane 0 announced.  Rows
// of slots that do not count are not copied: what they hold is never used
// (scores are masked, V's B fragment reads 0 there).  Called by the
// copying warp.
__device__ __forceinline__ void fill_tile(float* kd, float* vd, uint64_t* kbar, uint64_t* vbar,
                                          const float* kb, const float* vb, int64_t row0,
                                          unsigned mask, const Params& p, int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned bytes = p.hd * 4u;
  if (lane == 0) {
    mbar_expect(kbar, __popc(mask) * bytes);
    mbar_expect(vbar, __popc(mask) * bytes);
  }
  __syncwarp();
  if ((mask >> lane) & 1u) {
    bulk_copy(kd + lane * ld, kb + (row0 + lane) * p.k_ss, bytes, kbar);
    bulk_copy(vd + lane * ld, vb + (row0 + lane) * p.v_ss, bytes, vbar);
  }
}

// A barrier of the compute warps alone (the copying warp runs ahead).
template <int N>
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int next_tile(const unsigned* masks, int j, int n) {
  while (j < n && masks[j] == 0u) ++j;
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
__device__ __forceinline__ void write_out(float* o, int hd, int j, int c, float4 a, float M,
                                          float L, const float* vb, int64_t W, int64_t v_ss) {
  if (M == NEG_INF) {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t w = 0; w < W; ++w) add4(a, 1.f, load4(vb + w * v_ss + c));
    L = (float)W;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  *reinterpret_cast<float4*>(o + j * hd + c) =
      make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
}

template <int MT, int NT>
__global__ void __launch_bounds__(Cfg<MT, NT>::THREADS, 1)
decode_attention_kernel(const Params p) {
  using C = Cfg<MT, NT>;
  constexpr int W = C::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = p.g, hd = p.hd, S = p.splits;
  const Layout<MT, NT> lay(hd, g, p.n_my_max);
  const int hdp = round_up(hd, 8), ks_n = hdp / 8, hd4 = hd / 4;
  const int ld = ring_ld(hd);
  float4* sps = reinterpret_cast<float4*>(smem);
  uint4* pf = reinterpret_cast<uint4*>(smem + lay.pf);
  float* ring = reinterpret_cast<float*>(smem + lay.region);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + lay.masks);
  Misc& ms = *reinterpret_cast<Misc*>(smem + lay.misc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;       // the mma's group and thread in group
  const int mt = warp / W, wi = warp % W;        // m-tile; warp within it
  const bool copier = warp == C::WARPS;          // the warp that fills the ring
  const int64_t bk = blockIdx.y;
  const int64_t b = bk / p.K, kh = bk - b * p.K;
  const int split_x = blockIdx.x;
  const int64_t n_tiles = (p.W + TILE - 1) / TILE;
  const int n_my = (int)((n_tiles - 1 - split_x) / S + 1);
  const float* qb = p.q + b * p.q_sb + kh * g * p.q_sh;
  const float* kb = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kh * p.v_sh;

  // This warp's k-steps of S are wi, wi + W, ...; their query A fragments
  // stay in registers, split into TF32 hi and lo: rows r = 16 mt + gq and
  // r + 8, columns d = 8 k-step + tq and d + 4 (0 past g or hd).  Loaded
  // here, split once the ring is requested.
  float qx[C::PER_WARP][4];
#pragma unroll
  for (int k = 0; k < C::PER_WARP; ++k) {
    const int kk = wi + k * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mt * 16 + gq + 8 * (i & 1), d = kk * 8 + tq + 4 * (i >> 1);
      qx[k][i] = (kk < ks_n && r < g && d < hd) ? qb[r * p.q_sh + d] : 0.f;
    }
  }

  // Which slots of this block's tiles count: one ballot per tile, the
  // slot positions of up to MASK_BATCH tiles a warp loaded at once.
  const int64_t pos = *p.pos;
  for (int j0 = warp; j0 < n_my; j0 += (C::WARPS + 1) * MASK_BATCH) {
    int64_t sp[MASK_BATCH];
#pragma unroll
    for (int u = 0; u < MASK_BATCH; ++u) {
      const int j = j0 + u * (C::WARPS + 1);
      const int64_t slot = ((int64_t)split_x + (int64_t)j * S) * TILE + lane;
      sp[u] = (j < n_my && slot < p.W) ? (int64_t)p.slot_pos[slot * p.sp_s] : -1;
    }
#pragma unroll
    for (int u = 0; u < MASK_BATCH; ++u) {
      const int j = j0 + u * (C::WARPS + 1);
      const bool ok = sp[u] >= 0 && sp[u] <= pos && (p.window <= 0 || pos - sp[u] < p.window);
      const unsigned m = __ballot_sync(FULL, ok);
      if (lane == 0 && j < n_my) masks[j] = m;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&ms.kbar[s], 1);
      mbar_init(&ms.vbar[s], 1);
      mbar_init(&ms.ebar[s], C::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // init before use
  }
  if (hdp > hd) {                                // zero columns hd..hdp of every ring row
    for (int i = tid; i < C::STAGES * 2 * TILE * (hdp - hd); i += C::THREADS) {
      const int r = i / (hdp - hd);
      ring[r * ld + hd + (i - r * (hdp - hd))] = 0.f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // The ring: buffer s holds K [32][ld] then V [32][ld].  The copying warp
  // fills the buffers in turn, tile after tile, with bulk copies that
  // complete on kbar[s] and vbar[s], and refills a buffer once the compute
  // warps have arrived on ebar[s]; it never waits for their arithmetic.
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float acc[C::PER_WARP][4];
#pragma unroll
  for (int i = 0; i < C::PER_WARP; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  if (copier) {
    int it = 0;
    for (int jl = next_tile(masks, 0, n_my); jl < n_my; jl = next_tile(masks, jl + 1, n_my), ++it) {
      const int buf = it % C::STAGES;
      if (it >= C::STAGES) mbar_wait(&ms.ebar[buf], (it / C::STAGES - 1) & 1);
      float* kd = ring + 2 * buf * TILE * ld;
      fill_tile(kd, kd + TILE * ld, &ms.kbar[buf], &ms.vbar[buf], kb, vb,
                ((int64_t)split_x + (int64_t)jl * S) * TILE, masks[jl], p, ld);
    }
  } else {
    uint4 qh[C::PER_WARP], ql[C::PER_WARP];
#pragma unroll
    for (int k = 0; k < C::PER_WARP; ++k) {
      split(qx[k][0], qh[k].x, ql[k].x);
      split(qx[k][1], qh[k].y, ql[k].y);
      split(qx[k][2], qh[k].z, ql[k].z);
      split(qx[k][3], qh[k].w, ql[k].w);
    }

    // Online softmax state of rows gq and gq + 8 of this m-tile (the same in
    // its W warps); l is the share of the slots this warp scored; acc holds
    // this warp's P V columns: tiles j = wi, wi + W, ... of 8 columns.
    const float scale = LOG2E / sqrtf((float)hd);   // scores in log2 units: exp2f
    const int nt_n = hdp / 8;
    float4* my_sps = sps + (warp * 4) * 32 + lane;           // [group][lane]
    const float4* red_sps = sps + (mt * W * 4 + wi) * 32 + lane;   // group wi, warp 0
    uint4* mt_pf = pf + mt * 4 * 64;                         // [group][hi, lo][lane]
    int it = 0;                                    // tiles done: buffer it % STAGES
    for (int jc = next_tile(masks, 0, n_my); jc < n_my;
         jc = next_tile(masks, jc + 1, n_my), ++it) {
      const int buf = it % C::STAGES;
      const unsigned phase = (it / C::STAGES) & 1;
      const unsigned tmask = masks[jc];
      const float* ks = ring + 2 * buf * TILE * ld;
      const float* vs = ks + TILE * ld;
      mbar_wait(&ms.kbar[buf], phase);             // this tile's K
      {
        // This warp's k-steps of S = Q K^T for all 32 slots: group n's
        // B(d, slot) = K[8 n + gq][d].  Four groups x two accumulators.
        float e[4][2][4] = {};
#pragma unroll
        for (int k = 0; k < C::PER_WARP; ++k) {
          const int kk = wi + k * W;
          if (kk < ks_n) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float* kr = ks + (8 * n + gq) * ld + 8 * kk + tq;
              mma3(e[n], qh[k], ql[k], kr[0], kr[4]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          my_sps[n * 32] = make_float4(e[n][1][0] + e[n][0][0], e[n][1][1] + e[n][0][1],
                                       e[n][1][2] + e[n][0][2], e[n][1][3] + e[n][0][3]);
        }
      }
      compute_sync<32 * C::WARPS>();
      // Warp wi < 4 of each m-tile sums the W partial scores of group wi in
      // warp order and takes the group's max per row.
      const unsigned gm = wi < 4 ? (tmask >> (8 * wi)) & 0xffu : 0u;
      const bool v0 = (gm >> (2 * tq)) & 1u, v1 = (gm >> (2 * tq + 1)) & 1u;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      if (wi < 4) {
        float4 c = red_sps[0];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          const float4 x = red_sps[w * 4 * 32];
          c.x += x.x;
          c.y += x.y;
          c.z += x.z;
          c.w += x.w;
        }
        // rows gq (x, y) and gq + 8 (z, w); slots 2 tq and 2 tq + 1
        s0 = c.x * scale;
        s1 = c.y * scale;
        s2 = c.z * scale;
        s3 = c.w * scale;
        float xa = fmaxf(v0 ? s0 : NEG_INF, v1 ? s1 : NEG_INF);
        float xb = fmaxf(v0 ? s2 : NEG_INF, v1 ? s3 : NEG_INF);
        xa = fmaxf(xa, __shfl_xor_sync(FULL, xa, 1));
        xa = fmaxf(xa, __shfl_xor_sync(FULL, xa, 2));
        xb = fmaxf(xb, __shfl_xor_sync(FULL, xb, 1));
        xb = fmaxf(xb, __shfl_xor_sync(FULL, xb, 2));
        if (tq == 0) {
          ms.mx[mt][wi][gq] = xa;
          ms.mx[mt][wi][gq + 8] = xb;
        }
      }
      compute_sync<32 * C::WARPS>();
      // The tile's max over its 4 groups: some slot counts, so it is a real
      // score, the same in every warp of the m-tile.
      float ta = ms.mx[mt][0][gq], tb = ms.mx[mt][0][gq + 8];
#pragma unroll
      for (int n = 1; n < 4; ++n) {
        ta = fmaxf(ta, ms.mx[mt][n][gq]);
        tb = fmaxf(tb, ms.mx[mt][n][gq + 8]);
      }
      const float na = fmaxf(m_a, ta), nb = fmaxf(m_b, tb);
      const float aa = exp2f(m_a - na), ab = exp2f(m_b - nb);
      m_a = na;
      m_b = nb;
      if (wi < 4) {
        const float p0 = v0 ? exp2f(s0 - na) : 0.f, p1 = v1 ? exp2f(s1 - na) : 0.f;
        const float p2 = v0 ? exp2f(s2 - nb) : 0.f, p3 = v1 ? exp2f(s3 - nb) : 0.f;
        l_a = fmaf(l_a, aa, p0 + p1);
        l_b = fmaf(l_b, ab, p2 + p3);
        // P's A fragment for the slots of group wi.  It wants columns tq and
        // tq + 4; this lane holds slots 2 tq and 2 tq + 1, so in P V column
        // tq stands for slot 2 tq and column tq + 4 for slot 2 tq + 1, and
        // V's B fragment reads those two rows.
        uint4 h, l;
        split(p0, h.x, l.x);
        split(p2, h.y, l.y);
        split(p1, h.z, l.z);
        split(p3, h.w, l.w);
        mt_pf[wi * 64 + lane] = h;
        mt_pf[wi * 64 + 32 + lane] = l;
      }
      mbar_wait(&ms.vbar[buf], phase);             // this tile's V
      compute_sync<32 * C::WARPS>();               // (and P)
      // O += P V over the tile's 4 groups of 8 slots, for this warp's columns.
#pragma unroll
      for (int i = 0; i < C::PER_WARP; ++i) {
        acc[i][0] *= aa;
        acc[i][1] *= aa;
        acc[i][2] *= ab;
        acc[i][3] *= ab;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const unsigned km = (tmask >> (8 * n)) & 0xffu;
        if (!km) continue;                         // those 8 slots: P = 0
        const bool w0 = (km >> (2 * tq)) & 1u, w1 = (km >> (2 * tq + 1)) & 1u;
        const uint4 ph = mt_pf[n * 64 + lane], pl = mt_pf[n * 64 + 32 + lane];
        const float* vr = vs + (8 * n + 2 * tq) * ld + gq;
#pragma unroll
        for (int i = 0; i < C::PER_WARP; ++i) {
          const int j = wi + i * W;
          if (j < nt_n) {
            mma_pv(acc[i], ph, pl, w0 ? vr[8 * j] : 0.f, w1 ? vr[8 * j + ld] : 0.f);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ms.ebar[buf]);  // this warp is done with the buffer
      compute_sync<32 * C::WARPS>();               // the scores and P are free
    }
  }

  // The block's partial: m as it stands (the same in the m-tile's warps), l
  // summed over its 4 scoring warps in warp order, acc written by the warp
  // that owns each column.  A block that saw no slot that counts has m =
  // NEG_INF, l = 0, acc = 0.
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  if (!copier && wi < 4 && tq == 0) {
    ms.lw[mt][wi][gq] = l_a;
    ms.lw[mt][wi][gq + 8] = l_b;
  }
  // acc[g][hd]: with one split in shared memory (the ring is used up), else
  // straight into the workspace, rows (bk * S + split) * g + j.
  float* bacc = reinterpret_cast<float*>(ring);
  const int64_t n_rows = (int64_t)gridDim.y * S * g;
  float* ws_acc = p.ws;
  float* ws_m = ws_acc + n_rows * hd;
  float* ws_l = ws_m + n_rows;
  const int64_t prow = (bk * S + split_x) * g;
  float* dst = S == 1 ? bacc : ws_acc + prow * hd;
  const int ra = mt * 16 + gq, rb = ra + 8;
#pragma unroll
  for (int i = 0; i < C::PER_WARP; ++i) {
    const int col = 8 * (wi + i * W) + 2 * tq;
    if (!copier && col < hd) {                   // hd is a multiple of 4: both or neither
      float2* da = reinterpret_cast<float2*>(dst + ra * hd + col);
      float2* db = reinterpret_cast<float2*>(dst + rb * hd + col);
      if (ra < g) *da = make_float2(acc[i][0], acc[i][1]);
      if (rb < g) *db = make_float2(acc[i][2], acc[i][3]);
    }
  }
  if (!copier && wi == 0 && tq == 0) {
    if (ra < g) ms.rowM[ra] = m_a;
    if (rb < g) ms.rowM[rb] = m_b;
  }
  __syncthreads();
  if (tid < g) {
    const int m = tid >> 4, r = tid & 15;
    ms.rowL[tid] = ((ms.lw[m][0][r] + ms.lw[m][1][r]) + ms.lw[m][2][r]) + ms.lw[m][3][r];
  }

  __syncthreads();
  float* o = p.o + (b * p.H + kh * g) * hd;
  if (S == 1) {                                  // the block's partial is the answer
    for (int e = tid; e < g * hd4; e += C::THREADS) {
      const int j = e / hd4, c = 4 * (e - j * hd4);
      write_out(o, hd, j, c, load4(bacc + j * hd + c), ms.rowM[j], ms.rowL[j], vb, p.W, p.v_ss);
    }
    return;
  }

  // With its m and l, every block's partial is in the workspace; the S
  // blocks of this (batch, KV head) meet at a barrier: the last to count
  // resets the counter and moves the generation on.  The launch is
  // cooperative, so all of them are resident and the wait ends.
  if (tid < g) {
    ws_m[prow + tid] = ms.rowM[tid];
    ws_l[prow + tid] = ms.rowL[tid];
  }
  __syncthreads();
  if (tid == 0) {
    // One 64-bit word per (batch, KV head): the count below, the
    // generation above.  The last to count adds 2^32 - S: the count goes
    // back to 0 and the generation on, in one atomic.
    unsigned long long* word = reinterpret_cast<unsigned long long*>(p.counters) + bk;
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
  // S partials.  Element e is taken by P consecutive lanes (P a power of
  // two), lane q folding splits q, q + P, ... into a running (m, l, acc)
  // as the online softmax does; the P folds are then merged by a shuffle
  // butterfly, and lane 0's sequence of merges is the same whichever block
  // came last: two launches give the same bits.
  const int n_el = g * hd4;
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
        const int64_t row = (bk * S + n) * g + j;
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

template <int MT, int NT>
int launch(const Params& p, int64_t BK, int device, cudaStream_t stream) {
  using C = Cfg<MT, NT>;
  const Layout<MT, NT> lay(p.hd, p.g, p.n_my_max);
  static int smem_set[MAX_DEVICES] = {};
  if (lay.total > smem_set[device]) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<MT, NT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               lay.total);
    if (e != cudaSuccess) {
      cudaGetLastError();                        // (not left for the next call to read)
      return (int)e;
    }
    smem_set[device] = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.splits, (unsigned)BK, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;   // the splits meet at a barrier
  attr[0].val.cooperative = p.splits > 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_attention_kernel<MT, NT>, p);
  const cudaError_t last = cudaGetLastError();   // (and clears a refused launch's error)
  return (int)(e != cudaSuccess ? e : last);
}

template <int NT>
int by_group(const Params& p, int64_t BK, int device, cudaStream_t stream) {
  return p.g <= 16 ? launch<1, NT>(p, BK, device, stream)
                   : launch<2, NT>(p, BK, device, stream);
}

}  // namespace

// q: (B, 1, H, hd) with (batch, head) strides q_sb, q_sh; k and v: (B, W,
// K, hd) with (batch, slot, head) strides; all fp32 with a contiguous last
// dimension; hd a multiple of 4, at most 256; g = H / K at most 32; every
// stride a multiple of 4 and every pointer 16-byte aligned.  slot_pos:
// (W,) int32 with stride sp_s; pos: one int32, both in device memory.  o:
// (B, 1, H, hd) contiguous fp32.  The slots are dealt in 32-slot tiles to
// `splits` blocks per (batch, KV head) (at most MAX_TILES_PER_SPLIT tiles
// a split; with splits > 1 the launch is cooperative, so all B * K * splits
// blocks must fit on the card at once).  ws: fp32 workspace of B * K *
// splits * g * (hd + 2) floats (unused with one split); counters: B * K
// 64-bit words (8-byte aligned), zero before the first launch, left ready
// for the next.
// window <= 0 means no window.  One launch on `stream`; returns its
// cudaError_t (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* slot_pos, const void* pos, void* o, void* ws,
                                void* counters, int64_t B, int64_t W, int64_t H, int64_t K,
                                int64_t hd, int64_t q_sb, int64_t q_sh, int64_t k_sb,
                                int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                int64_t v_sh, int64_t sp_s, int64_t window, int64_t splits,
                                int device, void* stream) {
  const int64_t g = H / K;
  const int64_t n_tiles = (W + TILE - 1) / TILE;
  if (device < 0 || device >= MAX_DEVICES || hd % 4 || hd <= 0 || hd > MAX_HD || g < 1 ||
      g > MAX_GROUP || splits < 1 || splits > n_tiles ||
      (n_tiles + splits - 1) / splits > MAX_TILES_PER_SPLIT) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.slot_pos = static_cast<const int*>(slot_pos);
  p.pos = static_cast<const int*>(pos);
  p.o = static_cast<float*>(o);
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
  p.hd = (int)hd;
  p.splits = (int)splits;
  p.n_my_max = (int)((n_tiles + splits - 1) / splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return by_group<8>(p, B * K, device, s);
  if (hd <= 128) return by_group<16>(p, B * K, device, s);
  return by_group<32>(p, B * K, device, s);
}
