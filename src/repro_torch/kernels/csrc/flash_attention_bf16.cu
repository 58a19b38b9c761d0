// Blocked online-softmax GQA attention with causal and sliding-window masks
// (FlashAttention's scheme) for bf16 operands, on Hopper's tensor cores:
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(hd)) v[b, j, h / g]
//
// over the keys j that query i sees: with p = i + offset (offset = Sk - Sq
// aligns the sequence ends), j < Sk, j <= p if causal, p - j < window if
// window > 0.  The fp32 path is flash_attention.cu.
//
// Replaces the TPU kernel flash_attention_bkh
// (src/repro/kernels/flash_attention.py:89, wrapper src/repro/kernels/ops.py:57)
// for bf16 inputs, which that kernel casts to fp32 before both products.
//
// Bound on the card: operations.  Each unmasked (query, key) pair costs
// 4 * hd flops (q . k and p * v): at InternVL2-26B's prefill (B = 2,
// S = 4096, 48 query heads over 8 KV heads of 128, causal) 805,502,976
// pairs, 0.417 ms at the 989 TFLOP/s of bf16 products with fp32 sums; its
// 234,881,024 bytes take 0.07 ms.  The CUDA-core kernel that ran bf16
// before (the operands converted to fp32 on the way into shared memory,
// fp32 FMAs) took 13.27-13.76 ms there, 2.2 times its own fp32-rate
// bound: only the tensor cores move it.
//
// Numerics.  bf16 x bf16 products are exact in fp32, so S = Q K^T with
// fp32 sums differs from the reference's fp32 arithmetic only in the
// order of the sums.  P is not bf16: rounded to one bf16 for P V it moves
// the output by ~1e-3 of its scale before the store (a quarter of a bf16
// ulp) and rounds 39 % of the outputs away from the rounded reference
// (tests/test_torch_flash_attention_bf16.py, a causal group of 6 over
// 2,048 keys).  Each P is split into hi = bf16(p) and lo = bf16(p - hi)
// (p = hi + lo to ~2^-16 relative), and both products go into the same
// fp32 accumulator: twice the P V tensor-core work (1.5 times the whole),
// ~2e-6 of the scale before the store.
//
// The design:
//   - One block serves one (batch, KV head).  Its rows are consecutive
//     (query position, head) pairs of the flattened (Sq, g) index, so each
//     K/V tile is read once for all g query heads of the group; g need not
//     divide the rows.  Blocks are issued heaviest first (last positions
//     first).  The block's live keys come from its first and last
//     positions (causal, window, offset); tiles outside them are never
//     loaded, and only the tiles at the edges of that range are masked.
//   - Warp specialisation: NWG consumer warpgroups of 64 rows each (2 for
//     the large launches; 1 when the wrapper shrinks the rows a block so
//     that a short prompt still gives the card a block per SM; then ROWS
//     of its 64 rows are live, the rest zero and never stored), and a
//     producer whose first thread issues the copies.  With 2 consumers
//     the producer is a whole warpgroup (384 threads, 168 registers each
//     at launch): setmaxnreg acts on whole warpgroups (a lone producer
//     warp's faulted as an illegal instruction), and moves the producer
//     down to 24 registers and the consumers up to 240.  With 1 consumer
//     the producer is one warp (160 threads, up to 255 registers each),
//     and nothing needs moving.  HD = 256 takes 1 consumer only: its
//     128-register O fragment spilled in a two-consumer block even at 240.
//   - Q: loaded once by the consumers' threads, 16 bytes a thread, straight
//     into the 128-byte-swizzled K-major layout that wgmma reads (a TMA box
//     cannot follow the flattened rows when g does not divide 64, as g = 6
//     does not).
//   - K and V: a ring of STAGES tiles of 64 keys, filled by TMA from 4-d
//     tensor maps over the (hd, K, Sk, B) view through the operands'
//     strides, with a 128-byte swizzle: a box is 64 columns by 64 keys, a
//     128- or 256-wide row two or four boxes; keys past Sk and columns
//     past hd arrive as zeros.  K and V of a stage have a full barrier each
//     (so S of a tile starts before its V has landed) and share an empty
//     barrier that each consumer warp arrives on after its P V.
//   - S = Q K^T: wgmma m64n64k16, A = Q and B = the K tile, both K-major in
//     shared memory; the scale log2(e) / sqrt(hd) after.
//   - Online softmax in fp32 on the accumulator fragment: a thread holds 2
//     rows x 16 keys; the row max takes 2 shuffles within the quad.
//   - O += P V: wgmma m64n{HD}k16 with P's hi and lo as the register A
//     operand (the S fragment is laid out as the A fragment, so P never
//     leaves the registers), B = the V tile, [key][hd] in shared memory, MN-
//     major for B (the transpose bit).
//   - Output: O / max(l, 1e-30), stored as bf16 pairs by plain stores.
//   - Instantiations: HD = 64, 128, 256 (hd a multiple of 8, at most 256,
//     takes the smallest HD >= hd; the TMA box zero-fills the columns past
//     hd) by NWG = 1, 2 (HD = 256: 1).  ptxas -v: 147, 168, 162, 168 and
//     231 registers, no spill.
//
// Measured (chip_smoke.py phase 17 (c), CUDA-event median, L2 flushed;
// NVIDIA H100 80GB HBM3, 700.00 W): 1.497 ms at InternVL2-26B's shape,
// 3.6 times the bound, 2.15 times sdpa(is_causal=True) (0.697 ms); within
// 0.56 bf16 ulp of the plain version there.  What it leaves on the table:
// each warpgroup waits for its Q K^T before its softmax and for its P V
// before the next tile's Q K^T (no overlap of one tile's softmax with
// another's products inside a warpgroup), and P V runs twice.
//
// Masked scores are NEG_INF = -2e38, the reference's finite value: in a
// visited tile a row whose keys are all masked gets exp(NEG_INF - NEG_INF)
// = 1 per key, which the row's first live tile wipes with alpha = 0, as in
// the reference.  No atomics: two launches agree bit for bit.

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

constexpr int BK = tma::BOX_ROWS;      // keys per tile
constexpr int PANEL = tma::PANEL;      // bf16 columns of one 128-byte swizzled row
constexpr int PANEL_BYTES = tma::PANEL_BYTES;  // 64 rows of a panel
constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

// Threads of the producer: a warpgroup beside two consumers (setmaxnreg),
// a warp beside one.
template <int NWG> constexpr int producer_threads() { return NWG == 2 ? 128 : 32; }

template <int HD> struct Cfg {
  static constexpr int PANELS = HD / PANEL;
  static constexpr int TILE_BYTES = PANELS * PANEL_BYTES;  // 64 rows x HD bf16
  static constexpr int STAGES = HD == 256 ? 2 : HD == 128 ? 3 : 4;
};

// Dynamic shared memory of a block: NWG Q tiles, STAGES K and V tiles, the
// barriers, and the slack that aligns the tiles to 1,024 bytes.
template <int HD, int NWG>
constexpr int smem_bytes() {
  using C = Cfg<HD>;
  return 1024 + NWG * C::TILE_BYTES + 2 * C::STAGES * C::TILE_BYTES + 3 * C::STAGES * 8;
}

// wgmma's shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Tie registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler neither reads an accumulator before the
// wait nor reuses an A register while the product may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}


// D (64 x 64, fp32) (+)= A (64 x 16, smem) B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// p = hi + lo for a pair of P values (columns c, c + 1), each half bf16.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// grid: row_tiles * B * K blocks of 128 * NWG + producer_threads<NWG>()
// threads; dynamic shared memory smem_bytes<HD, NWG>().  A block's rows:
// NWG * rows (rows <= 64 a consumer warpgroup).
template <int HD, int NWG>
__global__ void __launch_bounds__(128 * NWG + producer_threads<NWG>(), 1)
flash_attention_kernel_bf16_wgmma(const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __nv_bfloat16* __restrict__ q,
                                  __nv_bfloat16* __restrict__ o, int64_t Sq, int64_t Sk,
                                  int64_t H, int64_t K, int64_t group, int hd, int rows,
                                  int64_t row_tiles, int64_t heads, int64_t q_sb,
                                  int64_t q_ss, int64_t q_sh, int causal, int64_t window,
                                  int64_t offset) {
  using C = Cfg<HD>;
  constexpr int STAGES = C::STAGES;
  constexpr int TILE = C::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* const qs = smem;                          // [NWG] Q tiles
  uint8_t* const ks = qs + NWG * TILE;               // [STAGES] K tiles
  uint8_t* const vs = ks + STAGES * TILE;            // [STAGES] V tiles
  uint64_t* const bars = reinterpret_cast<uint64_t*>(vs + STAGES * TILE);
  const uint32_t full_k = smem_u32(bars);            // + 8 s
  const uint32_t full_v = smem_u32(bars + STAGES);
  const uint32_t empty = smem_u32(bars + 2 * STAGES);

  // heaviest row tiles (last positions) first
  const int64_t bk = blockIdx.x % heads;
  const int64_t tile = row_tiles - 1 - blockIdx.x / heads;
  const int64_t b = bk / K, kh = bk % K;
  const int64_t n_rows = Sq * group;
  const int64_t f0 = tile * NWG * rows;
  const int64_t f_end = f0 + NWG * rows < n_rows ? f0 + NWG * rows : n_rows;

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

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);             // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 4 * NWG) {
    // ---- producer: K and V tiles by TMA, from its first thread ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * NWG) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const int k0 = (int)((kt0 + it) * BK);
        mbar_expect_tx(full_k + 8 * s, TILE);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma::load_box(smem_u32(ks + s * TILE + p * PANEL_BYTES), &k_map, full_k + 8 * s,
                        p * PANEL, (int)kh, k0, (int)b);
        mbar_expect_tx(full_v + 8 * s, TILE);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma::load_box(smem_u32(vs + s * TILE + p * PANEL_BYTES), &v_map, full_v + 8 * s,
                        p * PANEL, (int)kh, k0, (int)b);
      }
    }
  } else {
    // ---- consumer warpgroups ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2;
    const int t = threadIdx.x & 127;
    uint8_t* const qw = qs + wg * TILE;
    const int64_t fw = f0 + (int64_t)wg * rows;      // this warpgroup's first row
    {
      // Q rows fw .. fw + rows - 1 (zeros past them, past n_rows and past
      // hd), 16 bytes a thread, into the swizzled layout: row r's 16-byte
      // chunk c of panel p at p * PANEL_BYTES + r * 128 + ((c ^ r % 8) * 16)
      const __nv_bfloat16* const qb = q + b * q_sb + kh * group * q_sh;
      constexpr int CHUNKS = HD / 8;
      for (int i = t; i < 64 * CHUNKS; i += 128) {
        const int r = i / CHUNKS, c = i % CHUNKS;
        const int64_t f = fw + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && f < n_rows && 8 * c < hd)
          val = *reinterpret_cast<const uint4*>(qb + (f / group) * q_ss + (f % group) * q_sh +
                                                8 * c);
        *reinterpret_cast<uint4*>(qw + (c / 8) * PANEL_BYTES + r * 128 +
                                  (((c % 8) ^ (r % 8)) * 16)) = val;
      }
      // the generic-proxy stores above, visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }

    // this thread's rows of the fragments: r0 and r0 + 8 of the warpgroup's
    // 64; its columns 8 j + 2 (lane % 4) + {0, 1} of each 8-column group j
    const int r0 = 16 * (warp & 3) + (lane >> 2);
    const int cq = 2 * (lane & 3);
    int pos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pos[h] = (int)((fw + r0 + 8 * h) / group + offset);
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const float scale = LOG2E / sqrtf((float)hd);
    const uint32_t q_addr = smem_u32(qw);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const int parity = (it / STAGES) & 1;
      const int64_t k0 = (kt0 + it) * BK;
      const uint32_t k_addr = smem_u32(ks + s * TILE);
      const uint32_t v_addr = smem_u32(vs + s * TILE);

      // S = Q K^T: HD / 16 products of 16 columns
      float sc[32];
      mbar_wait(full_k + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
        wgmma_ss_n64(sc, desc(q_addr + off, 16, 1024), desc(k_addr + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale; mask only the tiles at the edges of the block's key range
      if (k0 < all_lo || k0 + BK - 1 > all_hi) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = (int)k0 + 8 * j + cq + (e & 1);
            const int p = pos[e >> 1];
            bool live = key < Sk;
            if (causal) live = live && key <= p;
            if (window > 0) live = live && p - key < window;
            sc[4 * j + e] = live ? sc[4 * j + e] * scale : NEG_INF;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale;
      }

      // online softmax on the two rows (entries e < 2: row r0, else r0 + 8)
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], sc[4 * j + e]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        const float m_new = fmaxf(m[h], mt[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
          sc[4 * j + e] = p;
          ls[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

      // P as the A fragments of the 4 key slices of 16: slice u holds
      // columns 16 u + cq (+1) and 16 u + 8 + cq (+1) of rows r0, r0 + 8,
      // i.e. the S entries 8 u + 0..7, each split into hi + lo
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split_pair(sc[8 * u + 2 * a], sc[8 * u + 2 * a + 1], phi[u][a], plo[u][a]);

      // O += P V: V's tile [key][hd] is MN-major for B; slice u starts at
      // key 16 u (16 rows of 128 bytes), panels LBO = PANEL_BYTES apart,
      // 8-key groups SBO = 1,024 bytes apart
      mbar_wait(full_v + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t dv = desc(v_addr + u * 16 * 128, PANEL_BYTES, 1024);
        wgmma_rs(acc, phi[u], dv);
        wgmma_rs(acc, plo[u], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(phi);
      fence_regs(plo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // o = acc / max(l, 1e-30): the row sums over the quad's 4 lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = r0 + 8 * h;
      const int64_t f = fw + r;
      if (r >= rows || f >= n_rows) continue;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      __nv_bfloat16* const orow = o + ((b * Sq + f / group) * H + kh * group + f % group) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + cq;
        if (c < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

template <int HD, int NWG>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const void* q, void* o, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, int64_t K, int hd, int rows, const int64_t* st,
           int causal, int64_t window, int64_t offset, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD, NWG>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel_bf16_wgmma<HD, NWG>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t row_tiles = (Sq * (H / K) + NWG * rows - 1) / (NWG * rows);
  const int64_t blocks = row_tiles * B * K;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel_bf16_wgmma<HD, NWG>
      <<<(unsigned)blocks, 128 * NWG + producer_threads<NWG>(), smem, stream>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), Sq, Sk, H,
      K, H / K, hd, rows, row_tiles, B * K, st[0], st[1], st[2], causal, window, offset);
  return (int)cudaGetLastError();
}

template <int HD>
int dispatch(const CUtensorMap& km, const CUtensorMap& vm, const void* q, void* o, int64_t B,
             int64_t Sq, int64_t Sk, int64_t H, int64_t K, int hd, int rows, const int64_t* st,
             int causal, int64_t window, int64_t offset, cudaStream_t stream) {
  if constexpr (HD < 256) {
    if (rows == 128)
      return launch<HD, 2>(km, vm, q, o, B, Sq, Sk, H, K, hd, 64, st, causal, window, offset,
                           stream);
  } else {
    if (rows == 128) return (int)cudaErrorInvalidValue;
  }
  return launch<HD, 1>(km, vm, q, o, B, Sq, Sk, H, K, hd, rows, st, causal, window, offset,
                       stream);
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, K, hd), bf16, each with its own
// (batch, sequence, head) strides in elements (multiples of 8) and a
// contiguous last dimension; hd a multiple of 8, at most 256; every
// pointer 16-byte aligned; H a multiple of K.  o: (B, Sq, H, hd)
// contiguous bf16.  offset is the position of query row 0 (Sk - Sq aligns
// the ends); window <= 0 means no window.  rows: the block's rows (query
// position, head pairs): 128 (two consumer warpgroups of 64; hd <= 128),
// 64, 32 or 16 (one).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t K,
                                    int64_t hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                    int64_t v_ss, int64_t v_sh, int causal, int64_t window,
                                    int64_t offset, int rows, int device, void* stream) {
  if (rows != 128 && rows != 64 && rows != 32 && rows != 16) return (int)cudaErrorInvalidValue;
  if (hd <= 0 || hd > 256 || hd % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap km, vm;
  int err = tma::make_map(&km, k, hd, K, Sk, B, k_sh, k_ss, k_sb);
  if (err) return err;
  err = tma::make_map(&vm, v, hd, K, Sk, B, v_sh, v_ss, v_sb);
  if (err) return err;
  const int64_t st[3] = {q_sb, q_ss, q_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return dispatch<64>(km, vm, q, o, B, Sq, Sk, H, K, (int)hd, rows, st, causal, window,
                        offset, s);
  if (hd <= 128)
    return dispatch<128>(km, vm, q, o, B, Sq, Sk, H, K, (int)hd, rows, st, causal, window,
                         offset, s);
  return dispatch<256>(km, vm, q, o, B, Sq, Sk, H, K, (int)hd, rows, st, causal, window,
                       offset, s);
}
