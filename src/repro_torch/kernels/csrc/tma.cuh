// Hopper's Tensor Memory Accelerator and mbarriers, shared by the kernels
// that fill shared-memory rings by TMA (flash_attention_bf16.cu,
// decode_attention_bf16.cu): the barrier operations, a 4-d box load, and
// the tensor map of a (B, S, K, hd) bf16 operand read in boxes of 64
// columns by 64 rows with a 128-byte swizzle.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

constexpr int PANEL = 64;              // bf16 columns of one 128-byte swizzled row
constexpr int BOX_ROWS = 64;           // rows (keys, slots) of one box
constexpr int PANEL_BYTES = BOX_ROWS * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes (a fault in the pipeline) traps after 10 s
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint64_t t0 = 0;
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 1024 == 0) {
      const uint64_t t = global_ns();
      if (t0 == 0) {
        t0 = t;
      } else if (t - t0 > 10000000000ull) {
        __trap();
      }
    }
  }
}

// One TMA box of the 4-d map (hd, heads, rows, batch) into shared memory.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the library
// does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (hd, K, S, B) view of a bf16 operand through its (head, row, batch)
// strides (elements), in boxes of PANEL columns by BOX_ROWS rows, 128-byte
// swizzled: row r's 16-byte chunk c of a box lands at r * 128 + ((c ^ r % 8)
// * 16).  Rows past S and columns past hd arrive as zeros.
inline int make_map(CUtensorMap* map, const void* base, int64_t hd, int64_t K, int64_t S,
                    int64_t B, int64_t s_h, int64_t s_s, int64_t s_b) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)K, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {PANEL, 1, BOX_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tma
