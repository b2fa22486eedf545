// Shared by the kernels that load their tiles with Hopper's Tensor Memory
// Accelerator (TMA): upsample_flat.cu (B7) and nat_kernel.cu (B3). The host
// side encodes a tiled tensor map (cuTensorMapEncodeTiled, looked up
// through cudaGetDriverEntryPoint, so that the libraries link no libcuda);
// the device side waits on an mbarrier that the copy completes.
//
// The rules a map must keep (checked by the callers' plans, which the CPU
// tests hold): the global address and every stride a multiple of 16 bytes;
// each box dimension at most 256 elements; the box's inner row a multiple of
// 16 bytes, and its start along the inner dimension on 16 bytes too (a copy
// that starts off 16 bytes never completes); the shared-memory destination
// 128-byte aligned. The barrier's
// expected bytes count the whole box, its zero-filled part included: a box
// may reach past the map's end (or start before it, at a negative
// coordinate), and the copy fills those elements with zeros.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda function is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace lmnet_tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once; null where it is not found.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Encode a tiled map of `rank` dimensions (dims[0] innermost, in elements
// of es bytes: 2 = bf16, 4 = float32) over global memory at base;
// strides[i] is the byte stride of dimension i + 1; box the elements a copy
// moves along each dimension. No swizzle, no interleave, zero fill out of
// bounds. Returns 0, or the negated CUresult of a failed encode (-999 when
// no encoder is found), so that callers can tell it from a CUDA runtime
// error.
inline int encode(CUtensorMap* map, int es, int rank, const void* base, const uint64_t* dims,
                  const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -999;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUtensorMapDataType type =
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The first 128-byte boundary at or after p (a shared-memory pointer): the
// TMA destination's alignment. A block's dynamic shared memory is sized
// with 128 bytes to spare for it.
__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128u - (smem_addr(p) & 127u)) & 127u);
}

// One thread: initialise a barrier that completes when `count` threads have
// arrived and its expected bytes have landed, and make it visible to the
// copy engine.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on the barrier and expect `bytes` more from the copies issued on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed (its
// first phase is parity 0, the next 1, and so on). A copy that never lands
// (expected bytes that no copy delivers) traps after about ten seconds, so
// that a fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// One thread: copy the box at (c0, c1[, c2]) of the map into dst, completing
// on bar (whose expected bytes the caller has set).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

}  // namespace lmnet_tma
