// bf16 tensor-core helpers shared by the kernels that run their products
// on mma.sync (rc_fused.cu, natt_flat.cu): ldmatrix of A fragments from
// shared memory, 32-bit B-fragment loads, and m16n8k16 bf16 x bf16 -> f32
// products, the sum kept in registers.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane l = 4 g + t (g = l / 4,
// t = l % 4) holds A rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9
// (ldmatrix_x4 from the row pointers of lanes 0-15 at column 0 and lanes
// 16-31 at column 8); B column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9 (two
// 32-bit loads from a [n][k] array); and the sum's rows g (d[0], d[1]) and
// g + 8 (d[2], d[3]) at columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lmnet_tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a b: a 16x16 bf16 A fragment, a 16x8 B fragment, float32 d
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8 of M x N) += A B over K = k: lane l's A row pointer (row
// l % 16, column (l / 16) * 8) and B row pointer (row n = l / 4, column
// 2 (l % 4)) of [row][k] bf16 arrays in shared memory
__device__ __forceinline__ void mma_k(float (&acc)[4], const bf16* arow, const bf16* brow,
                                      int k) {
  for (int k0 = 0; k0 < k; k0 += 16) {
    unsigned a[4];
    ldmatrix_x4(a, arow + k0);
    mma_bf16(acc, a, ld32(brow + k0), ld32(brow + k0 + 8));
  }
}

}  // namespace lmnet_tc
