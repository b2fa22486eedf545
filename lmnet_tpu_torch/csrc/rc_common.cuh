// Helpers shared by the ReparamConv kernels (rc_dw_gelu.cu, rc_stats.cu,
// rc_fused.cu) and the NATT kernel (natt_flat.cu): dtype conversion, the
// activations in float32, vector copies between device and shared memory,
// and the fixed-order reductions of per-block partial sums that keep every
// sum the kernels return bitwise repeatable (no atomics).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lmnet_rc {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 0.5 x (1 + tanh u), u = sqrt(2/pi) (x + 0.044715 x^3), as
// F.gelu(approximate='tanh'), computed as the equal x / (1 + exp(-2u)) =
// x / (1 + 2^v), v = -2 u log2(e) = x (c + 0.044715 c x^2): one MUFU ex2 and
// a fast divide in place of tanhf's instruction sequence. For very negative
// x, 2^v overflows to inf and the quotient is 0, the limit.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float c = -2.f * 0.7978845608028654f * 1.4426950408889634f;
  const float v = x * fmaf(0.044715f * c, x * x, c);
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(v));
  return __fdividef(x, 1.f + p);
}

// bias + sum_{i,j} w[i*5 + j] win[R0 + i][j] over the 5 rows of an NR-row
// window from row R0: five independent row sums added in a fixed order, so
// that the FMAs form chains of 5 and not one of 25 (a warp has the next
// row's FMAs to issue while one row's are in flight)
template <int R0, int NR>
__device__ __forceinline__ float dw5x5(float bias, const float (&w)[25],
                                       const float (&win)[NR][5]) {
  static_assert(R0 + 5 <= NR, "the window has 5 rows from R0");
  float r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    r[i] = w[i * 5] * win[R0 + i][0];
#pragma unroll
    for (int j = 1; j < 5; ++j) r[i] = fmaf(w[i * 5 + j], win[R0 + i][j], r[i]);
  }
  return bias + ((r[0] + r[1]) + (r[2] + r[3])) + r[4];
}

// x relu6(x + 3) / 6, as F.hardswish (the division as a multiply: an IEEE
// divide by 6 is a long instruction sequence)
__device__ __forceinline__ float hardswish(float x) {
  return x * fminf(fmaxf(x + 3.f, 0.f), 6.f) * (1.f / 6.f);
}

// The widest copy unit, of 2, 4, 8 or 16 bytes, that divides n bytes: the
// vector a channel run of n bytes (and every run starting at a multiple of
// n) can be copied in with aligned loads and stores.
__host__ __device__ inline int vec_bytes(long long n) {
  const long long low = n & -n;
  return low >= 16 ? 16 : (int)low;
}

// Copy vb bytes (2, 4, 8 or 16; both addresses aligned to vb) from device
// memory to shared memory, or zeros where !valid (src is then not read).
// 4 to 16 bytes go through cp.async (wait with cp_async_wait_all), 2 bytes
// through a register.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int vb, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? vb : 0;
  switch (vb) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
      break;
    default:
      *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Store vb bytes (2, 4, 8 or 16; both addresses aligned to vb) from shared
// to device memory in one vector store.
__device__ __forceinline__ void store_vec(void* dst, const void* src, int vb) {
  switch (vb) {
    case 16: *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src); break;
    case 8: *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src); break;
    case 4: *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src); break;
    default: *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// One warp per output o (warps of a block on consecutive o): out[o] = sum
// over k < n of part[(o / C) * outer + o % C + k * stride], the lanes
// strided over k, then a fixed shuffle tree, so two calls give bitwise-equal
// sums. Launch with ceil(nout / 8) blocks of 256 threads. For per-tile
// partials this has fewer, fuller blocks than reduce_partials' block per
// output.
constexpr int kWarpsPerReduce = 8;

__global__ void __launch_bounds__(32 * kWarpsPerReduce)
reduce_partials_warp(const float* __restrict__ part, float* __restrict__ out, int nout, int n,
                     int C, long long outer, long long stride) {
  const int o = blockIdx.x * kWarpsPerReduce + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (o >= nout) return;  // a whole warp
  const float* base = part + (long long)(o / C) * outer + o % C;
  float s = 0.f;
  for (int k = lane; k < n; k += 32) s += base[(long long)k * stride];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[o] = s;
}

// Channels a block of the depthwise kernels (rc_dw_gelu.cu, rc_stats.cu)
// takes: all C up to 32; above, the largest of 32, 24, 16 and 8 that
// divides C (C = 48: two chunks of 24, not 32 and a half-idle 16), else 32
// with a partial last chunk.
constexpr int kChunk = 32;

__host__ __device__ inline int chunk_channels(int C) {
  if (C <= kChunk) return C;
  for (int ck = kChunk; ck >= 8; ck -= 8) {
    if (C % ck == 0) return ck;
  }
  return kChunk;
}

}  // namespace lmnet_rc
