// Helpers shared by the ReparamConv kernels (rc_dw_gelu.cu, rc_stats.cu,
// rc_fused.cu): dtype conversion, the activations in float32, and the
// fixed-order reduction of per-block partial sums that keeps every sum the
// kernels return bitwise repeatable (no atomics).

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

// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), as F.gelu(approximate='tanh')
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// x relu6(x + 3) / 6, as F.hardswish
__device__ __forceinline__ float hardswish(float x) {
  return x * fminf(fmaxf(x + 3.f, 0.f), 6.f) / 6.f;
}

constexpr int kReduceThreads = 256;  // a power of two

// One block per output o: out[o] = sum over k < n of
// part[(o / C) * outer + o % C + k * stride], strided over the threads and
// then summed in a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ part, float* __restrict__ out, int n, int C,
                long long outer, long long stride) {
  __shared__ float red[kReduceThreads];
  const int o = blockIdx.x;
  const int tid = threadIdx.x;
  const float* base = part + (long long)(o / C) * outer + o % C;
  float s = 0.f;
  for (int k = tid; k < n; k += kReduceThreads) s += base[(long long)k * stride];
  red[tid] = s;
  __syncthreads();
  for (int st = kReduceThreads / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) out[o] = red[0];
}

// The depthwise kernels (rc_dw_gelu.cu, rc_stats.cu) tile the map: a block
// owns kTileRows x kTileCols output pixels of one image and a chunk of at
// most kMaxChunk channels. It first copies the tile's 5x5-window halo of e,
// (kTileRows + 4) x (kTileCols + 4) pixels of the chunk, into shared memory
// as float32, zero outside the image: every global load of the block is
// issued at once, and each element is read from device memory once per
// block rather than once per window that covers it. Then thread (row,
// channel), channel fastest, slides a 5x5 window in registers along its row
// of the tile: 5 shared-memory loads per output.
constexpr int kTileRows = 8;
constexpr int kTileCols = 16;
constexpr int kHaloRows = kTileRows + 4;
constexpr int kHaloCols = kTileCols + 4;
constexpr int kMaxChunk = 32;

struct Tiling {
  int ck;       // channels per chunk: C, or 32 at a time above 32
  int threads;  // kTileRows * ck
  int ntx;      // tiles along W
  int ntiles;   // tiles per image
  int nchunk;   // channel chunks
};

inline Tiling tiling(int H, int W, int C) {
  Tiling t;
  t.ck = C < kMaxChunk ? C : kMaxChunk;
  t.threads = kTileRows * t.ck;
  t.ntx = (W + kTileCols - 1) / kTileCols;
  t.ntiles = ((H + kTileRows - 1) / kTileRows) * t.ntx;
  t.nchunk = (C + t.ck - 1) / t.ck;
  return t;
}

inline bool tiling_ok(int B, int H, int W, int C) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0) return false;
  const long long tiles =
      (long long)((H + kTileRows - 1) / kTileRows) * ((W + kTileCols - 1) / kTileCols);
  return tiles <= 0x7fffffffLL && (C + kMaxChunk - 1) / kMaxChunk <= 65535;
}

// Floats between two halo rows in shared memory: kHaloCols * ck, padded to
// ck (mod 32), so that a warp whose lanes span two tile rows reads 32
// distinct banks.
__host__ __device__ inline int halo_row_stride(int ck) {
  const int base = kHaloCols * ck;
  return base + ((ck - base % 32) % 32 + 32) % 32;
}

// Copy the halo of the tile whose first output is (tr0, tc0), channels
// [ch0, ch0 + nk), of image b of e (B, H, W, C) into es[hr * rs + hc * ck +
// k] as float32, zero outside the image. The block has kTileRows * ck
// threads: thread (q, k) copies channel k of halo pixels q, q + kTileRows,
// ..., so a warp reads runs of consecutive channels and no thread divides
// by a run-time value. (Unrolling this loop fully, every load of a thread
// in flight at once, measured slower on the H100: its registers cost more
// occupancy than it gained.)
template <typename T>
__device__ __forceinline__ void load_halo(const T* __restrict__ e, float* es, int H, int W, int C,
                                          int b, int tr0, int tc0, int ch0, int nk, int ck,
                                          int rs) {
  const int k = threadIdx.x % ck;
  if (k >= nk) return;
  const T* eb = e + (int64_t)b * H * W * C + ch0 + k;
  for (int p = threadIdx.x / ck; p < kHaloRows * kHaloCols; p += kTileRows) {
    const int hr = p / kHaloCols;
    const int hc = p - hr * kHaloCols;
    const int rr = tr0 - 2 + hr;
    const int cc = tc0 - 2 + hc;
    es[hr * rs + hc * ck + k] =
        (rr >= 0 && rr < H && cc >= 0 && cc < W) ? to_f32(eb[((int64_t)rr * W + cc) * C]) : 0.f;
  }
}

}  // namespace lmnet_rc
