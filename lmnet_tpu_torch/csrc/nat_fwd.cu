// Neighborhood attention forward, kernel size 3, NATTEN semantics, on the
// flat (B, H, W*C) activation layout.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_flat.py::nat_flat
// (_nat_flat_kernel). It computes the same function, not that kernel's TPU
// layout (lane rolls, 8-row halo edge blocks, stripe policy, base-2 softmax).
//
// For every (b, row, col, head):
//   the 3x3 key window starts at clamp(row-1, 0, H-3), clamp(col-1, 0, W-3)
//   (slid inward at the borders, never padded);
//   logit[i] = scale * <q, k_i> + rpb[head, kr-row+2, kc-col+2];
//   out = sum_i softmax(logit)[i] * v_i.
// Loads are bf16 or f32, the math is f32, the store is in q's dtype, and rpb
// stays f32.
//
// What bounds it on an H100: memory. Per element it reads q, k, v and writes
// out (4 x 2 B in bf16) and does about 36 flops (9 dot-product and 9
// weighted-sum terms), ~5 flops/byte, far below the card's ~295 flops/byte
// ridge. The k/v window re-reads
// (9x) are served from L1/L2, because neighbouring threads read neighbouring
// pixels. The design is the simplest one that is right: one thread per
// (pixel, head), head_dim as a compile-time constant where it is 1, 2, 4 or 8,
// and a runtime loop for any other head_dim. Shared-memory tiling and vector
// loads are later work.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_flat.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// HD > 0: head_dim fixed at compile time (q and the output accumulator live
// in registers). HD == 0: head_dim = hd_rt, read from memory as needed.
template <typename T, int HD>
__global__ void nat_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ rpb,
                               T* __restrict__ out, int B, int H, int W, int heads,
                               int hd_rt, float scale) {
  const int hd = HD > 0 ? HD : hd_rt;
  const int64_t total = (int64_t)B * H * W * heads;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;

  const int head = (int)(t % heads);
  int64_t pix = t / heads;  // (b * H + row) * W + col
  const int col = (int)(pix % W);
  const int row = (int)((pix / W) % H);
  const int64_t C = (int64_t)heads * hd;
  const int64_t img = pix - ((int64_t)row * W + col);  // b * H * W

  const int r0 = min(max(row - 1, 0), H - 3);
  const int c0 = min(max(col - 1, 0), W - 3);
  const float* bias = rpb + head * 25;

  const int64_t qoff = pix * C + (int64_t)head * hd;
  constexpr int NR = HD > 0 ? HD : 1;  // register array length
  float qr[NR];
  if constexpr (HD > 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(q[qoff + d]) * scale;
  }

  float p[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int kr = r0 + i / 3;
    const int kc = c0 + i % 3;
    const int64_t koff = (img + (int64_t)kr * W + kc) * C + (int64_t)head * hd;
    float dot = 0.f;
    if constexpr (HD > 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dot += qr[d] * to_f32(k[koff + d]);
    } else {
      for (int d = 0; d < hd; ++d) dot += to_f32(q[qoff + d]) * to_f32(k[koff + d]);
      dot *= scale;
    }
    p[i] = dot + bias[(kr - row + 2) * 5 + (kc - col + 2)];
  }
  float m = p[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) m = fmaxf(m, p[i]);
  float den = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    p[i] = expf(p[i] - m);
    den += p[i];
  }
  const float inv = 1.f / den;

  if constexpr (HD > 0) {
    float acc[NR];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int64_t voff =
          (img + (int64_t)(r0 + i / 3) * W + (c0 + i % 3)) * C + (int64_t)head * hd;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] += p[i] * to_f32(v[voff + d]);
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) out[qoff + d] = from_f32<T>(acc[d] * inv);
  } else {
    for (int d = 0; d < hd; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const int64_t voff =
            (img + (int64_t)(r0 + i / 3) * W + (c0 + i % 3)) * C + (int64_t)head * hd;
        acc += p[i] * to_f32(v[voff + d]);
      }
      out[qoff + d] = from_f32<T>(acc * inv);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const float* rpb, void* out,
            int B, int H, int W, int heads, int hd, float scale, cudaStream_t stream) {
  const int64_t total = (int64_t)B * H * W * heads;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define LMNET_NAT_LAUNCH(HDC) \
  nat_fwd_kernel<T, HDC><<<blocks, threads, 0, stream>>>(qt, kt, vt, rpb, ot, B, H, W, heads, hd, scale)
  switch (hd) {
    case 1: LMNET_NAT_LAUNCH(1); break;
    case 2: LMNET_NAT_LAUNCH(2); break;
    case 4: LMNET_NAT_LAUNCH(4); break;
    case 8: LMNET_NAT_LAUNCH(8); break;
    default: LMNET_NAT_LAUNCH(0); break;
  }
#undef LMNET_NAT_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; rpb is float32
// (heads, 5, 5)). All tensors contiguous. Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int lmnet_nat_fwd(const void* q, const void* k, const void* v, const void* rpb,
                             void* out, int B, int H, int W, int heads, int hd,
                             float scale, int dtype, void* stream) {
  if (B <= 0 || H < 3 || W < 3 || heads <= 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  if (dtype == 0) {
    launch<float>(q, k, v, r, out, B, H, W, heads, hd, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, r, out, B, H, W, heads, hd, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
