// Neighborhood attention forward, kernel size 3, NATTEN semantics, on NHWC
// (B, H, W, C) activations, with the key/value halo of a tile staged in
// shared memory.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_kernel.py::
// neighborhood_attention_pallas (_nat_forward, _nat_kernel). That kernel runs
// in (C, W) orientation on row stripes, with the k/v halo of (rows + 2) rows
// assembled in VMEM scratch. It computes the same function as nat_fwd.cu
// (B1); this is its own kernel, the tiled design B1 lacks:
//   * a block takes one image, a tile of R rows by TW columns of queries, and
//     first copies k and v of the tile's clamped halo (at most (R+2) x (TW+2)
//     pixels, all C channels, converted to float32) into shared memory, each
//     element read from device memory once per block;
//   * then its threads walk the tile's (pixel, head) items: q from device
//     memory, the nine keys and values of the clamped 3x3 window from shared
//     memory, softmax in registers, the output stored in q's dtype.
// For every (b, row, col, head): the window starts at clamp(row-1, 0, H-3),
// clamp(col-1, 0, W-3); logit[i] = scale * <q, k_i> + rpb[head, kr-row+2,
// kc-col+2]; out = sum_i softmax(logit)[i] * v_i. rpb is float32.
//
// What bounds it on an H100: memory. It must read q, k, v and write out (4 x
// 2 B per element in bf16) and does about 36 flops per element, far below the
// ~295 flops/byte ridge. The halo is re-read by neighbouring
// tiles ((R+2)(TW+2)/(R TW) of k and v, 1.56x at 8 x 8), mostly from L2. The
// tile is chosen on the host so that the two float32 halos fit the shared
// memory a block may use; every H, W >= 3 and any head_dim are taken (the
// TPU kernel leaves H < 8 and odd stripes to XLA).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_kernel.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// shared memory a tile's two float32 halos may take
constexpr int kSmemBudget = 96 * 1024;
constexpr int kSmemMax = 227 * 1024;

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

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// HD > 0: head_dim fixed at compile time; HD == 0: head_dim = hd_rt.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
nat_tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ rpb, T* __restrict__ out, int H, int W, int heads,
                int hd_rt, float scale, int R, int TW) {
  extern __shared__ float smem[];
  const int hd = HD > 0 ? HD : hd_rt;
  const int C = heads * hd;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * R;
  const int c0 = blockIdx.x * TW;
  const int r1 = min(r0 + R, H);   // tile rows [r0, r1)
  const int c1 = min(c0 + TW, W);  // tile cols [c0, c1)
  // the clamped windows of the tile's queries cover halo rows [hr0, hr1)
  const int hr0 = clampi(r0 - 1, 0, H - 3);
  const int hr1 = clampi(r1 - 2, 0, H - 3) + 3;
  const int hc0 = clampi(c0 - 1, 0, W - 3);
  const int hc1 = clampi(c1 - 2, 0, W - 3) + 3;
  const int hw = hc1 - hc0;
  const int nhalo = (hr1 - hr0) * hw * C;
  float* ks = smem;
  float* vs = smem + nhalo;

  const int64_t img = (int64_t)b * H * W;
  // each halo row is hw * C contiguous elements in device memory
  for (int i = threadIdx.x; i < nhalo; i += blockDim.x) {
    const int row = i / (hw * C);
    const int rest = i - row * hw * C;
    const int64_t g = (img + (int64_t)(hr0 + row) * W + hc0) * C + rest;
    ks[i] = to_f32(k[g]);
    vs[i] = to_f32(v[g]);
  }
  __syncthreads();

  const int tw = c1 - c0;
  const int items = (r1 - r0) * tw * heads;
  constexpr int NR = HD > 0 ? HD : 1;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int head = it % heads;
    const int pix = it / heads;
    const int row = r0 + pix / tw;
    const int col = c0 + pix % tw;
    const int wr = clampi(row - 1, 0, H - 3) - hr0;  // window origin in the halo
    const int wc = clampi(col - 1, 0, W - 3) - hc0;
    const int64_t qoff = (img + (int64_t)row * W + col) * C + (int64_t)head * hd;
    const float* bias = rpb + head * 25;
    // bias row/col index of window slot (0, 0): kr - row + 2 with kr the key row
    const int br = wr + hr0 - row + 2;
    const int bc = wc + hc0 - col + 2;

    float qr[NR];
    if constexpr (HD > 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[d] = to_f32(q[qoff + d]) * scale;
    }
    float p[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float* kp = ks + ((wr + i / 3) * hw + wc + i % 3) * C + head * hd;
      float dot = 0.f;
      if constexpr (HD > 0) {
#pragma unroll
        for (int d = 0; d < HD; ++d) dot += qr[d] * kp[d];
      } else {
        for (int d = 0; d < hd; ++d) dot += to_f32(q[qoff + d]) * kp[d];
        dot *= scale;
      }
      p[i] = dot + bias[(br + i / 3) * 5 + bc + i % 3];
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
        const float* vp = vs + ((wr + i / 3) * hw + wc + i % 3) * C + head * hd;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] += p[i] * vp[d];
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) out[qoff + d] = from_f32<T>(acc[d] * inv);
    } else {
      for (int d = 0; d < hd; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 9; ++i)
          acc += p[i] * vs[((wr + i / 3) * hw + wc + i % 3) * C + head * hd + d];
        out[qoff + d] = from_f32<T>(acc * inv);
      }
    }
  }
}

// The tile: the largest of 8x32, 8x16, 8x8, 4x8, 4x4, 2x4, 2x2, 1x2, 1x1
// (rows x cols) whose two float32 halos fit the budget; 0 if none fits the
// card's limit.
int pick_tile(int C, int* R, int* TW) {
  static const int tiles[][2] = {{8, 32}, {8, 16}, {8, 8}, {4, 8}, {4, 4},
                                 {2, 4},  {2, 2},  {1, 2}, {1, 1}};
  for (const auto& t : tiles) {
    const long long bytes = 2LL * (t[0] + 2) * (t[1] + 2) * C * (long long)sizeof(float);
    if (bytes <= kSmemBudget || (t[0] == 1 && t[1] == 1 && bytes <= kSmemMax)) {
      *R = t[0];
      *TW = t[1];
      return (int)bytes;
    }
  }
  return 0;
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const float* rpb, void* out, int B,
              int H, int W, int heads, int hd, float scale, cudaStream_t stream) {
  int R, TW;
  const int smem = pick_tile(heads * hd, &R, &TW);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto kern = nat_tile_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TW - 1) / TW, (H + R - 1) / R, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), rpb, static_cast<T*>(out), H,
                                         W, heads, hd, scale, R, TW);
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rpb, void* out, int B, int H,
           int W, int heads, int hd, float scale, cudaStream_t s) {
  switch (hd) {
    case 1: return launch_hd<T, 1>(q, k, v, rpb, out, B, H, W, heads, hd, scale, s);
    case 2: return launch_hd<T, 2>(q, k, v, rpb, out, B, H, W, heads, hd, scale, s);
    case 4: return launch_hd<T, 4>(q, k, v, rpb, out, B, H, W, heads, hd, scale, s);
    case 8: return launch_hd<T, 8>(q, k, v, rpb, out, B, H, W, heads, hd, scale, s);
    default: return launch_hd<T, 0>(q, k, v, rpb, out, B, H, W, heads, hd, scale, s);
  }
}

}  // namespace

// 1 if the kernel takes C = heads * head_dim channels (its smallest tile's
// halos fit shared memory), else 0.
extern "C" int lmnet_nat_tile_takes(int C) {
  int R, TW;
  return C > 0 && pick_tile(C, &R, &TW) > 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; rpb is float32
// (heads, 5, 5)). NHWC, all contiguous. Returns the launch's CUDA error (0 on
// success).
extern "C" int lmnet_nat_tile(const void* q, const void* k, const void* v, const void* rpb,
                              void* out, int B, int H, int W, int heads, int hd, float scale,
                              int dtype, void* stream) {
  if (B <= 0 || H < 3 || W < 3 || heads <= 0 || hd <= 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  int err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, r, out, B, H, W, heads, hd, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, r, out, B, H, W, heads, hd, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
