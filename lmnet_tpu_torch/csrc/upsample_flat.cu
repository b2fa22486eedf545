// 2x bilinear upsample with align_corners=True on NHWC (B, H, W, C) ->
// (B, 2H, 2W, C): nn.Upsample(scale_factor=2, mode='bilinear',
// align_corners=True).
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/upsample_flat.py::
// upsample2x_flat (_upsample2x_flat_fwd, _upsample_flat_kernel). It computes
// the same function, not that kernel's TPU layout (8-row edge blocks, the
// log-depth lane-roll dilation ladder).
//
// At exactly 2x with aligned corners the taps of each output phase are fixed
// and only the weights vary with the position (upsample_flat.py:17-24):
//   even row 2k   = (1 - a_k) x[k] + a_k x[k-1],  a_k = k / (2H - 1)
//   odd  row 2k+1 = (1 - b_k) x[k] + b_k x[k+1],  b_k = (H - 1 - k) / (2H - 1)
// and the same along W; a_0 = 0 and b_{H-1} = 0, so the clamped neighbour at
// the border never contributes. One thread takes one input pixel and a chunk
// of channels: it reads the 3x3 neighbourhood of the chunk, lerps along H
// (for both row phases) and then along W in float32, and writes the 2x2
// outputs, each rounded once to the tensor's dtype. The chunk is 16 bytes
// (8 bf16 or 4 float32, vector loads and stores) when C and the pointers
// allow it, else one channel.
//
// What bounds it on an H100: memory. Each input element is read once (the
// neighbours' re-reads come from L1/L2) and four output elements are written:
// 5 x 2 B per input element in bf16, writing is 80 % of the bytes; about 12
// flops per output element.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/upsample_flat.py).

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

// V consecutive elements as one load/store (V * sizeof(T) is 16 bytes or one
// element)
template <typename T, int V>
struct alignas(V * sizeof(T) == 16 ? 16 : sizeof(T)) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* f) {
  if constexpr (V * sizeof(T) == 16) {
    Vec<T, V> r;
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(r.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  Vec<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = from_f32<T>(f[i]);
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r.v[i];
  }
}

template <typename T, int V>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int H,
                                  int W, int C) {
  const int chunks = C / V;
  const int64_t total = (int64_t)B * H * W * chunks;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = (int)(t % chunks) * V;
  int64_t pix = t / chunks;  // (b * H + k) * W + j
  const int j = (int)(pix % W);
  const int k = (int)((pix / W) % H);
  const int b = (int)(pix / ((int64_t)W * H));

  const float ah = (float)k / (float)(2 * H - 1);            // on x[k-1], even rows
  const float bh = (float)(H - 1 - k) / (float)(2 * H - 1);  // on x[k+1], odd rows
  const int km = max(k - 1, 0), kp = min(k + 1, H - 1);
  const int rows[3] = {km, k, kp};

  // H-lerp at columns j-1, j, j+1 for both row phases
  float ev[3][V], od[3][V];
#pragma unroll
  for (int dc = 0; dc < 3; ++dc) {
    const int col = min(max(j + dc - 1, 0), W - 1);
    float xr[3][V];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      load<T, V>(x + ((((int64_t)b * H + rows[dr]) * W + col) * C + ch), xr[dr]);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ev[dc][i] = xr[1][i] + ah * (xr[0][i] - xr[1][i]);
      od[dc][i] = xr[1][i] + bh * (xr[2][i] - xr[1][i]);
    }
  }
  const float aw = (float)j / (float)(2 * W - 1);
  const float bw = (float)(W - 1 - j) / (float)(2 * W - 1);
  const int64_t W2 = 2 * (int64_t)W;
  const int64_t base = (((int64_t)b * 2 * H + 2 * k) * W2 + 2 * j) * C + ch;
  float o[V];
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    const float(*r)[V] = ph == 0 ? ev : od;
    const int64_t rowoff = base + (int64_t)ph * W2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = r[1][i] + aw * (r[0][i] - r[1][i]);
    store<T, V>(out + rowoff, o);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = r[1][i] + bw * (r[2][i] - r[1][i]);
    store<T, V>(out + rowoff + C, o);
  }
}

template <typename T, int V>
void launch_v(const void* x, void* out, int B, int H, int W, int C, cudaStream_t s) {
  const int64_t total = (int64_t)B * H * W * (C / V);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  upsample2x_kernel<T, V><<<blocks, threads, 0, s>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(out), B, H, W, C);
}

template <typename T>
void launch(const void* x, void* out, int B, int H, int W, int C, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    launch_v<T, V>(x, out, B, H, W, C, s);
  } else {
    launch_v<T, 1>(x, out, B, H, W, C, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x (B, H, W, C) and out (B, 2H, 2W, C)
// contiguous. Returns cudaGetLastError() after the launch: 0 on success.
extern "C" int lmnet_upsample2x(const void* x, void* out, int B, int H, int W, int C, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, out, B, H, W, C, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, out, B, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
