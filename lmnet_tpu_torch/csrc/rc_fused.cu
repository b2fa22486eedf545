// The deploy-mode ReparamConv block in two passes, on NHWC activations:
//   e = hardswish(We x + be)                     (1x1 expand, BN folded in)
//   t = gelu_tanh(dw5x5(e; kdw) + bdw)           (zero padding of e)
//   s = hardsigmoid(fc2(relu(fc1(mean_hw(t)))))  (squeeze-excitation)
//   y = Wp (t * s) + bp + Wsc x + bsc            (pointwise + shortcut)
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/rc_kernel.py::fused_reparam_conv
// (_rc_phase1_kernel, _rc_phase2_kernel). As there, the SE mean is a
// synchronisation point, so the block runs in two passes and recomputes t:
//   phase 1 (rc_fused_kernel<T, false>) computes t in shared memory and
//     writes only per-tile channel sums, which lmnet_rc::reduce_partials
//     adds in a fixed order into (B, E); the SE MLP then runs in torch on
//     (B, E);
//   phase 2 (rc_fused_kernel<T, true>) recomputes t, scales it by s and
//     computes both 1x1 products, the biases and the residual in the kernel
//     body, writing y once.
// It does not carry over the TPU kernel's (C, W) transposes, row stripes and
// bf16 vector arithmetic: the math here is float32 throughout (x and y in
// x's dtype), as lmnet_tpu/ops/pallas/rc_kernel.py::_rc_xla computes it.
//
// The layout: one block per 8x8 output tile of one image. The block loads
// the 12x12 halo of x (float32, Cin channels) into shared memory once; then,
// 32 expanded channels at a time, it computes e over the halo, zeroed
// outside the image (the depthwise conv pads e, not x: hardswish(be) at the
// border would be wrong), then t over the tile. Threads map to (pixel,
// channel) with the channel fastest, and the weights come in transposed
// layouts (weT (Cin, E), kdw (25, E), wpT (E, Cout), wscT (Cin, Cout)) so a
// warp reads contiguous weights. Phase 2 keeps the tile's (64, Cout) output
// sums in shared memory, each owned by one thread, and adds each chunk's
// pointwise products to them.
//
// What bounds it on an H100: arithmetic on the CUDA cores. Per output pixel
// it does E*Cin (expand, times 144/64 for the halo), 25*E (depthwise),
// E*Cout (pointwise) and Cin*Cout (shortcut) float32 multiply-adds, about
// 26 GMAC for one 256^2, B=16 LM-Net forward over the 16 blocks, against
// the bytes of one read of x per phase and one write of y. That is >= 1 ms
// at the float32 peak; cuBLAS and cuDNN run the plain block's products on
// tensor cores. Products on wgmma, bf16 halos and larger tiles are later
// work.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_kernel.py).

#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;

constexpr int kTile = 8;                   // output tile edge
constexpr int kHalo = kTile + 4;           // halo edge of the 5x5 window
constexpr int kHaloPix = kHalo * kHalo;    // 144
constexpr int kOutPix = kTile * kTile;     // 64
constexpr int kChunk = 32;                 // expanded channels per pass
constexpr int kCS = kChunk + 1;            // row stride of e and t in shared memory
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;        // a block's shared-memory limit on sm_90

// xs (kHaloPix x (Cin + 1)), es (kHaloPix x kCS), ts (kOutPix x kCS) and in
// phase 2 ys (kOutPix x Cout), float32
size_t smem_bytes(int Cin, int Cout, bool phase2) {
  size_t n = (size_t)kHaloPix * (Cin + 1) + (size_t)kHaloPix * kCS + (size_t)kOutPix * kCS;
  if (phase2) n += (size_t)kOutPix * Cout;
  return n * sizeof(float);
}

bool shape_ok(int B, int H, int W, int Cin, int E, int Cout) {
  return B > 0 && B <= 65535 && H > 0 && W > 0 && Cin > 0 && E > 0 && Cout > 0 &&
         (H + kTile - 1) / kTile <= 65535 && smem_bytes(Cin, Cout, true) <= kMaxSmem;
}

template <typename T, bool PHASE2>
__global__ void __launch_bounds__(kThreads)
rc_fused_kernel(const T* __restrict__ x, const float* __restrict__ se_scale,
                const float* __restrict__ weT, const float* __restrict__ be,
                const float* __restrict__ kdw, const float* __restrict__ bdw,
                const float* __restrict__ wpT, const float* __restrict__ bp,
                const float* __restrict__ wscT, const float* __restrict__ bsc,
                float* __restrict__ part, T* __restrict__ out, int H, int W, int Cin, int E,
                int Cout) {
  extern __shared__ float smem[];
  const int xsd = Cin + 1;  // padded: neighbouring halo pixels on other banks
  float* xs = smem;
  float* es = xs + kHaloPix * xsd;
  float* ts = es + kHaloPix * kCS;
  float* ys = ts + kOutPix * kCS;

  const int b = blockIdx.z;
  const int tr = blockIdx.y * kTile;  // the tile's first output row and column
  const int tc = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const T* xb = x + (int64_t)b * H * W * Cin;

  for (int i = tid; i < kHaloPix * Cin; i += kThreads) {
    const int p = i / Cin;
    const int k = i - p * Cin;
    const int rr = tr - 2 + p / kHalo;
    const int cc = tc - 2 + p % kHalo;
    const bool in = rr >= 0 && rr < H && cc >= 0 && cc < W;
    xs[p * xsd + k] = in ? to_f32(xb[((int64_t)rr * W + cc) * Cin + k]) : 0.f;
  }
  __syncthreads();

  if constexpr (PHASE2) {  // the shortcut and both biases start the output sums
    for (int i = tid; i < kOutPix * Cout; i += kThreads) {
      const int o = i / Cout;
      const int co = i - o * Cout;
      const float* xp = xs + ((o / kTile + 2) * kHalo + (o % kTile + 2)) * xsd;
      float acc = bp[co] + bsc[co];
      for (int k = 0; k < Cin; ++k) acc += wscT[k * Cout + co] * xp[k];
      ys[i] = acc;
    }
  }

  for (int c0 = 0; c0 < E; c0 += kChunk) {
    const int ec = min(kChunk, E - c0);
    // expand + hardswish over the halo; zero outside the image
    for (int i = tid; i < kHaloPix * ec; i += kThreads) {
      const int p = i / ec;
      const int c = i - p * ec;
      const int rr = tr - 2 + p / kHalo;
      const int cc = tc - 2 + p % kHalo;
      float v = 0.f;
      if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
        const float* xp = xs + p * xsd;
        float acc = be[c0 + c];
        for (int k = 0; k < Cin; ++k) acc += weT[k * E + c0 + c] * xp[k];
        v = hardswish(acc);
      }
      es[p * kCS + c] = v;
    }
    __syncthreads();
    // depthwise 5x5 + bias + GELU over the tile (and the SE scale in phase 2)
    for (int i = tid; i < kOutPix * ec; i += kThreads) {
      const int o = i / ec;
      const int c = i - o * ec;
      const float* ep = es + ((o / kTile) * kHalo + (o % kTile)) * kCS + c;
      float acc = bdw[c0 + c];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
#pragma unroll
        for (int q = 0; q < 5; ++q) acc += kdw[(a * 5 + q) * E + c0 + c] * ep[(a * kHalo + q) * kCS];
      }
      float v = gelu_tanh(acc);
      if constexpr (PHASE2) v *= se_scale[(int64_t)b * E + c0 + c];
      ts[o * kCS + c] = v;
    }
    __syncthreads();
    if constexpr (!PHASE2) {
      // per-channel sums over the tile's pixels inside the image, in pixel order
      const int rows = min(kTile, H - tr);
      const int cols = min(kTile, W - tc);
      const int64_t tile = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
      const int64_t ntiles = (int64_t)gridDim.x * gridDim.y;
      for (int c = tid; c < ec; c += kThreads) {
        float tot = 0.f;
        for (int r = 0; r < rows; ++r)
          for (int q = 0; q < cols; ++q) tot += ts[(r * kTile + q) * kCS + c];
        part[((int64_t)b * ntiles + tile) * E + c0 + c] = tot;
      }
    } else {
      for (int i = tid; i < kOutPix * Cout; i += kThreads) {
        const int o = i / Cout;
        const int co = i - o * Cout;
        const float* tp = ts + o * kCS;
        float acc = ys[i];
        for (int c = 0; c < ec; ++c) acc += wpT[(int64_t)(c0 + c) * Cout + co] * tp[c];
        ys[i] = acc;
      }
    }
    __syncthreads();
  }

  if constexpr (PHASE2) {
    T* ob = out + (int64_t)b * H * W * Cout;
    for (int i = tid; i < kOutPix * Cout; i += kThreads) {
      const int o = i / Cout;
      const int co = i - o * Cout;
      const int rr = tr + o / kTile;
      const int cc = tc + o % kTile;
      if (rr < H && cc < W) ob[((int64_t)rr * W + cc) * Cout + co] = from_f32<T>(ys[i]);
    }
  }
}

dim3 tiles(int B, int H, int W) {
  return dim3((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
}

template <typename T, bool PHASE2>
int launch_fused(const void* x, const float* s, const float* weT, const float* be,
                 const float* kdw, const float* bdw, const float* wpT, const float* bp,
                 const float* wscT, const float* bsc, float* part, void* out, int B, int H,
                 int W, int Cin, int E, int Cout, cudaStream_t stream) {
  const size_t smem = smem_bytes(Cin, Cout, PHASE2);
  cudaError_t err = cudaFuncSetAttribute(rc_fused_kernel<T, PHASE2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rc_fused_kernel<T, PHASE2><<<tiles(B, H, W), kThreads, smem, stream>>>(
      static_cast<const T*>(x), s, weT, be, kdw, bdw, wpT, bp, wscT, bsc, part,
      static_cast<T*>(out), H, W, Cin, E, Cout);
  return (int)cudaGetLastError();
}

int ntiles(int H, int W) { return ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile); }

}  // namespace

// Number of float32 values the caller allocates for ``part`` (phase 1's
// per-tile channel sums); -1 for a shape the kernels do not take (the
// shared-memory tiles bound Cin and Cout).
extern "C" long long lmnet_rc_fused_workspace(int B, int H, int W, int Cin, int E, int Cout) {
  if (!shape_ok(B, H, W, Cin, E, Cout)) return -1;
  return (long long)B * ntiles(H, W) * E;
}

// Phase 1. dtype: 0 = float32, 1 = bfloat16 (x). Weights float32: weT
// (Cin, E), be (E,), kdw (25, E) row-major taps, bdw (E,). Writes sums,
// float32 (B, E): the per-image channel sums of t; part is float32 scratch of
// lmnet_rc_fused_workspace(...) values. Returns the first CUDA error: 0 on
// success.
extern "C" int lmnet_rc_fused_phase1(const void* x, const void* weT, const void* be,
                                     const void* kdw, const void* bdw, void* sums, void* part,
                                     int B, int H, int W, int Cin, int E, int dtype,
                                     void* stream) {
  if (!shape_ok(B, H, W, Cin, E, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(weT);
  const float* b = static_cast<const float*>(be);
  const float* k = static_cast<const float*>(kdw);
  const float* d = static_cast<const float*>(bdw);
  float* p = static_cast<float*>(part);
  int err;
  if (dtype == 0) {
    err = launch_fused<float, false>(x, nullptr, a, b, k, d, nullptr, nullptr, nullptr, nullptr,
                                     p, nullptr, B, H, W, Cin, E, 1, st);
  } else if (dtype == 1) {
    err = launch_fused<__nv_bfloat16, false>(x, nullptr, a, b, k, d, nullptr, nullptr, nullptr,
                                             nullptr, p, nullptr, B, H, W, Cin, E, 1, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int n = ntiles(H, W);
  reduce_partials<<<B * E, kReduceThreads, 0, st>>>(p, static_cast<float*>(sums), n, E,
                                                    (long long)n * E, E);
  return (int)cudaGetLastError();
}

// Phase 2. As phase 1, plus s float32 (B, E), the SE scale; wpT (E, Cout),
// bp (Cout,), wscT (Cin, Cout), bsc (Cout,). Writes out (B, H, W, Cout) in
// x's dtype. Returns the CUDA error of the launch: 0 on success.
extern "C" int lmnet_rc_fused_phase2(const void* x, const void* s, const void* weT,
                                     const void* be, const void* kdw, const void* bdw,
                                     const void* wpT, const void* bp, const void* wscT,
                                     const void* bsc, void* out, int B, int H, int W, int Cin,
                                     int E, int Cout, int dtype, void* stream) {
  if (!shape_ok(B, H, W, Cin, E, Cout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[9] = {
      static_cast<const float*>(s),   static_cast<const float*>(weT),
      static_cast<const float*>(be),  static_cast<const float*>(kdw),
      static_cast<const float*>(bdw), static_cast<const float*>(wpT),
      static_cast<const float*>(bp),  static_cast<const float*>(wscT),
      static_cast<const float*>(bsc)};
  if (dtype == 0) {
    return launch_fused<float, true>(x, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                                     nullptr, out, B, H, W, Cin, E, Cout, st);
  }
  if (dtype == 1) {
    return launch_fused<__nv_bfloat16, true>(x, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                                             f[8], nullptr, out, B, H, W, Cin, E, Cout, st);
  }
  return (int)cudaErrorInvalidValue;
}
