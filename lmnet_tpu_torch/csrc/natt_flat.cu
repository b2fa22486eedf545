// The fused interior of a NeighborhoodTransformer (NATT) block on the flat
// (B, H, W*C) embedding: LN -> qkv -> NAT(k=3) -> proj (+emb) -> LN ->
// fc1 + tanh GELU -> fc2 (+att), one read of emb and one write of the output.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/natt_flat.py::
// natt_flat_interior (_natt_kernel). That kernel does every per-pixel channel
// mixing as a (2C-1)-step lane-roll FMA ladder; this one computes the same
// function with plain per-pixel products:
//   xn  = LN1(emb)                                  (affine g1, be1)
//   q   = xn Wq + bq   (the NAT scale head_dim^-0.5 folded into Wq and bq)
//   k   = xn Wk + bk,  v = xn Wv + bv
//   nat = NAT(q, k, v, rpb)  (clamped 3x3 window, no further scale)
//   att = nat Wp + bp + emb
//   out = gelu_tanh(LN2(att) W1 + b1) W2 + b2 + att  (affine g2, be2)
// Both LayerNorms take the variance as E[(x - mean)^2], eps 1e-5.
//
// Design. A block takes one image and a tile of R rows by TW columns. It
// stages emb over the tile's clamped 1-pixel halo (the union of its queries'
// 3x3 windows) in shared memory as float32, computes LN1 and k, v over the
// halo and q over the tile, then NAT, proj + residual, LN2, fc1 + GELU and
// fc2 + residual for the tile, every intermediate in shared memory, and
// writes the output once. Each product is one thread per (pixel, output
// channel) walking the input channels; the weights, packed (in, out) so a
// warp reads consecutive outputs, come through the read-only cache (at C =
// 96 they are 295 KB in float32, more than a block's shared memory). Each
// LayerNorm is a warp per pixel with shuffle reductions. All math is float32
// on CUDA cores; tensor cores are later work. The tile is the largest of a
// short list whose buffers fit a shared-memory budget (8x16 at C = 12 and 24,
// 8x8 at 48, 4x4 at 96). Every H, W >= 3 and any head_dim are taken (the TPU
// kernel asserts a power-of-two head_dim and H >= 8).
//
// What bounds it on an H100: arithmetic. About 8 C^2 multiply-adds per pixel
// (q, k, v, proj: C^2 each; fc1, fc2: 2 C^2 each), plus the k and v of the
// halo, against 2 x C x 2 B of device memory per pixel in bf16: ~200-400
// flops/byte at C = 12-96, above the float32 CUDA-core ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flops/byte).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/natt_flat.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr float kLnEps = 1e-5f;

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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Offsets into the packed float32 weights (see lmnet_natt_flat below).
struct Pack {
  const float *wq, *wk, *wv, *wp, *w1, *w2;
  const float *bq, *bk, *bv, *bp, *b1, *b2, *g1, *be1, *g2, *be2, *rpb;
  __device__ Pack(const float* w, int C) {
    const int C2 = C * C;
    wq = w;
    wk = w + C2;
    wv = w + 2 * C2;
    wp = w + 3 * C2;
    w1 = w + 4 * C2;  // (C, 2C)
    w2 = w + 6 * C2;  // (2C, C)
    const float* vec = w + 8 * C2;
    bq = vec;
    bk = vec + C;
    bv = vec + 2 * C;
    bp = vec + 3 * C;
    b1 = vec + 4 * C;  // 2C
    b2 = vec + 6 * C;
    g1 = vec + 7 * C;
    be1 = vec + 8 * C;
    g2 = vec + 9 * C;
    be2 = vec + 10 * C;
    rpb = vec + 11 * C;
  }
};

// y[p, c] = bias[c] + sum_i x[p, i] w[i, c] for one item (p, c); x in
// shared memory with row stride cin, w (cin, cout) through the read-only cache.
__device__ __forceinline__ float dot_col(const float* x, const float* __restrict__ w, int cin,
                                         int cout, int c) {
  float acc = 0.f;
  for (int i = 0; i < cin; ++i) acc = fmaf(x[i], __ldg(w + (int64_t)i * cout + c), acc);
  return acc;
}

// LayerNorm of n rows of C floats at src (row stride C) into dst, a warp per row.
__device__ void layer_norm(const float* src, float* dst, int n, int C,
                           const float* __restrict__ g, const float* __restrict__ be) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int p = warp; p < n; p += nwarps) {
    const float* x = src + p * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += x[c];
    const float mean = warp_sum(s) / C;
    float s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = x[c] - mean;
      s2 += d * d;
    }
    const float rstd = rsqrtf(warp_sum(s2) / C + kLnEps);
    for (int c = lane; c < C; c += 32) dst[p * C + c] = (x[c] - mean) * rstd * __ldg(g + c) + __ldg(be + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
natt_kernel(const T* __restrict__ emb, const float* __restrict__ weights, T* __restrict__ out,
            int H, int W, int heads, int hd, int R, int TW) {
  extern __shared__ float smem[];
  const int C = heads * hd;
  const Pack pk(weights, C);
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * R, c0 = blockIdx.x * TW;
  const int r1 = min(r0 + R, H), c1 = min(c0 + TW, W);
  const int hr0 = clampi(r0 - 1, 0, H - 3), hr1 = clampi(r1 - 2, 0, H - 3) + 3;
  const int hc0 = clampi(c0 - 1, 0, W - 3), hc1 = clampi(c1 - 2, 0, W - 3) + 3;
  const int hw = hc1 - hc0;
  const int nh = (hr1 - hr0) * hw;  // halo pixels
  const int tw = c1 - c0;
  const int np = (r1 - r0) * tw;    // tile pixels
  const int ph_max = (R + 2) * (TW + 2);
  float* E = smem;                  // emb over the halo          (ph_max, C)
  float* X = E + ph_max * C;        // LN1(emb) / nat / LN2(att)  (ph_max, C)
  float* K = X + ph_max * C;        // k over the halo; with V, the hidden (np, 2C)
  float* V = K + ph_max * C;        // v over the halo
  float* Q = V + ph_max * C;        // q, then att                (R * TW, C)
  const int64_t img = (int64_t)b * H * W;
  // the halo index of tile pixel p
  auto halo_of = [&](int p) { return (r0 + p / tw - hr0) * hw + (c0 + p % tw - hc0); };

  // 1. emb over the halo: each halo row is hw * C contiguous elements
  for (int i = threadIdx.x; i < nh * C; i += blockDim.x) {
    const int row = i / (hw * C);
    const int rest = i - row * hw * C;
    E[i] = to_f32(emb[(img + (int64_t)(hr0 + row) * W + hc0) * C + rest]);
  }
  __syncthreads();
  // 2. LN1 over the halo
  layer_norm(E, X, nh, C, pk.g1, pk.be1);
  __syncthreads();
  // 3. k, v over the halo, q over the tile
  for (int it = threadIdx.x; it < (2 * nh + np) * C; it += blockDim.x) {
    const int p = it / C, c = it % C;
    if (p < nh) {
      K[it] = __ldg(pk.bk + c) + dot_col(X + p * C, pk.wk, C, C, c);
    } else if (p < 2 * nh) {
      V[it - nh * C] = __ldg(pk.bv + c) + dot_col(X + (p - nh) * C, pk.wv, C, C, c);
    } else {
      const int t = p - 2 * nh;
      Q[t * C + c] = __ldg(pk.bq + c) + dot_col(X + halo_of(t) * C, pk.wq, C, C, c);
    }
  }
  __syncthreads();
  // 4. NAT per (tile pixel, head) into X
  for (int it = threadIdx.x; it < np * heads; it += blockDim.x) {
    const int head = it % heads, p = it / heads;
    const int row = r0 + p / tw, col = c0 + p % tw;
    const int wr = clampi(row - 1, 0, H - 3), wc = clampi(col - 1, 0, W - 3);
    const float* bias = pk.rpb + head * 25 + (wr - row + 2) * 5 + (wc - col + 2);
    const float* qp = Q + p * C + head * hd;
    float l[9];
    float m = -3.402823466e38f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float* kp = K + ((wr - hr0 + i / 3) * hw + wc - hc0 + i % 3) * C + head * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qp[d], kp[d], dot);
      l[i] = dot + __ldg(bias + (i / 3) * 5 + i % 3);
      m = fmaxf(m, l[i]);
    }
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      l[i] = expf(l[i] - m);
      den += l[i];
    }
    const float inv = 1.f / den;
    for (int d = 0; d < hd; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i)
        acc = fmaf(l[i], V[((wr - hr0 + i / 3) * hw + wc - hc0 + i % 3) * C + head * hd + d], acc);
      X[p * C + head * hd + d] = acc * inv;
    }
  }
  __syncthreads();
  // 5. att = nat Wp + bp + emb, into Q
  for (int it = threadIdx.x; it < np * C; it += blockDim.x) {
    const int p = it / C, c = it % C;
    Q[it] = __ldg(pk.bp + c) + dot_col(X + p * C, pk.wp, C, C, c) + E[halo_of(p) * C + c];
  }
  __syncthreads();
  // 6. LN2(att) into X
  layer_norm(Q, X, np, C, pk.g2, pk.be2);
  __syncthreads();
  // 7. the hidden gelu(LN2 W1 + b1), (np, 2C), over K and V
  float* Hd = K;
  for (int it = threadIdx.x; it < np * 2 * C; it += blockDim.x) {
    const int p = it / (2 * C), j = it % (2 * C);
    Hd[it] = gelu_tanh(__ldg(pk.b1 + j) + dot_col(X + p * C, pk.w1, C, 2 * C, j));
  }
  __syncthreads();
  // 8. out = hidden W2 + b2 + att, stored once
  for (int it = threadIdx.x; it < np * C; it += blockDim.x) {
    const int p = it / C, c = it % C;
    const float y = __ldg(pk.b2 + c) + dot_col(Hd + p * 2 * C, pk.w2, 2 * C, C, c) + Q[it];
    const int row = r0 + p / tw, col = c0 + p % tw;
    out[(img + (int64_t)row * W + col) * C + c] = from_f32<T>(y);
  }
}

// The tile: the first of 8x16, 8x8, 4x8, 4x4, 2x4, 2x2, 1x2, 1x1 (rows x
// cols) whose buffers fit the budget (1x1: the card's limit); 0 if none.
int pick_tile(int C, int* R, int* TW) {
  static const int tiles[][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};
  for (const auto& t : tiles) {
    const long long bytes = (long long)(4 * (t[0] + 2) * (t[1] + 2) + t[0] * t[1]) * C * 4;
    if (bytes <= kSmemBudget || (t[0] == 1 && t[1] == 1 && bytes <= kSmemMax)) {
      *R = t[0];
      *TW = t[1];
      return (int)bytes;
    }
  }
  return 0;
}

template <typename T>
int launch(const void* emb, const float* w, void* out, int B, int H, int W, int heads, int hd,
           cudaStream_t s) {
  int R, TW;
  const int smem = pick_tile(heads * hd, &R, &TW);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto kern = natt_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + TW - 1) / TW, (H + R - 1) / R, B);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(emb), w, static_cast<T*>(out), H, W,
                                    heads, hd, R, TW);
  return 0;
}

}  // namespace

// 1 if the kernel takes C = heads * head_dim channels, else 0.
extern "C" int lmnet_natt_flat_takes(int C) {
  int R, TW;
  return C > 0 && pick_tile(C, &R, &TW) > 0;
}

// emb and out: (B, H, W*C), dtype 0 = float32, 1 = bfloat16, contiguous.
// weights: float32, packed as wq, wk, wv, wp (each (C, C), (in, out), the NAT
// scale folded into wq), w1 (C, 2C), w2 (2C, C), then bq, bk, bv, bp (C
// each), b1 (2C), b2, g1, be1, g2, be2 (C each), rpb (heads, 5, 5).
// Returns the launch's CUDA error (0 on success).
extern "C" int lmnet_natt_flat(const void* emb, const void* weights, void* out, int B, int H,
                               int W, int heads, int hd, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H < 3 || W < 3 || heads <= 0 || hd <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  int err;
  if (dtype == 0) {
    err = launch<float>(emb, w, out, B, H, W, heads, hd, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(emb, w, out, B, H, W, heads, hd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
