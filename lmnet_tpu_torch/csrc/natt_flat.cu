// The fused interior of a NeighborhoodTransformer (NATT) block on the flat
// (B, H, W*C) embedding: LN -> qkv -> NAT(k=3) -> proj (+emb) -> LN ->
// fc1 + tanh GELU -> fc2 (+att), one read of emb and one write of the output.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/natt_flat.py::
// natt_flat_interior (_natt_kernel). That kernel does every per-pixel channel
// mixing as a (2C-1)-step lane-roll FMA ladder on the TPU's vector unit (its
// docstring: a dead end there, the products "belong on the MXU"); this one
// computes the same function with plain per-pixel products:
//   xn  = LN1(emb)                                  (affine g1, be1)
//   q   = xn Wq + bq   (the NAT scale head_dim^-0.5 folded into Wq and bq)
//   k   = xn Wk + bk,  v = xn Wv + bv
//   nat = NAT(q, k, v, rpb)  (clamped 3x3 window, no further scale)
//   att = nat Wp + bp + emb
//   out = gelu_tanh(LN2(att) W1 + b1) W2 + b2 + att  (affine g2, be2)
// Both LayerNorms take the variance as E[(x - mean)^2], eps 1e-5. A block
// takes one image and a tile of output pixels, computes LN1, k and v over
// the tile's clamped 1-pixel halo (the union of its queries' 3x3 windows)
// and everything else over the tile, every intermediate in shared memory.
// Every H, W >= 3 and any head_dim are taken (the TPU kernel asserts a
// power-of-two head_dim and H >= 8).
//
// What bounds it on an H100: arithmetic, of two kinds. 8 C^2 multiply-adds
// a pixel in the six products (q, k, v, proj: C^2 each; fc1, fc2: 2 C^2
// each), plus k and v over the halo; and the float32 work around them, the
// NAT (9 logits and 9 weighted sums a channel, a 9-way softmax a head), the
// two LayerNorms and the GELU: ~56 C + 36 C + 36 heads operations a pixel.
// In bf16 the output and emb are 4 C bytes a pixel, below both.
//
// bf16 emb, natt_tc_kernel. The six products run on the
// tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> float32 with A fragments by
// ldmatrix from shared memory (mma_bf16.cuh, B4's route: at K = 16..192 and
// N = 16..192, 16-row M tiles of pixels fit the tiles exactly and wgmma's
// 64-row tiles and asynchrony buy nothing). The weights come bf16,
// zero-padded to K a multiple of 16 and N a multiple of 8, rows of K + 8
// (ops/natt_flat.py::pack_natt_weights_bf16, once at fold time), and are
// staged into shared memory one product at a time by 16-byte cp.async (q, k
// and v of a channel group together; k and v, which share their A rows, as
// one product). The A operands are bf16 in shared
// memory: LN1(emb) over the halo, the NAT output, LN2(att) and the GELU
// hidden. LayerNorm, NAT, the biases and the residuals stay float32: k and v
// over the halo and q over the tile are float32 in shared memory, computed a
// group of heads at a time (all 12 channels at C = 12; groups of 8, 24 and
// 24 at C = 24, 48 and 96) so that they fit beside the rest; the NAT is a
// thread per (pixel, head), head_dim 1, 2, 4 and 8 unrolled, with a base-2
// softmax (log2(e) folded into q and rpb, one ex2 a logit); the GELU is
// lmnet_rc::gelu_tanh (one ex2). emb's halo comes in by cp.async in the
// widest unit that divides C's run, one contiguous run a halo row; its
// shared-memory copy is freed after LN1 and the residual re-reads the tile
// from L2. Per-pixel tables (halo index, window, bias offset, image index)
// are made once a block: no run-time division in the loops. Rounding
// points: the weights, the four A operands and the stored output;
// ops/natt_flat.py::natt_flat_interior_plain rounds at the same points for
// bf16 emb. The tile (the largest of a list
// that leaves two blocks on an SM: 16 x 16 at C = 12 and 24, 8 x 16 at 48,
// 8 x 8 at 96; the halo 1.27, 1.27, 1.41 and 1.56x the tile), the group and
// the copy unit come from the caller's plan (ops/natt_flat.py::natt_plan),
// which the entry point checks.
//
// float32 emb, natt_f32_kernel (the first design, the exact on-card check of
// the function): emb over the halo in shared memory as float32; LN1 and k,
// v over the halo and q over the tile; then NAT, proj + residual, LN2, fc1 +
// GELU and fc2 + residual for the tile. Each product is one thread per
// (pixel, output channel) walking the input channels, the float32 weights
// (packed (in, out)) through the read-only cache; each LayerNorm a warp per
// pixel. The tile is the largest of a short list whose five float32 buffers
// fit 96 KB (8x16 at C = 12 and 24, 8x8 at 48, 4x4 at 96).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/natt_flat.py).

#include "mma_bf16.cuh"
#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;
using namespace lmnet_tc;

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;
constexpr int kSmemMax = 232448;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// the float32 kernel's GELU, tanhf, as that kernel was first written
__device__ __forceinline__ float gelu_tanhf(float x) {
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
natt_f32_kernel(const T* __restrict__ emb, const float* __restrict__ weights, T* __restrict__ out,
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
    Hd[it] = gelu_tanhf(__ldg(pk.b1 + j) + dot_col(X + p * C, pk.w1, C, 2 * C, j));
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

// ---------------------------------------------------------------------------
// bf16 emb: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;
constexpr int kNatMax = 1023;  // halo indices packed in 10 bits (tables below)

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The bf16 kernel's padded sizes for C channels, its tile (tr x tc output
// pixels) and channel group g, and the byte offsets of its shared-memory
// regions (ops/natt_flat.py::natt_plan computes the same):
//   W: the weights of one product, bf16 [n][k + 8] (Wq, Wk, Wv of a group
//      together; Wp; W1; W2);
//   E: emb over the halo (bf16, [pixel][C]); then the group's k and v over
//      the halo and q over the tile (float32, [pixel][g]); then the hidden
//      gelu(fc1) (bf16 [pixel][k2 + 8]);
//   A: LN1(emb) over the halo (bf16 [pixel][kc + 8]); then att (float32
//      [pixel][C]);
//   B: the NAT output, then LN2(att) (bf16 [pixel][kc + 8]);
//   T: per tile pixel its halo index, window and bias offsets, and its
//      pixel index in the image (two ints); the float32 vectors (biases and
//      LayerNorm affines, 11 C) and rpb * log2(e).
struct TcDims {
  int C, kc, sa, nc, n2, k2, s4;  // K (C to 16) + 8; N (C, 2C to 8); fc2's K (2C to 16) + 8
  int tr, tc, np, mt, halo, mh;   // tile, its pixels and 16-row tiles; halo pixels and rows
  int g, gn, ng;                  // group channels, rounded to 8, groups
  int offW, offE, offA, offB, offT, smem;
};

__host__ __device__ inline int align16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline TcDims tc_dims(int C, int heads, int tr, int tc, int g) {
  TcDims d;
  d.C = C;
  d.kc = round_up(C, 16);
  d.sa = d.kc + 8;
  d.nc = round_up(C, 8);
  d.n2 = round_up(2 * C, 8);
  d.k2 = round_up(2 * C, 16);
  d.s4 = d.k2 + 8;
  d.tr = tr;
  d.tc = tc;
  d.np = tr * tc;
  d.mt = round_up(d.np, 16);
  d.halo = (tr + 2) * (tc + 2);
  d.mh = round_up(d.halo, 16);
  d.g = g;
  d.gn = round_up(g, 8);
  d.ng = C / g;
  const int w = 2 * imax(imax(3 * d.gn * d.sa, d.nc * d.sa), imax(d.n2 * d.sa, d.nc * d.s4));
  const int e = imax(imax(d.halo * C * 2, (2 * d.mh * g + d.mt * g) * 4), d.mt * d.s4 * 2);
  const int a = imax(d.mh * d.sa * 2, d.mt * C * 4);
  const int b = d.mt * d.sa * 2;
  const int t = d.np * 8 + (11 * C + heads * 25) * 4;
  d.offW = 0;
  d.offE = d.offW + align16(w);
  d.offA = d.offE + align16(e);
  d.offB = d.offA + align16(a);
  d.offT = d.offB + align16(b);
  d.smem = d.offT + align16(t);
  return d;
}

// Offsets in bf16 elements of the packed bf16 weights (ops/natt_flat.py::
// pack_natt_weights_bf16): Wq, Wk, Wv, Wp [nc][kc + 8], W1 [n2][kc + 8],
// W2 [nc][k2 + 8], each in F.linear's (out, in) layout, zero-padded, so that
// a product's weights (or a group's rows of Wq, Wk, Wv) copy into shared
// memory as one contiguous run.
struct Pack16 {
  const bf16 *wq, *wk, *wv, *wp, *w1, *w2;
  __device__ Pack16(const bf16* w, const TcDims& d) {
    const int m = d.nc * d.sa;
    wq = w;
    wk = w + m;
    wv = w + 2 * m;
    wp = w + 3 * m;
    w1 = w + 4 * m;
    w2 = w1 + d.n2 * d.sa;
  }
};

// Copy n bytes (a multiple of 16; both addresses 16-byte aligned) from
// device to shared memory with 16-byte cp.async, the block's threads
// strided over the units (wait with cp_async_wait_all).
__device__ __forceinline__ void copy_run(void* dst, const void* src, int n) {
  for (int u = threadIdx.x; u < n / 16; u += blockDim.x) {
    copy_async(static_cast<unsigned char*>(dst) + 16 * u,
               static_cast<const unsigned char*>(src) + 16 * u, 16, true);
  }
}

// y = A B^T over K = k for M tiles of 16 rows of A (row m of A is
// a + arow(m) * lda) and N tiles of 8 rows of b ([n][k], row stride ldb),
// bf16 x bf16 -> float32 on the tensor cores; epi(row, col, v0, v1) takes
// y[row][col], y[row][col + 1]. A warp takes one M tile and up to four N
// tiles at a time, so each A fragment serves four products.
template <class ARow, class Epi>
__device__ __forceinline__ void gemm(const bf16* a, int lda, ARow arow, int mtiles,
                                     const bf16* b, int ldb, int ntiles, int k, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nchunks = (ntiles + 3) >> 2;
  int mt = 0, nq = threadIdx.x >> 5;
  while (nq >= nchunks) {
    nq -= nchunks;
    ++mt;
  }
  while (mt < mtiles) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* ap = a + arow(mt * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
    const int n0 = nq * 4;
    const bf16* bp = b + (n0 * 8 + (lane >> 2)) * ldb + 2 * (lane & 3);
    for (int k0 = 0; k0 < k; k0 += 16) {
      unsigned af[4];
      ldmatrix_x4(af, ap + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < ntiles) {
          const bf16* bj = bp + j * 8 * ldb + k0;
          mma_bf16(acc[j], af, ld32(bj), ld32(bj + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j < ntiles) {
        const int row = mt * 16 + (lane >> 2);
        const int col = (n0 + j) * 8 + 2 * (lane & 3);
        epi(row, col, acc[j][0], acc[j][1]);
        epi(row + 8, col, acc[j][2], acc[j][3]);
      }
    }
    nq += nwarps;
    while (nq >= nchunks) {
      nq -= nchunks;
      ++mt;
    }
  }
}

// LayerNorm (variance E[(x - mean)^2], eps 1e-5, float32) of n rows of C
// values at src (row stride C), into bf16 dst rows of stride ld, zero in
// columns C .. kc; g and be in shared memory. A group of L lanes (a power of
// two, about C / 12, so that each lane sums about 12 values with no shuffle
// between them) takes a row; every lane of a warp takes part in the
// shuffles.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* src, int n, int C, int kc, float inv_c,
                                        const float* g, const float* be, bf16* dst, int ld) {
  const int lshift = C >= 384 ? 5 : C >= 192 ? 4 : C >= 96 ? 3 : C >= 48 ? 2 : C >= 24 ? 1 : 0;
  const int L = 1 << lshift;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const int per_warp = 32 >> lshift;
  const int rows_step = (blockDim.x >> 5) * per_warp;
  for (int base = (threadIdx.x >> 5) * per_warp; base < n; base += rows_step) {
    const int p = base + (lane >> lshift);
    const bool live = p < n;
    const T* x = src + (live ? p : 0) * C;
    float s = 0.f;
    for (int c = sub; c < C; c += L) s += to_f32(x[c]);
    for (int o = L >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s * inv_c;
    float s2 = 0.f;
    for (int c = sub; c < C; c += L) {
      const float v = to_f32(x[c]) - mean;
      s2 = fmaf(v, v, s2);
    }
    for (int o = L >> 1; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    const float rstd = rsqrtf(fmaf(s2, inv_c, kLnEps));
    if (live) {
      bf16* y = dst + p * ld;
      for (int c = sub; c < C; c += L) {
        y[c] = __float2bfloat16(fmaf((to_f32(x[c]) - mean) * rstd, g[c], be[c]));
      }
      for (int c = C + sub; c < kc; c += L) y[c] = __float2bfloat16(0.f);
    }
  }
}

// the softmax-weighted window sum of one (pixel, head): 9 logits from q and
// the window's k (plus the bias, all carrying log2(e)), a base-2 softmax,
// and D values out as bf16. HD > 0: that head_dim, unrolled; 0: any (hd).
template <int HD>
__device__ __forceinline__ void nat_one(const float* qp, const float* kp, const float* vp,
                                        const float* bias, int hw, int g, int hd, bf16* out) {
  const int D = HD > 0 ? HD : hd;
  float qr[HD > 0 ? HD : 1];
  if constexpr (HD > 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qp[d];
  }
  float l[9];
  float m = -3.402823466e38f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int off = ((i / 3) * hw + i % 3) * g;
    float dot = 0.f;
    if constexpr (HD > 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kp[off + d], dot);
    } else {
      for (int d = 0; d < D; ++d) dot = fmaf(qp[d], kp[off + d], dot);
    }
    l[i] = dot + bias[(i / 3) * 5 + i % 3];
    m = fmaxf(m, l[i]);
  }
  float den = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(l[i] - m));
    l[i] = e;
    den += e;
  }
  const float inv = __fdividef(1.f, den);
  for (int d = 0; d < D; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) acc = fmaf(l[i], vp[((i / 3) * hw + i % 3) * g + d], acc);
    out[d] = __float2bfloat16(acc * inv);
  }
}

// NAT of the group's heads for every tile pixel, from q (tile) and k, v
// (halo) in float32 [pixel][g], into bf16 columns of nat (row stride ld):
// thread (pixel, head), head fastest, two pixels an iteration (their loads
// and exponentials interleave); base-2 softmax (q carries log2(e), rpb2 =
// rpb * log2(e)).
template <int HD>
__device__ __forceinline__ void nat_heads(const float* q, const float* k, const float* v,
                                          const int* tinfo, const float* rpb2, int np, int hw,
                                          int g, int hd, int hpg, int head0, bf16* nat, int ld) {
  const int h = threadIdx.x % hpg;
  const int pstep = blockDim.x / hpg;
  if (threadIdx.x >= pstep * hpg) return;
  const int D = HD > 0 ? HD : hd;
  const float* bias = rpb2 + (head0 + h) * 25;
  for (int p = threadIdx.x / hpg; p < np; p += 2 * pstep) {
    const int p2 = p + pstep;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pp = u == 0 ? p : p2;
      if (u == 1 && pp >= np) break;
      const int info = tinfo[2 * pp];
      const int wnd = (info >> 10) & kNatMax;
      nat_one<HD>(q + pp * g + h * D, k + wnd * g + h * D, v + wnd * g + h * D,
                  bias + (info >> 20), hw, g, hd, nat + pp * ld + (head0 + h) * D);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
natt_tc_kernel(const bf16* __restrict__ emb, const float* __restrict__ wf,
               const bf16* __restrict__ w16, bf16* __restrict__ out, int H, int W, int heads,
               int hd, int vb, TcDims d) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int C = d.C, kc = d.kc, sa = d.sa, G = d.g;
  const Pack16 pw(w16, d);
  bf16* ws = reinterpret_cast<bf16*>(tc_smem + d.offW);
  unsigned char* re = tc_smem + d.offE;
  unsigned char* ra = tc_smem + d.offA;
  bf16* rb = reinterpret_cast<bf16*>(tc_smem + d.offB);
  int* tinfo = reinterpret_cast<int*>(tc_smem + d.offT);  // [pixel][2]
  // the float32 vectors as the float32 pack lays them out, then rpb2
  float* vecs = reinterpret_cast<float*>(tinfo + 2 * d.np);
  const float *bq = vecs, *bk = vecs + C, *bv = vecs + 2 * C, *bp = vecs + 3 * C;
  const float *b1 = vecs + 4 * C, *b2 = vecs + 6 * C, *g1 = vecs + 7 * C, *be1 = vecs + 8 * C;
  const float *g2 = vecs + 9 * C, *be2 = vecs + 10 * C;
  float* rpb2 = vecs + 11 * C;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * d.tr, c0 = blockIdx.x * d.tc;
  const int r1 = min(r0 + d.tr, H), c1 = min(c0 + d.tc, W);
  const int hr0 = clampi(r0 - 1, 0, H - 3), hr1 = clampi(r1 - 2, 0, H - 3) + 3;
  const int hc0 = clampi(c0 - 1, 0, W - 3), hc1 = clampi(c1 - 2, 0, W - 3) + 3;
  const int hw = hc1 - hc0;
  const int nh = (hr1 - hr0) * hw;  // halo pixels
  const int tw = c1 - c0;
  const int np = (r1 - r0) * tw;    // tile pixels
  const int64_t img = (int64_t)b * H * W;
  const float inv_c = 1.f / C;
  constexpr float kLog2e = 1.4426950408889634f;

  // 0. emb over the halo, each halo row one contiguous run of hw * C values
  {
    bf16* eh = reinterpret_cast<bf16*>(re);
    const int lv = vb == 16 ? 4 : vb == 8 ? 3 : vb == 4 ? 2 : 1;
    const int units = (hw * C * 2) >> lv;
    for (int hr = 0; hr < hr1 - hr0; ++hr) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(emb + (img + (int64_t)(hr0 + hr) * W + hc0) * C);
      unsigned char* dst = reinterpret_cast<unsigned char*>(eh + hr * hw * C);
      for (int u = tid; u < units; u += blockDim.x) {
        copy_async(dst + (u << lv), src + (u << lv), vb, true);
      }
    }
  }
  // the tile's tables (one division a pixel, here only), the vectors and
  // rpb2, and the NAT output's K padding
  for (int p = tid; p < np; p += blockDim.x) {
    const int pr = p / tw;
    const int row = r0 + pr, col = c0 + p - pr * tw;
    const int wr = clampi(row - 1, 0, H - 3), wc = clampi(col - 1, 0, W - 3);
    const int hp = (row - hr0) * hw + col - hc0;
    const int wnd = (wr - hr0) * hw + wc - hc0;
    tinfo[2 * p] = hp | (wnd << 10) | (((wr - row + 2) * 5 + wc - col + 2) << 20);
    tinfo[2 * p + 1] = row * W + col;
  }
  {
    const float* src = wf + 8 * C * C;
    for (int i = tid; i < 11 * C; i += blockDim.x) vecs[i] = src[i];
    for (int i = tid; i < heads * 25; i += blockDim.x) rpb2[i] = src[11 * C + i] * kLog2e;
  }
  for (int p = tid; p < d.mt; p += blockDim.x) {
    for (int c = C; c < kc; ++c) rb[p * sa + c] = __float2bfloat16(0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  // 1. LN1 over the halo -> A (bf16)
  bf16* a1 = reinterpret_cast<bf16*>(ra);
  ln_rows(reinterpret_cast<const bf16*>(re), nh, C, kc, inv_c, g1, be1, a1, sa);
  __syncthreads();

  // 2. per group of heads: q, k, v on the tensor cores, then NAT into B
  float* kg = reinterpret_cast<float*>(re);
  float* vg = kg + d.mh * G;
  float* qg = vg + d.mh * G;
  const int hpg = G / hd;
  const int gn = d.gn;
  const int mth = (nh + 15) >> 4, mtt = (np + 15) >> 4;
  auto same_row = [](int r) { return r; };
  auto tile_row = [=](int r) { return tinfo[2 * min(r, np - 1)] & kNatMax; };
  for (int grp = 0; grp < d.ng; ++grp) {
    const int c0g = grp * G;
    const int run = gn * sa * 2;  // bytes of one matrix's group rows
    copy_run(ws, pw.wq + c0g * sa, run);
    copy_run(ws + gn * sa, pw.wk + c0g * sa, run);
    copy_run(ws + 2 * gn * sa, pw.wv + c0g * sa, run);
    cp_async_wait_all();
    __syncthreads();
    const float *bkg = bk + c0g, *bvg = bv + c0g, *bqg = bq + c0g;
    // k and v in one product: Wk's and Wv's group rows lie together in W
    gemm(a1, sa, same_row, mth, ws + gn * sa, sa, 2 * (gn >> 3), kc,
         [=](int row, int col, float v0, float v1) {
           if (row < nh) {
             float* dst = col < gn ? kg : vg;
             const float* bias = col < gn ? bkg : bvg;
             const int c = col < gn ? col : col - gn;
             if (c < G) dst[row * G + c] = v0 + bias[c];
             if (c + 1 < G) dst[row * G + c + 1] = v1 + bias[c + 1];
           }
         });
    gemm(a1, sa, tile_row, mtt, ws, sa, gn >> 3, kc,
         [=](int row, int col, float v0, float v1) {
           if (row < np) {
             if (col < G) qg[row * G + col] = (v0 + bqg[col]) * kLog2e;
             if (col + 1 < G) qg[row * G + col + 1] = (v1 + bqg[col + 1]) * kLog2e;
           }
         });
    __syncthreads();
    const int head0 = c0g / hd;
    switch (hd) {
      case 1: nat_heads<1>(qg, kg, vg, tinfo, rpb2, np, hw, G, hd, hpg, head0, rb, sa); break;
      case 2: nat_heads<2>(qg, kg, vg, tinfo, rpb2, np, hw, G, hd, hpg, head0, rb, sa); break;
      case 4: nat_heads<4>(qg, kg, vg, tinfo, rpb2, np, hw, G, hd, hpg, head0, rb, sa); break;
      case 8: nat_heads<8>(qg, kg, vg, tinfo, rpb2, np, hw, G, hd, hpg, head0, rb, sa); break;
      default: nat_heads<0>(qg, kg, vg, tinfo, rpb2, np, hw, G, hd, hpg, head0, rb, sa);
    }
    __syncthreads();
  }

  // 3. att = nat Wp + bp + emb -> A (float32); emb again from device
  // memory (the halo's copy is gone; these bytes sit in L2)
  copy_run(ws, pw.wp, d.nc * sa * 2);
  cp_async_wait_all();
  __syncthreads();
  float* att = reinterpret_cast<float*>(ra);
  const bf16* eimg = emb + img * C;
  gemm(rb, sa, same_row, mtt, ws, sa, d.nc >> 3, kc,
       [=](int row, int col, float v0, float v1) {
         if (row < np) {
           const bf16* e = eimg + (int64_t)tinfo[2 * row + 1] * C;
           if (col < C) att[row * C + col] = v0 + bp[col] + to_f32(e[col]);
           if (col + 1 < C) att[row * C + col + 1] = v1 + bp[col + 1] + to_f32(e[col + 1]);
         }
       });
  __syncthreads();

  // 4. LN2(att) -> B (bf16), W1 staged meanwhile; the hidden's K padding
  copy_run(ws, pw.w1, d.n2 * sa * 2);
  bf16* hid = reinterpret_cast<bf16*>(re);
  const int s4 = d.s4, n2 = d.n2;
  for (int p = tid; p < d.mt; p += blockDim.x) {
    for (int c = n2; c < d.k2; ++c) hid[p * s4 + c] = __float2bfloat16(0.f);
  }
  ln_rows(att, np, C, kc, inv_c, g2, be2, rb, sa);
  cp_async_wait_all();
  __syncthreads();

  // 5. hidden = gelu(LN2 W1 + b1) -> E (bf16)
  const int c2 = 2 * C;
  gemm(rb, sa, same_row, mtt, ws, sa, n2 >> 3, kc,
       [=](int row, int col, float v0, float v1) {
         const float h0 = col < c2 ? gelu_tanh(v0 + b1[col]) : 0.f;
         const float h1 = col + 1 < c2 ? gelu_tanh(v1 + b1[col + 1]) : 0.f;
         *reinterpret_cast<__nv_bfloat162*>(hid + row * s4 + col) = __floats2bfloat162_rn(h0, h1);
       });
  __syncthreads();

  // 6. out = hidden W2 + b2 + att, stored from the registers
  copy_run(ws, pw.w2, d.nc * s4 * 2);
  cp_async_wait_all();
  __syncthreads();
  bf16* oimg = out + img * C;
  gemm(hid, s4, same_row, mtt, ws, s4, d.nc >> 3, d.k2,
       [=](int row, int col, float v0, float v1) {
         if (row < np && col < C) {
           bf16* o = oimg + (int64_t)tinfo[2 * row + 1] * C + col;
           const float y0 = v0 + b2[col] + att[row * C + col];
           if (col + 1 < C) {
             const float y1 = v1 + b2[col + 1] + att[row * C + col + 1];
             if ((C & 1) == 0) {
               *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
             } else {
               o[0] = __float2bfloat16(y0);
               o[1] = __float2bfloat16(y1);
             }
           } else {
             o[0] = __float2bfloat16(y0);
           }
         }
       });
}

// ---------------------------------------------------------------------------
// plans
// ---------------------------------------------------------------------------

// float32: the first of 8x16, 8x8, 4x8, 4x4, 2x4, 2x2, 1x2, 1x1 (rows x
// cols) whose buffers fit the budget (1x1: the card's limit); 0 if none.
int f32_tile(int C, int* R, int* TW) {
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

// bf16: the first tile of the list, and for it the largest channel group
// (all C; else a divisor of C that is a multiple of 8 and of head_dim),
// whose shared memory leaves two blocks on an SM (113 KB each of its 228
// KB); failing that, the first that fits one block. A group holds at most
// kTcThreads heads (a thread per head in the NAT). false if none fits.
constexpr int kTwoBlocks = 113 * 1024;

bool tc_plan(int C, int heads, int hd, TcDims* out) {
  static const int tiles[][2] = {{16, 32}, {16, 16}, {8, 16}, {8, 8}, {4, 8},
                                 {4, 4},   {2, 4},   {2, 2},  {1, 2}, {1, 1}};
  static const int budgets[] = {kTwoBlocks, kSmemMax};
  for (const int budget : budgets) {
    for (const auto& t : tiles) {
      for (int g = C; g >= 1; --g) {
        if (C % g || g % hd || (g != C && g % 8) || g / hd > kTcThreads) continue;
        const TcDims d = tc_dims(C, heads, t[0], t[1], g);
        if (d.smem <= budget && (t[0] + 2) * (t[1] + 2) <= kNatMax) {
          *out = d;
          return true;
        }
      }
    }
  }
  return false;
}

bool shape_ok(int B, int H, int W, int heads, int hd) {
  return B > 0 && B <= 65535 && H >= 3 && W >= 3 && heads > 0 && hd > 0 &&
         (long long)heads * hd <= 4096 && (long long)H * W <= 0x7fffffffLL / (heads * hd);
}

template <typename Kern>
int set_smem(Kern kern) {
  static bool done = false;  // raise the kernel's shared-memory ceiling once
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemMax);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

}  // namespace

// The kernel's own plan for (B, H, W*C) emb of dtype (0 = float32, 1 =
// bfloat16), C = heads * hd, into out[5]: tile rows, tile columns, channel
// group (C for float32), copy unit in bytes (0 for float32: it copies
// element by element), shared-memory bytes. Returns 0, or -1 for a shape it
// does not take (out untouched).
extern "C" int lmnet_natt_flat_plan(int B, int H, int W, int heads, int hd, int dtype,
                                    long long* out) {
  if (!shape_ok(B, H, W, heads, hd)) return -1;
  const int C = heads * hd;
  if (dtype == 0) {
    int R, TW;
    const int smem = f32_tile(C, &R, &TW);
    if (smem == 0) return -1;
    const long long v[5] = {R, TW, C, 0, smem};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
    return 0;
  }
  TcDims d;
  if (dtype != 1 || !tc_plan(C, heads, hd, &d)) return -1;
  const long long v[5] = {d.tr, d.tc, d.g, vec_bytes(2LL * C), d.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// emb and out: (B, H, W*C), dtype 0 = float32, 1 = bfloat16, contiguous.
// weights: float32, packed as wq, wk, wv, wp (each (C, C), (in, out), the NAT
// scale folded into wq), w1 (C, 2C), w2 (2C, C), then bq, bk, bv, bp (C
// each), b1 (2C), b2, g1, be1, g2, be2 (C each), rpb (heads, 5, 5).
// weights16 (bf16 emb only; may be null for float32): the six matrices in
// bf16 as Pack16 lays them out. The plan (tile rows and columns, group, copy
// unit, shared memory) must equal lmnet_natt_flat_plan's. Returns the
// launch's CUDA error (0 on success); cudaErrorInvalidValue for a shape or
// plan it does not take.
extern "C" int lmnet_natt_flat(const void* emb, const void* weights, const void* weights16,
                               void* out, int B, int H, int W, int heads, int hd, int dtype,
                               int tile_rows, int tile_cols, int group, int vb, long long smem,
                               void* stream) {
  long long plan[5];
  if (lmnet_natt_flat_plan(B, H, W, heads, hd, dtype, plan) != 0 || plan[0] != tile_rows ||
      plan[1] != tile_cols || plan[2] != group || plan[3] != vb || plan[4] != smem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  const dim3 grid((W + tile_cols - 1) / tile_cols, (H + tile_rows - 1) / tile_rows, B);
  if (dtype == 0) {
    const int err = set_smem(natt_f32_kernel<float>);
    if (err != 0) return err;
    natt_f32_kernel<float><<<grid, kThreads, smem, s>>>(static_cast<const float*>(emb), w,
                                                        static_cast<float*>(out), H, W, heads,
                                                        hd, tile_rows, tile_cols);
    return (int)cudaGetLastError();
  }
  if (weights16 == nullptr) return (int)cudaErrorInvalidValue;
  const int err = set_smem(natt_tc_kernel);
  if (err != 0) return err;
  const TcDims d = tc_dims(heads * hd, heads, tile_rows, tile_cols, group);
  natt_tc_kernel<<<grid, kTcThreads, smem, s>>>(static_cast<const bf16*>(emb), w,
                                                static_cast<const bf16*>(weights16),
                                                static_cast<bf16*>(out), H, W, heads, hd, vb, d);
  return (int)cudaGetLastError();
}
