// Shared by the two NAT kernels of the default path, nat_fwd.cu (B1) and
// nat_bwd.cu (B2): their launch plan, the clamped window, and the copy of a
// halo of pixels into shared memory in 16-byte (or narrower) cp.async units;
// and by B1 and nat_kernel.cu (B3): the forward's compute of one query
// pixel (window_vec, window_generic).
//
// The plan is computed twice: here, and in Python by
// lmnet_tpu_torch/ops/nat_flat.py::nat_plan, which the CPU tests check at
// every shape the paths give the kernels. The entry points refuse a launch
// whose plan differs from their own. The two must stay the same function.

#pragma once

#include "rc_common.cuh"

namespace lmnet_nat {

using lmnet_rc::copy_async;
using lmnet_rc::cp_async_wait_all;
using lmnet_rc::from_f32;
using lmnet_rc::to_f32;
using lmnet_rc::vec_bytes;

constexpr int kSms = 132;              // H100 SXM
constexpr long long kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr long long kSmemTarget = kMaxSmem / 2;  // two blocks an SM
constexpr int kMaxBlockHeads = 32;     // heads a block, at most
constexpr int kMaxThreads = 384;       // threads a block, at most
constexpr int kMaxHeadsPerThread = 4;  // B1: the logits of 4 heads x 9 slots in registers
// The tiles a plan starts from, (rows, columns) of pixels: B1's, B2's
// (ops/nat_flat.py::FWD_TILE, BWD_TILE), the fastest of those tried on the
// H100 at the four 256^2 stages.
constexpr int kFwdRows = 32, kFwdCols = 32;
constexpr int kBwdRows = 32, kBwdCols = 16;
// blocks an SM the kernels' registers are bounded for: 65536 / (2 x 384),
// at most 80 registers a thread
constexpr int kMinBlocks = 2;
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kFwd = 0, kBwd = 1 };

struct Plan {
  int vec;      // 1: head_dim 1, 2, 4 or 8 at compile time, halos staged; 0: generic
  int per;      // heads a thread
  int rows, cols;  // the tile of pixels a block owns
  int nh;       // heads a block (the last head chunk may hold fewer)
  int ppb;      // pixels a pass of the block's threads covers
  int threads;  // nh / per * ppb
  int gx, gy, gz;  // grid: column tiles, row tiles, images x head chunks
  int vb;       // halo copy unit in bytes
  long long smem;       // dynamic shared memory bytes
  long long workspace;  // B2's float32 d_rpb partials
};

__host__ __device__ inline long long r16(long long x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Byte offsets of a block's shared-memory regions. B1 (vec): k halo, v halo,
// rpb. B2: a record per query-halo pixel and head (vec: q scaled, g, lse and
// delta in float32; generic: lse and delta), rpb, then the k and v halos
// (vec); the d_rpb partial sums reuse the space once the key pass is done.
struct Layout {
  long long k, v, rpb;          // B1
  long long stats, rp, kb, vbuf, red;  // B2
  long long total;
};

__host__ __device__ inline Layout layout(int kind, int vec, int rows, int cols, int nh, int hd,
                                         int es, int threads) {
  Layout L = {};
  const long long ck = (long long)nh * hd * es;  // bytes of a pixel's chunk
  const long long rp = r16(25LL * nh * 4);
  if (kind == kFwd) {
    const long long halo = vec ? r16((long long)(rows + 2) * (cols + 2) * ck) : 0;
    L.k = 0;
    L.v = halo;
    L.rpb = 2 * halo;
    L.total = 2 * halo + rp;
    return L;
  }
  const long long kh = vec ? r16((long long)(rows + 6) * (cols + 6) * ck) : 0;
  const long long red = r16(25LL * threads * 4);
  // a query's record: (q * scale * log2 e, g, lse, delta) at head_dim 1
  // (vec); (lse, delta) otherwise
  const long long rec = vec && hd == 1 ? 4 : 2;
  L.stats = 0;
  L.rp = r16((long long)(rows + 4) * (cols + 4) * nh * rec * 4);
  L.kb = L.rp + rp;
  L.vbuf = L.kb + kh;
  L.red = 0;
  L.total = L.vbuf + kh > red ? L.vbuf + kh : red;
  return L;
}

// threads a pass: heads-per-block / heads-per-thread threads a pixel, and the
// largest power of two of pixels, at most 128, that keeps the block within
// kMaxThreads
inline int pixels_per_pass(int tpp) {
  int ppb = 128;
  while (ppb > 1 && tpp * ppb > kMaxThreads) ppb /= 2;
  return ppb;
}

// A thread's channels in B1's (and B3's) vectorised variant: 16 or else 8
// bytes of at most 4 whole heads that divide C; a float32 head of 8 takes 32
// bytes; 0 if none.
inline int group_channels(int hd, long long C, int es) {
  if (hd == 8 && es == 4) return 8;
  for (int gb = 16; gb >= 8; gb /= 2) {
    const int gc = gb / es;
    if (gc >= hd && gc <= kMaxHeadsPerThread * hd && C % gc == 0) return gc;
  }
  return 0;
}

// The plan for a call of B1 (kind kFwd) or B2 (kBwd) on (B, H, W, heads x hd)
// in elements of es bytes; false for a shape the kernels do not take.
inline bool make_plan(int kind, int B, int H, int W, int heads, int hd, int es, Plan* p) {
  if (B <= 0 || H < 3 || W < 3 || heads <= 0 || hd <= 0 || (es != 2 && es != 4)) return false;
  if (kind == kBwd && heads > 256) return false;
  const long long C = (long long)heads * hd;
  const bool pow2 = hd == 1 || hd == 2 || hd == 4 || hd == 8;
  int per = 1, rows, cols;
  bool vec = pow2;
  if (kind == kFwd) {
    const int g = group_channels(hd, C, es);
    vec = pow2 && g > 0;
    per = vec ? g / hd : 1;
    rows = kFwdRows;
    cols = kFwdCols;
  } else {
    rows = kBwdRows;
    cols = kBwdCols;
  }
  rows = rows < H ? rows : H;
  cols = cols < W ? cols : W;
  int nh = (heads < kMaxBlockHeads ? heads : kMaxBlockHeads) / per * per;

  auto blocks = [&]() {
    return (long long)cdiv(W, cols) * cdiv(H, rows) * B * cdiv(heads, nh);
  };
  auto smem = [&]() {
    const int tpp = nh / per;
    return layout(kind, vec, rows, cols, nh, hd, es, tpp * pixels_per_pass(tpp)).total;
  };
  while (rows > 2 && blocks() < 2 * kSms) rows /= 2;
  while (smem() > kSmemTarget) {
    if (nh > per) {
      const int half = nh / 2 / per * per;
      nh = half > per ? half : per;
    } else if (cols > 8) {
      cols /= 2;
    } else if (rows > 1) {
      rows /= 2;
    } else {
      break;
    }
  }
  if (smem() > kMaxSmem) return false;
  p->vec = vec;
  p->per = per;
  p->rows = rows;
  p->cols = cols;
  p->nh = nh;
  p->ppb = pixels_per_pass(nh / per);
  p->threads = nh / per * p->ppb;
  p->gx = cdiv(W, cols);
  p->gy = cdiv(H, rows);
  const long long gz = (long long)B * cdiv(heads, nh);
  if (p->gy > 65535 || gz > 65535) return false;
  p->gz = (int)gz;
  const int a = vec_bytes((long long)nh * hd * es);
  const int b = vec_bytes(C * es);
  p->vb = a < b ? a : b;
  p->smem = smem();
  p->workspace = kind == kBwd ? (long long)B * p->gx * p->gy * heads * 25 : 0;
  return true;
}

// first row (or column) of the clamped 3-wide window around x in [0, n)
__device__ __forceinline__ int window_start(int x, int n) { return min(max(x - 1, 0), n - 3); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The plan as 14 numbers, for the ctypes entries that report it: vec, per,
// rows, cols, nh, ppb, threads, gx, gy, gz, vb, smem, workspace, and 1 (a
// plan was made) or 0 (the shape is refused; the rest is then 0).
inline void export_plan(int kind, int B, int H, int W, int heads, int hd, int es,
                        long long* out) {
  Plan p = {};
  const bool ok = make_plan(kind, B, H, W, heads, hd, es, &p);
  const long long v[14] = {p.vec, p.per, p.rows, p.cols, p.nh, p.ppb, p.threads, p.gx,
                           p.gy, p.gz, p.vb, p.smem, p.workspace, ok};
  for (int i = 0; i < 14; ++i) out[i] = ok || i == 13 ? v[i] : 0;
}

// Walks a rows x cols rectangle of pixels from pixel p0 in steps of `step`
// pixels, row-major, with no division in the loop: the start and the step
// are split into (row, column) once.
struct Walk {
  int r, c, sr, sc, cols;
  __device__ __forceinline__ Walk(int p0, int step, int ncols)
      : r(p0 / ncols), c(p0 % ncols), sr(step / ncols), sc(step % ncols), cols(ncols) {}
  __device__ __forceinline__ void next() {
    c += sc;
    r += sr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Copy a halo of nr x nc pixels whose first is (r_org, c_org) of an image
// (src: the image's first byte of the block's channels; W pixels a row,
// pstride bytes a pixel) into dst (dst_w pixels a row, dst_pstride bytes a
// pixel): run bytes a pixel, in units of vb bytes (16-byte cp.async where vb
// is 16). Thread t moves unit t % (run / vb) of pixels t / (run / vb), then
// every (threads / units)-th after it; the threads past the last whole set
// of units copy nothing. Wait with cp_async_wait_all.
__device__ __forceinline__ void copy_halo(unsigned char* dst, const unsigned char* src,
                                          int r_org, int c_org, int nr, int nc, int dst_w,
                                          int W, long long pstride, int dst_pstride, int run,
                                          int vb) {
  const int units = run / vb;
  const int sets = blockDim.x / units;
  if ((int)threadIdx.x >= sets * units) return;
  const int cv = threadIdx.x % units;
  Walk w(threadIdx.x / units, sets, nc);
  for (; w.r < nr; w.next()) {
    copy_async(dst + (long long)(w.r * dst_w + w.c) * dst_pstride + cv * vb,
               src + ((long long)(r_org + w.r) * W + c_org + w.c) * pstride + cv * vb, vb, true);
  }
}

// N consecutive elements of T at an address aligned to min(16, N*sizeof(T))
// bytes, as float32; and the store back.
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&out)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + j);
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[j + 2 * i] = __uint_as_float(w[i] << 16);
        out[j + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    out[0] = __uint_as_float(u << 16);
    out[1] = __uint_as_float(u & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + j);
      out[j] = u.x;
      out[j + 1] = u.y;
      out[j + 2] = u.z;
      out[j + 3] = u.w;
    }
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    out[0] = u.x;
    out[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int N>
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float (&in)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 8) {
      *reinterpret_cast<uint4*>(p + j) =
          make_uint4(pack_bf16(in[j], in[j + 1]), pack_bf16(in[j + 2], in[j + 3]),
                     pack_bf16(in[j + 4], in[j + 5]), pack_bf16(in[j + 6], in[j + 7]));
    }
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(in[0], in[1]), pack_bf16(in[2], in[3]));
  } else if constexpr (N == 2) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16(in[i]);
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&in)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(in[j], in[j + 1], in[j + 2], in[j + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = in[i];
  }
}

// One query pixel of the vectorised variant (B1 and B3): NH heads of
// head_dim HD, G = HD * NH channels read at qp as one vector; their 3x3
// windows from a staged halo (kw, vw: window slot 0's pixel at the thread's
// channels; hw pixels a halo row, ck elements a pixel); the bias times
// log2 e from `bias` (slot 0's entry of the thread's heads; one entry is
// bstride floats on). The 9 logits of each head stay in registers, the
// softmax runs in base 2 (q scaled by scale2 = scale * log2 e), and out is
// stored as one vector at op.
template <typename T, int HD, int NH>
__device__ __forceinline__ void window_vec(const T* qp, const T* kw, const T* vw, int hw, int ck,
                                           const float* bias, int bstride, float scale2, T* op) {
  constexpr int G = HD * NH;
  float qf[G];
  load_f32<G>(qp, qf);
#pragma unroll
  for (int d = 0; d < G; ++d) qf[d] *= scale2;
  float s[NH][9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float kf[G], bv[NH];
    load_f32<G>(kw + ((i / 3) * hw + i % 3) * ck, kf);
    load_f32<NH>(bias + ((i / 3) * 5 + i % 3) * bstride, bv);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float dot = bv[h];
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qf[h * HD + d], kf[h * HD + d], dot);
      s[h][i] = dot;
    }
  }
  float inv[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float m = s[h][0];
#pragma unroll
    for (int i = 1; i < 9; ++i) m = fmaxf(m, s[h][i]);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      s[h][i] = ex2(s[h][i] - m);
      den += s[h][i];
    }
    inv[h] = __fdividef(1.f, den);
  }
  float acc[G];
#pragma unroll
  for (int d = 0; d < G; ++d) acc[d] = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float vf[G];
    load_f32<G>(vw + ((i / 3) * hw + i % 3) * ck, vf);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[h * HD + d] = fmaf(s[h][i], vf[h * HD + d], acc[h * HD + d]);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[h * HD + d] *= inv[h];
  }
  store_f32<G>(op, acc);
}

// One (query pixel, head) of the generic variant (B1 and B3), head_dim hd
// at run time: q at qp, its window's slot 0 at kp and vp (the next window
// row is rs elements on, the next column ps), the bias times log2 e as in
// window_vec; out at op. I is the index type of the strides: int64_t for
// device memory, int for a staged halo.
template <typename T, typename I>
__device__ __forceinline__ void window_generic(const T* qp, const T* kp, const T* vp, I rs, I ps,
                                               int hd, const float* bias, int bstride,
                                               float scale2, T* op) {
  float s[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const T* kq = kp + (i / 3) * rs + (i % 3) * ps;
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(to_f32(qp[d]), to_f32(kq[d]), dot);
    s[i] = fmaf(dot, scale2, bias[((i / 3) * 5 + i % 3) * bstride]);
  }
  float m = s[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) m = fmaxf(m, s[i]);
  float den = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    s[i] = ex2(s[i] - m);
    den += s[i];
  }
  const float inv = __fdividef(1.f, den);
  for (int d = 0; d < hd; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) acc = fmaf(s[i], to_f32(vp[(i / 3) * rs + (i % 3) * ps + d]), acc);
    op[d] = from_f32<T>(acc * inv);
  }
}

}  // namespace lmnet_nat
