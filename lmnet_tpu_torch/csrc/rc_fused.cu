// The deploy-mode ReparamConv block in two passes, on NHWC activations:
//   e = hardswish(We x + be)                     (1x1 expand, BN folded in)
//   t = gelu_tanh(dw5x5(e; kdw) + bdw)           (zero padding of e)
//   s = hardsigmoid(fc2(relu(fc1(mean_hw(t)))))  (squeeze-excitation)
//   y = Wp (t * s) + bp + Wsc x + bsc            (pointwise + shortcut)
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/rc_kernel.py::fused_reparam_conv
// (_rc_phase1_kernel, _rc_phase2_kernel). As there, the SE mean is a
// synchronisation point, so the block runs in two passes and recomputes t:
// phase 1 computes t on chip and writes only per-tile channel sums, which
// lmnet_rc::reduce_partials_warp adds in a fixed order into (B, E) (bitwise
// repeatable, no atomics); the SE MLP then runs in torch on (B, E); phase 2
// recomputes t, scales it by s and computes both 1x1 products, the biases
// and the residual, writing y once.
//
// bfloat16 x (the served dtype), rc_tc_kernel. As the TPU kernel does its
// three 1x1 products on its matrix unit with bf16 operands and float32
// accumulation (rc_kernel.py:68-70, :137-139), this one does them on the
// tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> f32, A fragments by
// ldmatrix from shared memory. mma.sync and not wgmma: its 16-row M tiles
// fit the expand's 144- or 240-pixel halo and the 64- or 128-pixel output
// tile exactly, N runs down to 8 (Cout = 12 pads to 16, not to wgmma's 64-row
// A tile of weights), and the products are a small share of the block's
// work, so wgmma's asynchrony buys nothing here. Rounding points: x is bf16;
// We, Wp and Wsc are rounded to bf16 once, when ops/rc_kernel.py packs them;
// the expand's output e is kept in float32 (JAX's TPU kernel rounds it to
// bf16); the depthwise sum, bias, GELU, hardswish and the channel sums are
// float32 on the CUDA cores; t * s is rounded to bf16 as the pointwise
// product's A operand; every product accumulates in float32; y is stored
// in bf16. ops/rc_kernel.py::fused_reparam_conv_plain rounds at the same
// points for bf16 x.
//
// The row window (the mesh's 'spatial' axis, parallel/spatial.py): x is a
// slab of Hs rows and output row r is slab row top + r, for the H output
// rows. A halo row outside the slab is zero in x and, after the expand, in
// e (the depthwise's zero padding, not hardswish(be)); phase 1's sums cover
// the H output rows; phase 2 reads the same slab. On an H shard the slab
// has no rows past the global edges (halo(x, 2, 2, edges=False)), so the
// edge rank's missing rows are the global padding. The whole map is Hs = H,
// top = 0.
//
// The layout: a block owns an 8 x TW output tile of one image (TW = 16, or
// 8 where 16 would leave fewer than two blocks per SM or too many
// accumulators per warp; ops/rc_kernel.py::rc_plan picks it and this file
// checks the choice). It copies the (8+4) x (TW+4) halo of x into shared
// memory as bf16, K zero-padded to a multiple of 16: with 16-byte cp.async
// where Cin * 2 is a multiple of 16, else (Cin = 3, 12) a thread zeroes a
// pixel's row with 16-byte stores and copies x's 2- or 8-byte units over
// it. Then, ec expanded channels at a time (ec = 32, 24, 16 or 8, the
// largest that divides E rounded up to 8; 8 x ec threads), with the chunk's
// We and Wp staged into shared memory by cp.async:
//   expand: M = the halo's pixels, N = ec, K = Cin -> hardswish -> e in
//     float32 in shared memory, zero outside the image;
//   depthwise: thread (tile row, channel) slides a 5x5 window of registers
//     along its row (5 shared-memory loads and 25 FMAs an output, in five
//     independent row chains) -> GELU; phase 1 sums t per channel, phase 2
//     writes bf16(t * s) to shared memory;
//   pointwise (phase 2): M = the tile's pixels, N = Cout padded to 8, K = ec
//     padded to 16, accumulated into y in registers across the chunks; with
//     the first chunk y starts from the biases and the shortcut product (M =
//     the tile's pixels, K = Cin, Wsc staged once).
// y is stored from the registers. The weights arrive packed (one buffer,
// zero-padded bf16 layouts in pack_layout below) from
// ops/rc_kernel.py::pack_rc_weights, once per fold. Phase 2's registers
// set its blocks per SM: a single-chunk block (E <= 24, the 256^2 blocks)
// takes y's registers only after the depthwise and fits 80 registers, 4
// blocks an SM; a multi-chunk one keeps y through every chunk's depthwise
// and is held to 113 (192 threads) or 128 (256) registers, where tighter
// bounds spilled.
//
// What bounds it on an H100: the CUDA cores. Its products (expand over the
// halo, pointwise, shortcut; ~30 GFLOP for the 16 served blocks of a 256^2,
// B=16 forward, both phases) take ~0.03 ms of the tensor cores; its bytes
// (x twice, y once) 0.11 ms of HBM; its depthwise, GELU and hardswish,
// done twice, ~0.2 ms at the float32 peak and more in issue slots, where
// the window's shared-memory loads and the activations compete with the
// FMAs. At 64^2 and 32^2 a call is bound by the host (the wrapper, the SE
// MLP's torch ops and the two phases' launches take longer than the
// device's ~0.1 ms).
//
// float32 x, rc_f32_kernel: the products stay float32 on the CUDA cores
// (PR 3's design, the exact reference the CPU parity tests and the float32
// checks use): one block per 8x8 tile, a float32 halo of x, 32 expanded
// channels at a time, the tile's (64, Cout) output sums in shared memory,
// weights read as float32 transposes from the packed buffer.
//
// Tried before, and slower (the 16 served blocks of a 256^2, B=16 forward
// in bf16, NVIDIA H100): PR 3's float32 design for bf16 x as well, 17.5 ms
// (about 2 TFLOP/s on the counted work: each multiply-add issued a weight
// load through L1 and an operand load from shared memory, and the expand
// ran 2.25x over the 12x12 halo of an 8x8 tile in both phases), 1.6-1.9x
// slower than the plain cuBLAS/cuDNN block; this design with an IEEE
// divide in hardswish, one 25-FMA chain a depthwise output, 2-byte copies
// of the Cin = 3 halo and phase 2 at 128 registers: 4.8-5.1 ms, phase 2 at
// 256^2 twice phase 1 (363 against 186 us); an 85-register bound on every
// phase-2 block: the y tiles spilled (280 bytes) and the 128^2 block's
// phase 2 went from 151 to 174 us.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_kernel.py).

#include "mma_bf16.cuh"
#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;
using namespace lmnet_tc;

constexpr int kRows = 8;                   // output tile rows (both kernels)
constexpr size_t kMaxSmem = 232448;        // a block's shared-memory limit on sm_90
constexpr int kMinBlocks = 2 * 132;        // two blocks for each SM of an H100
constexpr int kMaxPairs = 6;               // (16 x 8) y tiles a warp keeps in registers, at most

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The bf16 kernel's padded sizes for a (Cin, E, Cout) block.
struct Dims {
  int Cin, E, Cout;
  int ec;      // expanded channels per chunk
  int nchunk;  // chunks: E rounded up to 8, over ec
  int kc;      // ec rounded up to 16: the pointwise K per chunk
  int kx;      // Cin rounded up to 16: the expand's and the shortcut's K
  int np;      // Cout rounded up to 8: the pointwise's and the shortcut's N
};

Dims dims(int Cin, int E, int Cout) {
  Dims d;
  d.Cin = Cin;
  d.E = E;
  d.Cout = Cout;
  const int ep = round_up(E, 8);
  d.ec = ep % 32 == 0 ? 32 : ep % 24 == 0 ? 24 : ep % 16 == 0 ? 16 : 8;
  d.nchunk = ep / d.ec;
  d.kc = round_up(d.ec, 16);
  d.kx = round_up(Cin, 16);
  d.np = round_up(Cout, 8);
  return d;
}

// Offsets in float32 words of the packed weights (ops/rc_kernel.py::
// pack_layout is the same function): float32 weT (Cin, E), wpT (E, Cout),
// wscT (Cin, Cout), be (E), kdw (25, E), bdw (E), bp (Cout), bsc (Cout);
// then bf16, two to a word: we16 (E8, kx), wp16 (np, nchunk * kc), wsc16
// (np, kx), zero-padded. Each entry starts on a 16-byte boundary.
struct Layout {
  long long weT, wpT, wscT, be, kdw, bdw, bp, bsc, we16, wp16, wsc16, total;
};

Layout pack_layout(const Dims& d) {
  Layout L;
  long long off = 0;
  auto put = [&off](long long n) {
    const long long o = off;
    off = (off + n + 3) / 4 * 4;
    return o;
  };
  L.weT = put((long long)d.Cin * d.E);
  L.wpT = put((long long)d.E * d.Cout);
  L.wscT = put((long long)d.Cin * d.Cout);
  L.be = put(d.E);
  L.kdw = put(25LL * d.E);
  L.bdw = put(d.E);
  L.bp = put(d.Cout);
  L.bsc = put(d.Cout);
  L.we16 = put((long long)d.nchunk * d.ec * d.kx / 2);
  L.wp16 = put((long long)d.np * d.nchunk * d.kc / 2);
  L.wsc16 = put((long long)d.np * d.kx / 2);
  L.total = off;
  return L;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

// shared-memory strides, in elements: rows of x's halo, We and Wsc (kx + 8),
// of t * s and Wp (kc + 8; both odd multiples of 16 bytes, so ldmatrix and
// the B-fragment loads hit 32 distinct banks), of e (floats; 8 or 24 mod
// 32, so the expand's float2 stores do)
__host__ __device__ inline int e_stride(int ec) { return ec % 16 == 8 ? ec : ec + 8; }

size_t tc_smem(const Dims& d, int tw, bool phase2) {
  const size_t hp = (size_t)(kRows + 4) * (tw + 4);
  size_t n = hp * (d.kx + 8) * 2 + (size_t)d.ec * (d.kx + 8) * 2 + hp * e_stride(d.ec) * 4;
  if (phase2) {
    n += (size_t)kRows * tw * (d.kc + 8) * 2 + (size_t)d.np * (d.kc + 8) * 2 +
         (size_t)d.np * (d.kx + 8) * 2;
  } else {
    n += (size_t)kRows * d.ec * 4;
  }
  return n;
}

// the (16 x 8) y tiles each warp keeps in registers
int tc_pairs(const Dims& d, int tw) {
  const int nwarps = kRows * d.ec / 32;
  const int pairs = (kRows * tw / 16) * (d.np / 8);
  return (pairs + nwarps - 1) / nwarps;
}

bool tc_fits(const Dims& d, int tw) {
  return tc_pairs(d, tw) <= kMaxPairs && tc_smem(d, tw, true) <= kMaxSmem;
}

// The tile width: 16 where it fits and leaves at least two blocks per SM
// (or where 8 does not fit), else 8; 0 where neither fits.
int tc_tile(const Dims& d, int B, int H, int W) {
  const long long blocks16 = (long long)B * ((H + kRows - 1) / kRows) * ((W + 15) / 16);
  if (tc_fits(d, 16) && (blocks16 >= kMinBlocks || !tc_fits(d, 8))) return 16;
  return tc_fits(d, 8) ? 8 : 0;
}

// ONE: a single chunk (E <= 24) whose y needs at most 3 tiles a warp; y's
// registers are then taken only after the depthwise, which lets a block of
// up to THREADS = 192 threads fit in 80 registers without spilling, 4 an SM
// (the 256^2 blocks of LM-Net). Otherwise a warp keeps kMaxPairs y tiles
// across the chunks, and blocks of up to 192 (ec <= 24) or 256 threads are
// held to 3 or 2 an SM's registers (113 or 128 a thread); tighter, the y
// tiles spill.
template <int TW, bool ONE, int THREADS, bool PHASE2>
__global__ void __launch_bounds__(THREADS, ONE ? 4 : (THREADS == 256 ? 2 : 3))
rc_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ se,
             const float* __restrict__ pk, Layout L, Dims d, float* __restrict__ part,
             bf16* __restrict__ out, int H, int W, int Hs, int top) {
  constexpr int HC = TW + 4;              // halo columns
  constexpr int HP = (kRows + 4) * HC;    // halo pixels
  constexpr int OUT = kRows * TW;         // tile pixels
  static_assert(HP % 16 == 0 && OUT % 16 == 0, "M tiles of 16 pixels");
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = d.kx + 8, ES = e_stride(d.ec), TS = d.kc + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // x's halo [pixel][kx]
  bf16* wes = xs + HP * XS;                   // the chunk's We [ec][kx]
  float* es = reinterpret_cast<float*>(wes + d.ec * XS);  // e [pixel][ec]
  bf16* ts = reinterpret_cast<bf16*>(es + HP * ES);       // bf16(t s) [pixel][kc]
  bf16* wps = ts + OUT * TS;                  // the chunk's Wp [np][kc]
  bf16* wscs = wps + d.np * TS;               // Wsc [np][kx]
  float* red = es + HP * ES;                  // phase 1: t's row sums [row][ec]

  const bf16* we16 = reinterpret_cast<const bf16*>(pk + L.we16);
  const bf16* wp16 = reinterpret_cast<const bf16*>(pk + L.wp16);
  const bf16* wsc16 = reinterpret_cast<const bf16*>(pk + L.wsc16);
  const float* be = pk + L.be;
  const float* kdw = pk + L.kdw;
  const float* bdw = pk + L.bdw;

  const int b = blockIdx.z;
  const int tr = blockIdx.y * kRows;  // the tile's first output row and column
  const int tc = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  // x's halo, zero outside the slab and the image and in the K padding
  const int vb = vec_bytes(2LL * d.Cin);
  const int nux = d.Cin * 2 / vb;  // copy units of x per halo pixel
  const bf16* xb = x + (int64_t)b * Hs * W * d.Cin;
  if (vb == 16) {  // 16-byte cp.async, the K padding zero-filled the same way
    const int nu = d.kx / 8;
    for (int i = tid; i < HP * nu; i += blockDim.x) {
      const int p = i / nu;
      const int u = i - p * nu;
      const int hr = p / HC;
      const int rr = top + tr - 2 + hr;  // a slab row
      const int cc = tc - 2 + (p - hr * HC);
      const bool in = u < nux && rr >= 0 && rr < Hs && cc >= 0 && cc < W;
      const bf16* src = in ? xb + ((int64_t)rr * W + cc) * d.Cin : xb;
      copy_async(xs + p * XS + u * 8, src + u * 8, 16, in);
    }
  } else {  // narrow runs (Cin = 3, 12): a thread zeroes a pixel's row, then copies x over it
    for (int p = tid; p < HP; p += blockDim.x) {
      uint4* row = reinterpret_cast<uint4*>(xs + p * XS);
      for (int u = 0; u < d.kx / 8; ++u) row[u] = make_uint4(0u, 0u, 0u, 0u);
      const int hr = p / HC;
      const int rr = top + tr - 2 + hr;
      const int cc = tc - 2 + (p - hr * HC);
      if (rr >= 0 && rr < Hs && cc >= 0 && cc < W) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(xb + ((int64_t)rr * W + cc) * d.Cin);
        for (int v = 0; v < nux; ++v) {
          store_vec(reinterpret_cast<unsigned char*>(row) + v * vb, src + v * vb, vb);
        }
      }
    }
  }
  if constexpr (PHASE2) {
    const int n16 = d.kx / 8;
    for (int i = tid; i < d.np * n16; i += blockDim.x) {
      const int n = i / n16;
      const int u = i - n * n16;
      copy_async(wscs + n * XS + u * 8, wsc16 + (int64_t)n * d.kx + u * 8, 16, true);
    }
    if (d.kc > d.ec) {  // t * s's K padding (8 columns: ec = 8 or 24) stays zero
      for (int o = tid; o < OUT; o += blockDim.x) {
        *reinterpret_cast<uint4*>(ts + o * TS + d.ec) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // y's (16 x 8) tiles: warp w keeps pairs w, w + nwarps, ...
  constexpr int MAXP = ONE ? 3 : kMaxPairs;
  const int NT = d.np / 8;
  const int npairs = (OUT / 16) * NT;
  float acc[MAXP][4];

  const int ncol = min(TW, W - tc);
  const int nchunk = ONE ? 1 : d.nchunk;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int c0 = ch * d.ec;
    {  // the chunk's We rows, and Wp columns in phase 2
      const int n16 = d.kx / 8;
      for (int i = tid; i < d.ec * n16; i += blockDim.x) {
        const int c = i / n16;
        const int u = i - c * n16;
        copy_async(wes + c * XS + u * 8, we16 + (int64_t)(c0 + c) * d.kx + u * 8, 16, true);
      }
      if constexpr (PHASE2) {
        const int k16 = d.kc / 8;
        for (int i = tid; i < d.np * k16; i += blockDim.x) {
          const int n = i / k16;
          const int u = i - n * k16;
          copy_async(wps + n * TS + u * 8,
                     wp16 + ((int64_t)n * d.nchunk + ch) * d.kc + u * 8, 16, true);
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // expand + hardswish over the halo; zero outside the slab and the image
    const int ENT = d.ec / 8;
    for (int pr = warp; pr < (HP / 16) * ENT; pr += nwarps) {
      const int mt = pr / ENT;
      const int nt = pr - mt * ENT;
      float dd[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k(dd, xs + (mt * 16 + (lane & 15)) * XS + (lane >> 4) * 8,
            wes + (nt * 8 + g) * XS + 2 * tig, d.kx);
      const int c = nt * 8 + 2 * tig;
      const float be0 = c0 + c < d.E ? be[c0 + c] : 0.f;
      const float be1 = c0 + c + 1 < d.E ? be[c0 + c + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        const int hr = p / HC;
        const int rr = top + tr - 2 + hr;
        const int cc = tc - 2 + (p - hr * HC);
        const bool in = rr >= 0 && rr < Hs && cc >= 0 && cc < W;
        *reinterpret_cast<float2*>(es + p * ES + c) =
            in ? make_float2(hardswish(dd[2 * h] + be0), hardswish(dd[2 * h + 1] + be1))
               : make_float2(0.f, 0.f);
      }
    }
    __syncthreads();

    // depthwise 5x5 + bias + GELU: thread (tile row r, channel c)
    {
      const int c = tid % d.ec;
      const int r = tid / d.ec;
      const int ce = c0 + c;
      const bool live = ce < d.E;
      float wr[25];
#pragma unroll
      for (int i = 0; i < 25; ++i) wr[i] = live ? kdw[i * d.E + ce] : 0.f;
      const float bi = live ? bdw[ce] : 0.f;
      float sc = 0.f;
      if constexpr (PHASE2) sc = live ? se[(int64_t)b * d.E + ce] : 0.f;
      const bool rowin = tr + r < H;
      const float* ep = es + r * HC * ES + c;  // halo row r is output row r - 2
      float win[5][5];
#pragma unroll
      for (int j = 1; j < 5; ++j) {
#pragma unroll
        for (int i = 0; i < 5; ++i) win[i][j] = ep[(i * HC + j - 1) * ES];
      }
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < TW; ++q) {
        if (q >= ncol) break;
#pragma unroll
        for (int i = 0; i < 5; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) win[i][j] = win[i][j + 1];
          win[i][4] = ep[(i * HC + q + 4) * ES];
        }
        const float t = gelu_tanh(dw5x5<0>(bi, wr, win));
        if constexpr (PHASE2) {
          ts[(r * TW + q) * TS + c] = __float2bfloat16(t * sc);
        } else if (rowin) {
          sum += t;
        }
      }
      if constexpr (!PHASE2) red[r * d.ec + c] = sum;
    }
    __syncthreads();

    if constexpr (!PHASE2) {
      // the tile's channel sums: its rows in order
      if (tid < d.ec && c0 + tid < d.E) {
        float tot = 0.f;
        for (int r = 0; r < kRows; ++r) tot += red[r * d.ec + tid];
        const int64_t tile = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
        const int64_t ntiles = (int64_t)gridDim.x * gridDim.y;
        part[((int64_t)b * ntiles + tile) * d.E + c0 + tid] = tot;
      }
    } else {
      // y: the biases and the shortcut with the first chunk, then
      // y += bf16(t s) Wp over each chunk's K
#pragma unroll
      for (int j = 0; j < MAXP; ++j) {
        const int pr = warp + j * nwarps;
        if (pr < npairs) {
          const int mt = pr / NT;
          const int nt = pr - mt * NT;
          if (ch == 0) {
            const float* bp = pk + L.bp;
            const float* bsc = pk + L.bsc;
            const int co = nt * 8 + 2 * tig;
            const float b0 = co < d.Cout ? bp[co] + bsc[co] : 0.f;
            const float b1 = co + 1 < d.Cout ? bp[co + 1] + bsc[co + 1] : 0.f;
            acc[j][0] = acc[j][2] = b0;
            acc[j][1] = acc[j][3] = b1;
            const int o = mt * 16 + (lane & 15);
            mma_k(acc[j], xs + ((o / TW + 2) * HC + o % TW + 2) * XS + (lane >> 4) * 8,
                  wscs + (nt * 8 + g) * XS + 2 * tig, d.kx);
          }
          mma_k(acc[j], ts + (mt * 16 + (lane & 15)) * TS + (lane >> 4) * 8,
                wps + (nt * 8 + g) * TS + 2 * tig, d.kc);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (PHASE2) {
    bf16* ob = out + (int64_t)b * H * W * d.Cout;
#pragma unroll
    for (int j = 0; j < MAXP; ++j) {
      const int pr = warp + j * nwarps;
      if (pr < npairs) {
        const int mt = pr / NT;
        const int co = (pr - mt * NT) * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = mt * 16 + g + 8 * h;
          const int rr = tr + o / TW;
          const int cc = tc + o % TW;
          if (rr < H && cc < W && co < d.Cout) {
            bf16* dst = ob + ((int64_t)rr * W + cc) * d.Cout + co;
            if (co + 1 < d.Cout && (d.Cout & 1) == 0) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
              dst[0] = __float2bfloat16(acc[j][2 * h]);
              if (co + 1 < d.Cout) dst[1] = __float2bfloat16(acc[j][2 * h + 1]);
            }
          }
        }
      }
    }
  }
}

template <int TW, bool ONE, int THREADS, bool PHASE2>
int launch_tc(const void* x, const float* s, const float* pk, const Layout& L, const Dims& d,
              float* part, void* out, int B, int H, int W, int Hs, int top, size_t smem,
              cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(rc_tc_kernel<TW, ONE, THREADS, PHASE2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((W + TW - 1) / TW, (H + kRows - 1) / kRows, B);
  rc_tc_kernel<TW, ONE, THREADS, PHASE2><<<grid, kRows * d.ec, smem, stream>>>(
      static_cast<const bf16*>(x), s, pk, L, d, part, static_cast<bf16*>(out), H, W, Hs, top);
  return (int)cudaGetLastError();
}

// The instantiation for the plan's tile width and this shape: the
// single-chunk one (blocks of up to 192 threads) where it takes the shape,
// else by the block's threads.
template <int TW, bool PHASE2>
int launch_tc_tw(const void* x, const float* s, const float* pk, const Layout& L, const Dims& d,
                 float* part, void* out, int B, int H, int W, int Hs, int top, size_t smem,
                 cudaStream_t stream) {
  if (kRows * d.ec <= 192) {
    if (d.nchunk == 1 && tc_pairs(d, TW) <= 3) {
      return launch_tc<TW, true, 192, PHASE2>(x, s, pk, L, d, part, out, B, H, W, Hs, top, smem,
                                              stream);
    }
    return launch_tc<TW, false, 192, PHASE2>(x, s, pk, L, d, part, out, B, H, W, Hs, top, smem,
                                             stream);
  }
  return launch_tc<TW, false, 256, PHASE2>(x, s, pk, L, d, part, out, B, H, W, Hs, top, smem,
                                           stream);
}

template <bool PHASE2>
int launch_tc_for(int tw, const void* x, const float* s, const float* pk, const Layout& L,
                  const Dims& d, float* part, void* out, int B, int H, int W, int Hs, int top,
                  size_t smem, cudaStream_t stream) {
  return tw == 16
             ? launch_tc_tw<16, PHASE2>(x, s, pk, L, d, part, out, B, H, W, Hs, top, smem,
                                        stream)
             : launch_tc_tw<8, PHASE2>(x, s, pk, L, d, part, out, B, H, W, Hs, top, smem,
                                       stream);
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 8;                   // output tile edge
constexpr int kHalo = kTile + 4;           // halo edge of the 5x5 window
constexpr int kHaloPix = kHalo * kHalo;    // 144
constexpr int kOutPix = kTile * kTile;     // 64
constexpr int kChunk = 32;                 // expanded channels per pass
constexpr int kCS = kChunk + 1;            // row stride of e and t in shared memory
constexpr int kThreads = 256;

// xs (kHaloPix x (Cin + 1)), es (kHaloPix x kCS), ts (kOutPix x kCS) and in
// phase 2 ys (kOutPix x Cout), float32
size_t f32_smem(int Cin, int Cout, bool phase2) {
  size_t n = (size_t)kHaloPix * (Cin + 1) + (size_t)kHaloPix * kCS + (size_t)kOutPix * kCS;
  if (phase2) n += (size_t)kOutPix * Cout;
  return n * sizeof(float);
}

template <bool PHASE2>
__global__ void __launch_bounds__(kThreads)
rc_f32_kernel(const float* __restrict__ x, const float* __restrict__ se_scale,
              const float* __restrict__ pk, Layout L, float* __restrict__ part,
              float* __restrict__ out, int H, int W, int Hs, int top, int Cin, int E,
              int Cout) {
  extern __shared__ float smem_f[];
  const int xsd = Cin + 1;  // padded: neighbouring halo pixels on other banks
  float* xs = smem_f;
  float* es = xs + kHaloPix * xsd;
  float* ts = es + kHaloPix * kCS;
  float* ys = ts + kOutPix * kCS;
  const float* weT = pk + L.weT;
  const float* be = pk + L.be;
  const float* kdw = pk + L.kdw;
  const float* bdw = pk + L.bdw;

  const int b = blockIdx.z;
  const int tr = blockIdx.y * kTile;  // the tile's first output row and column
  const int tc = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const float* xb = x + (int64_t)b * Hs * W * Cin;

  for (int i = tid; i < kHaloPix * Cin; i += kThreads) {
    const int p = i / Cin;
    const int k = i - p * Cin;
    const int rr = top + tr - 2 + p / kHalo;  // a slab row
    const int cc = tc - 2 + p % kHalo;
    const bool in = rr >= 0 && rr < Hs && cc >= 0 && cc < W;
    xs[p * xsd + k] = in ? xb[((int64_t)rr * W + cc) * Cin + k] : 0.f;
  }
  __syncthreads();

  if constexpr (PHASE2) {  // the shortcut and both biases start the output sums
    const float* wscT = pk + L.wscT;
    const float* bp = pk + L.bp;
    const float* bsc = pk + L.bsc;
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
    // expand + hardswish over the halo; zero outside the slab and the image
    for (int i = tid; i < kHaloPix * ec; i += kThreads) {
      const int p = i / ec;
      const int c = i - p * ec;
      const int rr = top + tr - 2 + p / kHalo;
      const int cc = tc - 2 + p % kHalo;
      float v = 0.f;
      if (rr >= 0 && rr < Hs && cc >= 0 && cc < W) {
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
      const float* wpT = pk + L.wpT;
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
    float* ob = out + (int64_t)b * H * W * Cout;
    for (int i = tid; i < kOutPix * Cout; i += kThreads) {
      const int o = i / Cout;
      const int co = i - o * Cout;
      const int rr = tr + o / kTile;
      const int cc = tc + o % kTile;
      if (rr < H && cc < W) ob[((int64_t)rr * W + cc) * Cout + co] = ys[i];
    }
  }
}

template <bool PHASE2>
int launch_f32(const void* x, const float* s, const float* pk, const Layout& L, float* part,
               void* out, int B, int H, int W, int Hs, int top, int Cin, int E, int Cout,
               size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(rc_f32_kernel<PHASE2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  rc_f32_kernel<PHASE2><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), s, pk, L, part, static_cast<float*>(out), H, W, Hs, top, Cin,
      E, Cout);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the plan, checked against the caller's
// ---------------------------------------------------------------------------

struct Plan {
  int tile_rows, tile_cols;
  long long smem1, smem2, workspace, packed;
};

// false for a shape the kernels do not take
bool make_plan(int B, int H, int W, int Cin, int E, int Cout, int dtype, Plan* p) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || Cin <= 0 || E <= 0 || Cout <= 0) return false;
  if (dtype != 0 && dtype != 1) return false;
  const Dims d = dims(Cin, E, Cout);
  p->tile_rows = kRows;
  if (dtype == 0) {
    p->tile_cols = kTile;
    p->smem1 = (long long)f32_smem(Cin, Cout, false);
    p->smem2 = (long long)f32_smem(Cin, Cout, true);
  } else {
    p->tile_cols = tc_tile(d, B, H, W);
    if (p->tile_cols == 0) return false;
    p->smem1 = (long long)tc_smem(d, p->tile_cols, false);
    p->smem2 = (long long)tc_smem(d, p->tile_cols, true);
  }
  if (p->smem2 > (long long)kMaxSmem || (H + kRows - 1) / kRows > 65535) return false;
  const long long ntiles =
      (long long)((H + kRows - 1) / kRows) * ((W + p->tile_cols - 1) / p->tile_cols);
  p->workspace = (long long)B * ntiles * E;
  p->packed = pack_layout(d).total;
  return true;
}

bool plan_matches(const Plan& own, int tile_rows, int tile_cols, long long smem,
                  bool phase2, long long workspace, long long packed) {
  return tile_rows == own.tile_rows && tile_cols == own.tile_cols &&
         smem == (phase2 ? own.smem2 : own.smem1) && workspace == own.workspace &&
         packed == own.packed;
}

}  // namespace

// Phase 1. dtype: 0 = float32, 1 = bfloat16 (x, (B, Hs, W, Cin); output row
// r at slab row top + r, 0 <= top, top + H <= Hs). packed: the float32
// buffer of ops/rc_kernel.py::pack_rc_weights (pack_layout above). Writes
// sums, float32 (B, E): the per-image channel sums of t over the H output
// rows; part is float32 scratch.
// The plan (tile rows and columns, this phase's shared-memory bytes, part's
// and packed's sizes in floats) must equal make_plan's for this shape.
// Returns the first CUDA error: 0 on success; cudaErrorInvalidValue for a
// shape or plan the kernels do not take.
extern "C" int lmnet_rc_fused_phase1(const void* x, const void* packed, void* sums, void* part,
                                     int B, int H, int W, int Cin, int E, int Cout, int Hs,
                                     int top, int dtype, int tile_rows, int tile_cols,
                                     long long smem, long long workspace, long long packed_len,
                                     void* stream) {
  Plan own;
  if (top < 0 || top + H > Hs || !make_plan(B, H, W, Cin, E, Cout, dtype, &own) ||
      !plan_matches(own, tile_rows, tile_cols, smem, false, workspace, packed_len)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = dims(Cin, E, Cout);
  const Layout L = pack_layout(d);
  const float* pk = static_cast<const float*>(packed);
  float* p = static_cast<float*>(part);
  int err;
  if (dtype == 0) {
    err = launch_f32<false>(x, nullptr, pk, L, p, nullptr, B, H, W, Hs, top, Cin, E, Cout,
                            own.smem1, st);
  } else {
    err = launch_tc_for<false>(own.tile_cols, x, nullptr, pk, L, d, p, nullptr, B, H, W, Hs,
                               top, own.smem1, st);
  }
  if (err != 0) return err;
  const int n = (int)(own.workspace / ((long long)B * E));
  reduce_partials_warp<<<(B * E + kWarpsPerReduce - 1) / kWarpsPerReduce, 32 * kWarpsPerReduce,
                         0, st>>>(p, static_cast<float*>(sums), B * E, n, E, (long long)n * E, E);
  return (int)cudaGetLastError();
}

// Phase 2. As phase 1, plus s float32 (B, E), the SE scale. Writes out
// (B, H, W, Cout) in x's dtype: the H output rows. Returns the CUDA error of
// the launch: 0 on success.
extern "C" int lmnet_rc_fused_phase2(const void* x, const void* s, const void* packed,
                                     void* out, int B, int H, int W, int Cin, int E, int Cout,
                                     int Hs, int top, int dtype, int tile_rows, int tile_cols,
                                     long long smem, long long workspace, long long packed_len,
                                     void* stream) {
  Plan own;
  if (top < 0 || top + H > Hs || !make_plan(B, H, W, Cin, E, Cout, dtype, &own) ||
      !plan_matches(own, tile_rows, tile_cols, smem, true, workspace, packed_len)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d = dims(Cin, E, Cout);
  const Layout L = pack_layout(d);
  const float* pk = static_cast<const float*>(packed);
  const float* sf = static_cast<const float*>(s);
  if (dtype == 0) {
    return launch_f32<true>(x, sf, pk, L, nullptr, out, B, H, W, Hs, top, Cin, E, Cout,
                            own.smem2, st);
  }
  return launch_tc_for<true>(own.tile_cols, x, sf, pk, L, d, nullptr, out, B, H, W, Hs, top,
                             own.smem2, st);
}
