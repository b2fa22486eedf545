// Neighborhood attention forward, kernel size 3, NATTEN semantics, on NHWC
// (B, H, W, C) activations (B3): a persistent kernel whose blocks walk tiles
// of queries with the tiles' q and k/v halo loaded by the Tensor Memory
// Accelerator (TMA) into a two-stage ring in shared memory.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_kernel.py::
// neighborhood_attention_pallas (_nat_forward, _nat_kernel). That kernel runs
// in (C, W) orientation on row stripes, with the k/v halo of (rows + 2) rows
// assembled in VMEM scratch. It computes the same function as nat_fwd.cu
// (B1) on the same memory layout, and is its own kernel:
// for every (b, row, col, head): the window starts at clamp(row-1, 0, H-3),
// clamp(col-1, 0, W-3); logit[i] = scale * <q, k_i> + rpb[head, kr-row+2,
// kc-col+2]; out = sum_i softmax(logit)[i] * v_i. rpb is float32. The
// softmax runs in base 2 (q scaled by scale * log2 e, rpb by log2 e): the
// same function within float32 rounding.
//
// What bounds it on an H100: by its bytes, memory (q, k, v in and out once,
// 4 x 2 B an element in bf16: 188.7 MB, 0.056 ms at 3.35 TB/s over the four
// NAT stages of a 256^2, B=16 forward; ~36 flops an element); in practice
// instruction issue and the 9 exponentials a (pixel, head).
//
// The design.
//  * Variant 'vec' (head_dim 1, 2, 4 or 8 and a shape a tensor map takes):
//    a fixed number of persistent blocks (two an SM where two fit, the
//    tiles' count where fewer) each walk the tiles blockIdx.x,
//    blockIdx.x + gridDim.x, ... of (image, head chunk, row tile, column
//    tile). A block keeps two stages of (q tile, k halo, v halo) in shared
//    memory in the input dtype, each stage completing on its own mbarrier.
//    One thread issues the three TMA copies of tile i + 1 into the other
//    stage before the block computes tile i, so the copy of the next tile
//    overlaps the compute of this one; a block barrier after each tile
//    orders the threads' last reads of a stage before the next copy into it.
//    The halo holds the clamped windows: (rows + 2) x (cols + 2) pixels from
//    (clamp(r0-1), clamp(c0-1)); its rows past the map's end come from the
//    next image or are zero-filled, its columns past the edge are
//    zero-filled, and no window reads them.
//  * The maps: 3-D over (C, W, B*H), boxes (channels of the head chunk,
//    columns, rows), where a pixel's bytes are a multiple of 16 (bf16 C =
//    24, 48, 96; every float32 stage). At C = 12 in bf16 a pixel is 24
//    bytes, which a 3-D map cannot stride: there a 2-D map over (W*C, B*H)
//    takes whole rows of the tile: 16 columns of queries, a halo row of 20
//    pixels (240 elements, at most 256) that starts on an even pixel, since
//    a box row must start on 16 bytes.
//  * The compute is B1's, the same code (nat_common.cuh::window_vec):
//    thread (pixel, channel group) owns up to 4 heads in one 8- or 16-byte
//    vector of q (read from the staged tile) and of out (stored straight to
//    device memory), reads its 9 window pixels from the staged halo as
//    vectors, keeps the 9 logits of its heads in registers, and
//    exponentiates in base 2 with rpb * log2 e staged once a block.
//  * Variant 'generic' (any other head_dim, or a shape no legal map takes):
//    a tiled grid (column tile, row tile, image x head chunk), the k/v halo
//    copied in the input dtype by cp.async in the widest unit that divides
//    a pixel's channel run, one thread per (pixel, head) with a run-time
//    head_dim, q read from device memory (nat_common.cuh::window_generic).
// Every H, W >= 3 and every head_dim are taken; a halo that fits no block's
// shared memory is refused. The launch plan (variant, map rank, tile, heads
// a block, threads, blocks, shared memory, and the maps' dims, strides and
// boxes) comes from the caller (ops/nat_kernel.py::b3_plan); the entry point
// computes its own (b3_plan below) and refuses a plan that differs. The
// launch encodes the maps, and the kernel places the stages, by that plan.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_kernel.py).

#include "nat_common.cuh"
#include "tma.cuh"

namespace {

using namespace lmnet_nat;
using namespace lmnet_tma;

constexpr int kMaxBox = 256;  // elements a box dimension

inline long long r128(long long x) { return (x + 127) / 128 * 128; }

// The pixels a rank-2 box row must start on a multiple of, so that its first
// byte is 16-byte aligned (on the H100 a copy from an odd pixel of the
// 24-byte C = 12 rows never completed): 16 / gcd(pixel bytes, 16); 1 for
// rank 3, whose inner coordinate is a head chunk's first channel.
inline int pixel_period(int rank, long long pixel_bytes) {
  if (rank != 2) return 1;
  const long long low = pixel_bytes & -pixel_bytes;
  return 16 / (int)(low < 16 ? low : 16);
}

// A halo row in pixels: the cols + 2 the tile's windows read, widened for
// rank 2 to start at a multiple of the period below the window start and to
// span whole periods.
inline int halo_width(int rank, int cols, long long pixel_bytes) {
  const int a = pixel_period(rank, pixel_bytes);
  return (cols + 2 * a) / a * a;  // cols + 1 + a, rounded up to a multiple of a
}

// Byte offsets of the vec variant's shared memory from its 128-byte
// aligned base: the two barriers, rpb * log2 e [entry][head] for every head,
// then two stages of (q tile, k halo, v halo; hw pixels a halo row), each
// region 128-byte aligned; total counts 128 bytes more, to align the base.
struct Layout3 {
  long long rp, q0, k0, v0, stage, total;
  long long qbox, hbox;  // bytes of a q box and of a halo box
};

inline Layout3 layout3(int rows, int cols, int hw, int nh, int hd, int es, int heads) {
  Layout3 L;
  const long long ck = (long long)nh * hd * es;  // bytes of a pixel's chunk
  L.qbox = (long long)rows * cols * ck;
  L.hbox = (long long)(rows + 2) * hw * ck;
  L.rp = 128;
  L.q0 = L.rp + r128(25LL * heads * 4);
  L.k0 = L.q0 + r128(L.qbox);
  L.v0 = L.k0 + r128(L.hbox);
  L.stage = r128(L.qbox) + 2 * r128(L.hbox);
  L.total = 128 + L.q0 + 2 * L.stage;
  return L;
}

// the generic variant: rpb [entry][head of the chunk], the k and v halos
__host__ __device__ inline long long generic_smem(int rows, int cols, int nh, int hd, int es,
                                                  long long* halo) {
  const long long h = r16((long long)(rows + 2) * (cols + 2) * nh * hd * es);
  if (halo) *halo = h;
  return r16(25LL * nh * 4) + 2 * h;
}

struct B3Plan {
  int vec;      // 1: TMA-fed persistent variant; 0: generic
  int rank;     // the tensor maps' rank (vec): 3 (C, W, B*H) or 2 (W*C, B*H)
  int per;      // heads a thread
  int rows, cols;  // a tile of query pixels
  int nh;       // heads a tile (the last head chunk may hold fewer)
  int ppb;      // pixels a pass of the block's threads covers
  int threads;
  int gx, gy, nchunk;  // column tiles, row tiles, head chunks
  int tiles;    // gx * gy * B * nchunk
  int blocks;   // vec: persistent blocks; generic: the grid's, one a tile
  int vb;       // generic: halo copy unit in bytes
  long long smem;
  // vec: what the launch encodes and the kernel reads, the map's first
  // `rank` entries: dims (elements, innermost first), byte strides, the q
  // and halo boxes (elements); a halo row's pixels and the pixels its
  // first column is a multiple of; the shared memory's layout
  int hw, period;
  uint64_t dims[3], strides[2];
  uint32_t qbox[3], hbox[3];
  Layout3 L;
};

// The plan for (B, H, W, heads x hd) in elements of es bytes; false for a
// shape the kernel does not take. The same function as
// ops/nat_kernel.py::b3_plan.
inline bool b3_plan(int B, int H, int W, int heads, int hd, int es, B3Plan* p) {
  if (B <= 0 || H < 3 || W < 3 || heads <= 0 || hd <= 0 || (es != 2 && es != 4)) return false;
  *p = B3Plan{};
  const long long C = (long long)heads * hd;
  const bool pow2 = hd == 1 || hd == 2 || hd == 4 || hd == 8;
  const int g = pow2 ? group_channels(hd, C, es) : 0;
  int rank = 0, per = 1, nh = heads, rows = H < 32 ? H : 32, cols = W < 32 ? W : 32;
  // rank 3: the largest head chunk (a multiple of per) whose box row is at
  // most 256 elements of a multiple of 16 bytes
  auto chunk_ok = [&](int n) { return n * hd <= kMaxBox && (long long)n * hd * es % 16 == 0; };
  auto next_chunk = [&](int n) {  // the next smaller valid chunk, or 0
    for (int m = (n - 1) / per * per; m >= per; m -= per)
      if (chunk_ok(m)) return m;
    return 0;
  };
  if (g > 0) {
    per = g / hd;
    if (C * es % 16 == 0) {
      nh = chunk_ok(heads) ? heads : next_chunk(heads);
      rank = nh > 0 ? 3 : 0;
    } else if ((long long)W * C * es % 16 == 0) {
      // rank 2: whole pixels of all heads, box rows of halo_width * C and
      // cols * C elements, each at most 256 and a multiple of 16 bytes; the
      // widest power of two of columns that fits, else the widest width
      auto fits = [&](int c) {
        return halo_width(2, c, C * es) * C <= kMaxBox && c * C * es % 16 == 0;
      };
      int widest = 0, pow2c = 0;
      for (int c = cols; c >= 1; --c) {
        if (!fits(c)) continue;
        if (widest == 0) widest = c;
        if ((c & (c - 1)) == 0 && pow2c == 0) pow2c = c;
      }
      if (widest > 0) {
        rank = 2;
        cols = pow2c > 0 ? pow2c : widest;
      }
      nh = heads;
    }
  }
  if (rank > 0) {
    auto nchunk = [&]() { return cdiv(heads, nh); };
    auto tiles = [&]() { return (long long)cdiv(W, cols) * cdiv(H, rows) * B * nchunk(); };
    auto smem = [&]() {
      return layout3(rows, cols, halo_width(rank, cols, C * es), nh, hd, es, heads).total;
    };
    // the larger side halved, down to 8 (rank 2: the rows, down to 2),
    // while there are fewer than two tiles an SM
    while (tiles() < 2 * kSms) {
      if (rank == 3 && cols > rows && cols > 8) {
        cols /= 2;
      } else if (rows > (rank == 3 ? 8 : 2)) {
        rows /= 2;
      } else if (rank == 3 && cols > 8) {
        cols /= 2;
      } else {
        break;
      }
    }
    while (smem() > kSmemTarget) {
      if (rank == 3 && cols >= rows && cols > 8) {
        cols /= 2;
      } else if (rows > 8) {
        rows /= 2;
      } else if (rank == 3 && cols > 8) {
        cols /= 2;
      } else if (rank == 3 && next_chunk(nh) > 0) {
        nh = next_chunk(nh);
      } else if (rows > 1) {
        rows /= 2;
      } else if (rank == 3 && cols > 1) {
        cols /= 2;
      } else {
        break;
      }
    }
    if (smem() <= kMaxSmem && tiles() <= 0x7fffffffLL) {
      const int hw = halo_width(rank, cols, C * es);
      const uint32_t ck = (uint32_t)(nh * hd);
      p->hw = hw;
      p->period = pixel_period(rank, C * es);
      p->L = layout3(rows, cols, hw, nh, hd, es, heads);
      if (rank == 3) {  // (C, W, B*H); boxes (the chunk's channels, columns, rows)
        const uint64_t dims[3] = {(uint64_t)C, (uint64_t)W, (uint64_t)B * H};
        const uint64_t strides[2] = {(uint64_t)C * es, (uint64_t)W * C * es};
        const uint32_t qbox[3] = {ck, (uint32_t)cols, (uint32_t)rows};
        const uint32_t hbox[3] = {ck, (uint32_t)hw, (uint32_t)rows + 2};
        for (int i = 0; i < 3; ++i) p->dims[i] = dims[i], p->qbox[i] = qbox[i], p->hbox[i] = hbox[i];
        p->strides[0] = strides[0];
        p->strides[1] = strides[1];
      } else {  // (W*C, B*H); boxes (columns x C, rows)
        p->dims[0] = (uint64_t)W * C;
        p->dims[1] = (uint64_t)B * H;
        p->strides[0] = (uint64_t)W * C * es;
        p->qbox[0] = (uint32_t)(cols * C);
        p->qbox[1] = (uint32_t)rows;
        p->hbox[0] = (uint32_t)(hw * C);
        p->hbox[1] = (uint32_t)rows + 2;
      }
      p->vec = 1;
      p->rank = rank;
      p->per = per;
      p->rows = rows;
      p->cols = cols;
      p->nh = nh;
      p->ppb = pixels_per_pass(nh / per);
      p->threads = nh / per * p->ppb;
      p->gx = cdiv(W, cols);
      p->gy = cdiv(H, rows);
      p->nchunk = nchunk();
      p->tiles = (int)tiles();
      const long long fit = (long long)kSms * (smem() <= kSmemTarget ? 2 : 1);
      p->blocks = (int)(p->tiles < fit ? p->tiles : fit);
      p->smem = smem();
      return true;
    }
  }
  // generic: all heads a block up to 32, the tile halved while the grid has
  // fewer than two blocks an SM, then the heads, columns and rows halved
  // while the halos pass half an SM's shared memory
  nh = heads < kMaxBlockHeads ? heads : kMaxBlockHeads;
  rows = H < 32 ? H : 32;
  cols = W < 32 ? W : 32;
  auto blocks = [&]() { return (long long)cdiv(W, cols) * cdiv(H, rows) * B * cdiv(heads, nh); };
  while (rows > 2 && blocks() < 2 * kSms) rows /= 2;
  while (generic_smem(rows, cols, nh, hd, es, nullptr) > kSmemTarget) {
    if (nh > 1) {
      nh /= 2;
    } else if (cols > 8) {
      cols /= 2;
    } else if (rows > 1) {
      rows /= 2;
    } else if (cols > 1) {
      cols /= 2;
    } else {
      break;
    }
  }
  const long long sm = generic_smem(rows, cols, nh, hd, es, nullptr);
  const int nchunk = cdiv(heads, nh);
  const int gy = cdiv(H, rows);
  if (sm > kMaxSmem || gy > 65535 || (long long)B * nchunk > 65535) return false;
  p->vec = 0;
  p->rank = 0;
  p->per = 1;
  p->rows = rows;
  p->cols = cols;
  p->nh = nh;
  p->ppb = pixels_per_pass(nh);
  p->threads = nh * p->ppb;
  p->gx = cdiv(W, cols);
  p->gy = gy;
  p->nchunk = nchunk;
  p->tiles = (int)blocks();
  p->blocks = p->tiles;
  const int last = heads - (nchunk - 1) * nh;  // heads of the last chunk
  const int a = vec_bytes((long long)nh * hd * es), b = vec_bytes(C * es);
  const int c = vec_bytes((long long)last * hd * es);
  p->vb = a < b ? (a < c ? a : c) : (b < c ? b : c);
  p->smem = sm;
  return true;
}

// The vec variant: HD head_dim, NH heads a thread, RANK the maps' rank.
template <typename T, int HD, int NH, int RANK>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
b3_tma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv, const float* __restrict__ rpb,
              T* __restrict__ out, int H, int W, int heads, int nh, int rows, int cols, int ppb,
              int gx, int gy, int nchunk, int ntiles, int hw, int period, const Layout3 L,
              float scale2) {
  constexpr int G = HD * NH;  // channels a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align128(smem_raw);
  const int C = heads * HD;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  float* rp = reinterpret_cast<float*>(base + L.rp);  // [entry][head], times log2 e
  const int ck = nh * HD;  // a staged pixel's elements
  const int tpp = nh / NH;
  const int cg = threadIdx.x % tpp;  // the thread's heads: h0 + cg*NH ...
  const unsigned tx_bytes = (unsigned)(L.qbox + 2 * L.hbox);
  const CUtensorMap* maps[3] = {&mq, &mk, &mv};

  // tile t: (image, head chunk, row tile, column tile), column tiles fastest
  auto decode = [&](int t, int& b, int& chunk, int& ty, int& tx) {
    tx = t % gx;
    t /= gx;
    ty = t % gy;
    t /= gy;
    chunk = t % nchunk;
    b = t / nchunk;
  };
  auto issue = [&](int t, int s) {  // one thread: tile t into stage s
    int b, chunk, ty, txi;
    decode(t, b, chunk, ty, txi);
    const int tr0 = ty * rows, tc0 = txi * cols;
    const int hr0 = window_start(tr0, H);
    const int hc0 = window_start(tc0, W) / period * period;
    unsigned char* st = base + s * L.stage;
    mbar_expect_tx(&bar[s], tx_bytes);
    if constexpr (RANK == 3) {
      const int ch = chunk * ck;
      tma_load_3d(st + L.q0, maps[0], &bar[s], ch, tc0, b * H + tr0);
      tma_load_3d(st + L.k0, maps[1], &bar[s], ch, hc0, b * H + hr0);
      tma_load_3d(st + L.v0, maps[2], &bar[s], ch, hc0, b * H + hr0);
    } else {
      tma_load_2d(st + L.q0, maps[0], &bar[s], tc0 * C, b * H + tr0);
      tma_load_2d(st + L.k0, maps[1], &bar[s], hc0 * C, b * H + hr0);
      tma_load_2d(st + L.v0, maps[2], &bar[s], hc0 * C, b * H + hr0);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
    if ((int)blockIdx.x < ntiles) issue(blockIdx.x, 0);
  }
  for (int i = threadIdx.x; i < 25 * heads; i += blockDim.x) {
    const int e = i / heads;
    const int h = i - e * heads;
    rp[e * heads + h] = rpb[h * 25 + e] * kLog2e;
  }
  __syncthreads();

  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    if (threadIdx.x == 0 && t + (int)gridDim.x < ntiles) issue(t + gridDim.x, s ^ 1);
    int b, chunk, ty, txi;
    decode(t, b, chunk, ty, txi);
    const int h0 = chunk * nh;
    const int nhb = min(nh, heads - h0);
    const int tr0 = ty * rows, tc0 = txi * cols;
    const int hr0 = window_start(tr0, H);
    const int hc0 = window_start(tc0, W) / period * period;  // the halo's first column
    const int nr = min(rows, H - tr0);
    const int nc = min(cols, W - tc0);
    const unsigned char* st = base + s * L.stage;
    const T* qs = reinterpret_cast<const T*>(st + L.q0);
    const T* ks = reinterpret_cast<const T*>(st + L.k0);
    const T* vs = reinterpret_cast<const T*>(st + L.v0);
    const int64_t img = (int64_t)b * H * W;
    mbar_wait(&bar[s], (it >> 1) & 1);
    if (cg * NH < nhb) {
      for (Walk w(threadIdx.x / tpp, ppb, nc); w.r < nr; w.next()) {
        const int row = tr0 + w.r;
        const int col = tc0 + w.c;
        const int r0 = window_start(row, H);
        const int c0 = window_start(col, W);
        const int be = (2 - (row - r0)) * 5 + (2 - (col - c0));  // rpb entry of window slot 0
        const int wo = ((r0 - hr0) * hw + (c0 - hc0)) * ck + cg * G;  // window slot 0 in the halo
        window_vec<T, HD, NH>(qs + (w.r * cols + w.c) * ck + cg * G, ks + wo, vs + wo, hw, ck,
                              rp + be * heads + h0 + cg * NH, heads, scale2,
                              out + (img + (int64_t)row * W + col) * C + h0 * HD + cg * G);
      }
    }
    __syncthreads();  // every read of stage s is done before a copy refills it
  }
}

// The generic variant: one thread per (pixel, head), head_dim at run time.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
b3_generic_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ rpb, T* __restrict__ out, int H, int W, int heads,
                  int hd, int nh, int rows, int cols, int ppb, int vb, float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunk = cdiv(heads, nh);
  const int b = blockIdx.z / nchunk;
  const int h0 = (blockIdx.z - b * nchunk) * nh;
  const int nhb = min(nh, heads - h0);
  const int C = heads * hd;
  const int ck = nh * hd;
  const int tr0 = blockIdx.y * rows;
  const int tc0 = blockIdx.x * cols;
  const int hr0 = window_start(tr0, H);
  const int hc0 = window_start(tc0, W);
  const int hw = cols + 2;
  long long hsz;
  const long long total = generic_smem(rows, cols, nh, hd, sizeof(T), &hsz);
  const long long rpsz = total - 2 * hsz;
  float* rp = reinterpret_cast<float*>(smem);  // [entry][head of the chunk], times log2 e
  const T* ks = reinterpret_cast<const T*>(smem + rpsz);
  const T* vs = reinterpret_cast<const T*>(smem + rpsz + hsz);
  const int64_t img = (int64_t)b * H * W;
  {
    const int nr = min(rows + 2, H - hr0);
    const int nc = min(cols + 2, W - hc0);
    const int run = nhb * hd * (int)sizeof(T);
    const long long off = (img * C + (int64_t)h0 * hd) * (int64_t)sizeof(T);
    copy_halo(smem + rpsz, reinterpret_cast<const unsigned char*>(k) + off, hr0, hc0, nr, nc, hw,
              W, (long long)C * sizeof(T), ck * (int)sizeof(T), run, vb);
    copy_halo(smem + rpsz + hsz, reinterpret_cast<const unsigned char*>(v) + off, hr0, hc0, nr,
              nc, hw, W, (long long)C * sizeof(T), ck * (int)sizeof(T), run, vb);
  }
  for (int i = threadIdx.x; i < 25 * nhb; i += blockDim.x) {
    const int e = i / nhb;
    const int h = i - e * nhb;
    rp[e * nh + h] = rpb[(h0 + h) * 25 + e] * kLog2e;
  }
  cp_async_wait_all();
  __syncthreads();
  const int cg = threadIdx.x % nh;
  if (cg >= nhb) return;  // a head past the last head

  const int nr = min(rows, H - tr0);
  const int nc = min(cols, W - tc0);
  for (Walk w(threadIdx.x / nh, ppb, nc); w.r < nr; w.next()) {
    const int row = tr0 + w.r;
    const int col = tc0 + w.c;
    const int r0 = window_start(row, H);
    const int c0 = window_start(col, W);
    const int be = (2 - (row - r0)) * 5 + (2 - (col - c0));
    const int64_t qo = (img + (int64_t)row * W + col) * C + (int64_t)(h0 + cg) * hd;
    const int wo = ((r0 - hr0) * hw + (c0 - hc0)) * ck + cg * hd;  // window slot 0 in the halo
    window_generic<T, int>(q + qo, ks + wo, vs + wo, hw * ck, ck, hd, rp + be * nh + cg, nh,
                           scale2, out + qo);
  }
}

template <typename T, int HD, int NH, int RANK>
int launch_tma(const void* q, const void* k, const void* v, const float* rpb, void* out, int H,
               int W, int heads, const B3Plan& p, float scale2, cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(b3_tma_kernel<T, HD, NH, RANK>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap mq, mk, mv;
  const int es = (int)sizeof(T);
  int err = encode(&mq, es, RANK, q, p.dims, p.strides, p.qbox);
  if (err == 0) err = encode(&mk, es, RANK, k, p.dims, p.strides, p.hbox);
  if (err == 0) err = encode(&mv, es, RANK, v, p.dims, p.strides, p.hbox);
  if (err != 0) return err;
  b3_tma_kernel<T, HD, NH, RANK><<<p.blocks, p.threads, p.smem, stream>>>(
      mq, mk, mv, rpb, static_cast<T*>(out), H, W, heads, p.nh, p.rows, p.cols, p.ppb, p.gx, p.gy,
      p.nchunk, p.tiles, p.hw, p.period, p.L, scale2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const void* q, const void* k, const void* v, const float* rpb, void* out,
                   int B, int H, int W, int heads, int hd, const B3Plan& p, float scale2,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        b3_generic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  b3_generic_kernel<T><<<dim3(p.gx, p.gy, B * p.nchunk), p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rpb,
      static_cast<T*>(out), H, W, heads, hd, p.nh, p.rows, p.cols, p.ppb, p.vb, scale2);
  return (int)cudaGetLastError();
}

// The (head_dim, heads a thread, maps' rank) triples the vec variant is
// compiled for, by dtype: every triple b3_plan gives. B1's thread groups
// (bf16 8 or 4 channels a thread, float32 4 or 2, or one float32 head of 8);
// rank 2 where the group is 8 bytes and a pixel is not a multiple of 16
// (bf16 C = 4 mod 8, float32 C = 2 mod 4). tests/test_torch_tile_plans.py
// reads these two lists.
#define LMNET_B3_BF16(X) \
  X(8, 1, 3) X(2, 4, 3) X(4, 2, 3) X(1, 4, 3) X(2, 2, 3) X(4, 1, 3) X(1, 4, 2) X(2, 2, 2) X(4, 1, 2)
#define LMNET_B3_F32(X) \
  X(8, 1, 3) X(1, 4, 3) X(2, 2, 3) X(4, 1, 3) X(1, 2, 3) X(2, 1, 3) X(1, 2, 2) X(2, 1, 2)

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rpb, void* out, int B, int H,
           int W, int heads, int hd, const B3Plan& p, float scale2, cudaStream_t s) {
  if (!p.vec) return launch_generic<T>(q, k, v, rpb, out, B, H, W, heads, hd, p, scale2, s);
#define LMNET_B3(HDC, NHC, R)                                                                  \
  if (hd == HDC && p.per == NHC && p.rank == R)                                               \
    return launch_tma<T, HDC, NHC, R>(q, k, v, rpb, out, H, W, heads, p, scale2, s);
  if constexpr (sizeof(T) == 2) {
    LMNET_B3_BF16(LMNET_B3)
  } else {
    LMNET_B3_F32(LMNET_B3)
  }
#undef LMNET_B3
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// 1 if the kernel takes (B, H, W, heads x hd) activations of dtype (0 =
// float32, 1 = bfloat16): a plan exists (its halo fits a block's shared
// memory), else 0.
extern "C" int lmnet_nat_tile_takes(int B, int H, int W, int heads, int hd, int dtype) {
  B3Plan p;
  return (dtype == 0 || dtype == 1) && b3_plan(B, H, W, heads, hd, dtype == 0 ? 4 : 2, &p);
}

// The kernel's own plan for this shape, 37 numbers: vec, rank, per, rows,
// cols, nh, ppb, threads, gx, gy, nchunk, tiles, blocks, vb, smem; the vec
// variant's geometry, as the launch encodes it and the kernel reads it
// (0 for generic): hw, period, dims[3], strides[2], qbox[3], hbox[3], and
// the layout's rp, q0, k0, v0, stage, total, qbox, hbox bytes; and last 1
// (a plan was made) or 0 (refused; the rest is then 0). For the tests that
// hold ops/nat_kernel.py::b3_plan to it.
extern "C" void lmnet_nat_tile_plan(int B, int H, int W, int heads, int hd, int dtype,
                                    long long* out) {
  B3Plan p = {};
  const bool ok = b3_plan(B, H, W, heads, hd, dtype == 0 ? 4 : 2, &p);
  const Layout3& L = p.L;
  const long long v[37] = {
      p.vec, p.rank, p.per, p.rows, p.cols, p.nh, p.ppb, p.threads, p.gx, p.gy, p.nchunk,
      p.tiles, p.blocks, p.vb, p.smem, p.hw, p.period, (long long)p.dims[0],
      (long long)p.dims[1], (long long)p.dims[2], (long long)p.strides[0],
      (long long)p.strides[1], p.qbox[0], p.qbox[1], p.qbox[2], p.hbox[0], p.hbox[1], p.hbox[2],
      L.rp, L.q0, L.k0, L.v0, L.stage, L.total, L.qbox, L.hbox, ok};
  for (int i = 0; i < 37; ++i) out[i] = ok || i == 36 ? v[i] : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; rpb is float32
// (heads, 5, 5)). NHWC, all contiguous, q, k, v and out 16-byte aligned. The
// plan (variant 1 = vec / 0 = generic, maps' rank, tile rows and columns,
// heads a tile, threads, blocks, shared-memory bytes) must equal the
// kernel's own for this shape. Returns 0 on success; a CUDA error
// (cudaErrorInvalidValue for a shape or plan it does not take, else the
// launch's); or a negated CUresult when a tensor map cannot be encoded.
extern "C" int lmnet_nat_tile(const void* q, const void* k, const void* v, const void* rpb,
                              void* out, int B, int H, int W, int heads, int hd, float scale,
                              int dtype, int vec, int rank, int rows, int cols, int nh,
                              int threads, int blocks, long long smem, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  B3Plan p;
  if (!b3_plan(B, H, W, heads, hd, dtype == 0 ? 4 : 2, &p)) return (int)cudaErrorInvalidValue;
  if (vec != p.vec || rank != p.rank || rows != p.rows || cols != p.cols || nh != p.nh ||
      threads != p.threads || blocks != p.blocks || smem != p.smem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  const float scale2 = scale * kLog2e;
  if (dtype == 0) return launch<float>(q, k, v, r, out, B, H, W, heads, hd, p, scale2, s);
  return launch<__nv_bfloat16>(q, k, v, r, out, B, H, W, heads, hd, p, scale2, s);
}
