// Batch statistics of the four depthwise branches of a train-mode
// ReparamConv, without writing any branch out, on the flat (B, H, W*C) =
// NHWC activation layout.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/rc_train.py::rc_branch_stats
// (_rc_stats_kernel). It computes the same function, not that kernel's TPU
// layout (40 lane-rolled, border-masked weight vectors, 8-row halo edge
// blocks, an (8, W*C) accumulator carried across a sequential grid):
// for the branches y_0 = dw5x5(e; k5), y_1 = dw3x3(e; k3), y_2 = dw3x1(e; kv),
// y_3 = dw1x3(e; kh) (no bias, zero padding, conv semantics),
//   out[i, 0, ch] = sum_{b, r, c} y_i[b, r, c, ch]
//   out[i, 1, ch] = sum_{b, r, c} y_i[b, r, c, ch]^2
// in float32. The kernels are OIHW depthwise, float32: k5 (C, 1, 5, 5),
// k3 (C, 1, 3, 3), kv (C, 1, 3, 1), kh (C, 1, 1, 3).
//
// The row window (the mesh's 'spatial' axis, parallel/spatial.py): e is a
// slab of Hs rows and output row r is slab row top + r, for the H output
// rows; a tap whose row falls outside the slab reads zero, and the
// statistics cover the H output rows alone. The whole map is Hs = H,
// top = 0.
//
// What bounds it on an H100: arithmetic. Per element 40 multiply-adds (the
// four branches) and 8 accumulations, 96 float32 operations: 0.27 ms at 67
// TFLOP/s for the 16 blocks of a 256^2, B=16 training forward, against 0.11
// ms to read e once in bf16 at 3.35 TB/s; the window's shared-memory loads
// and the bf16 conversions add issue slots beside the FMAs.
//
// The design is B5's (rc_dw_gelu.cu) with no output. A block owns a 16 x 32
// tile of one image and a chunk of at most 32 channels (8 x ck threads;
// lmnet_rc::chunk_channels). It copies the tile's 20 x 36 halo of the chunk
// into shared memory in e's own dtype with cp.async in the widest unit that
// divides the channel run (16 bytes for bf16 C % 8 == 0 or float32 C % 4 ==
// 0, else 8, 4 or 2), zero-filled outside the image, in division-free loops;
// the tile re-reads 1.41x its pixels (the first design's 8 x 16 tile:
// 1.875x). Thread (row pair, channel), channel fastest, keeps its channel's
// 40 taps and 8 running sums in registers and slides a 6 x 5 float32 window
// along its two rows: 6 shared-memory loads for two outputs. All four
// branches of both rows come from that window (the 3x3, 3x1 and 1x3 taps
// are its centre), the eight branch-rows as independent chains (the 5x5 in
// two), so a warp has other chains' FMAs to issue while one is in flight.
// The tile's partials, one per (statistic, channel), are summed in a fixed
// order: each thread's two rows column by column, then the tile's row pairs
// in order. They lie statistic- and channel-major, [8 C][tiles], so
// lmnet_rc::reduce_partials_warp adds each output's tiles with coalesced
// reads, a warp an output, in a fixed order. No atomics, so two calls give
// bitwise-equal statistics.
//
// Tried before, and slower on the H100 (the 16 blocks of a training
// forward, bf16, 256^2, B=16, rc_kernel_times.py): the first design, 8 x 16
// tiles with a float32 halo loaded 2 bytes a thread, one output row a
// thread (5 shared-memory loads an output), partials read back with a
// stride of 8C by one 256-thread block per output (2.52-2.53 ms as CUDA
// graphs); this design with B5's five row chains for the 5x5 and three for
// the 3x3 (0.92-0.93 ms; 0.116 ms at a 256^2 block against 0.111), and with
// tile-major partials, a warp reducing 32 outputs (11 us of reduction at a
// 256^2 block against 3.6).
//
// The launch geometry (tile, chunk, copy unit, shared memory, the partials'
// size) comes from the caller's plan (ops/rc_train.py::stats_plan), which
// the entry point checks against its own.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_train.py).

#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;

constexpr int kRows = 16;           // output tile rows
constexpr int kPairs = kRows / 2;   // thread rows: a thread computes two output rows
constexpr int kCols = 32;           // output tile columns
constexpr int kHRows = kRows + 4;   // halo rows
constexpr int kHCols = kCols + 4;   // halo columns
constexpr int kTaps = 41;           // 25 + 9 + 3 + 3 taps a channel, padded to an odd stride
constexpr size_t kMaxSmem = 232448;

struct Geometry {
  int ck;        // channels per chunk (chunk_channels)
  int nchunk;    // channel chunks
  int ntx;       // tiles along W
  int ntiles;    // tiles per image
  int vb;        // copy unit in bytes
  size_t smem;   // dynamic shared memory bytes
  long long workspace;  // float32 partials: 8 C per tile
};

// the halo in e's dtype; then the taps and 8 partials per thread in float32
Geometry geometry(int B, int H, int W, int C, int esize) {
  Geometry g;
  g.ck = chunk_channels(C);
  g.nchunk = (C + g.ck - 1) / g.ck;
  g.ntx = (W + kCols - 1) / kCols;
  g.ntiles = ((H + kRows - 1) / kRows) * g.ntx;
  g.vb = vec_bytes((long long)C * esize);
  const size_t halo = (size_t)kHRows * kHCols * g.ck * esize;
  g.smem = (halo + 15) / 16 * 16 + (size_t)(kTaps + 8 * kPairs) * g.ck * sizeof(float);
  g.workspace = (long long)B * g.ntiles * 8 * C;
  return g;
}

bool shape_ok(int B, int H, int W, int C, int Hs, int top) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || top < 0 || top + H > Hs) {
    return false;
  }
  const long long tiles = (long long)((H + kRows - 1) / kRows) * ((W + kCols - 1) / kCols);
  const int ck = chunk_channels(C);
  return tiles * B <= 0x7fffffffLL && (C + ck - 1) / ck <= 65535 && 8LL * C <= 0x7fffffffLL;
}

// sum_{i < N, j < N} w[i * N + j] win[R0 + i][C0 + j], as two independent
// chains (rows 0 .. S - 1 and S .. N - 1; S = N: one chain) added at the
// end. A thread has 8 branch-rows of chains to interleave, so longer chains
// cost no issue slots and save the FADDs that joined B5's five row chains.
template <int N, int S, int R0, int C0>
__device__ __forceinline__ float taps(const float* w, const float (&win)[6][5]) {
  float a = w[0] * win[R0][C0];
#pragma unroll
  for (int t = 1; t < S * N; ++t) a = fmaf(w[t], win[R0 + t / N][C0 + t % N], a);
  if constexpr (S == N) {
    return a;
  } else {
    float b = w[S * N] * win[R0 + S][C0];
#pragma unroll
    for (int t = S * N + 1; t < N * N; ++t) b = fmaf(w[t], win[R0 + t / N][C0 + t % N], b);
    return a + b;
  }
}

// the four branch outputs of the output row whose 5x5 window is rows R0 ..
// R0 + 4 of win, added to the running sums and sums of squares
template <int R0>
__device__ __forceinline__ void accumulate(float (&acc)[8], const float (&w5)[25],
                                           const float (&w3)[9], const float (&wv)[3],
                                           const float (&wh)[3], const float (&win)[6][5]) {
  const float y0 = taps<5, 3, R0, 0>(w5, win);
  const float y1 = taps<3, 3, R0 + 1, 1>(w3, win);
  // 3x1 down the centre column, 1x3 along the centre row
  const float y2 = fmaf(wv[2], win[R0 + 3][2], fmaf(wv[1], win[R0 + 2][2], wv[0] * win[R0 + 1][2]));
  const float y3 = fmaf(wh[2], win[R0 + 2][3], fmaf(wh[1], win[R0 + 2][2], wh[0] * win[R0 + 2][1]));
  acc[0] += y0;
  acc[1] = fmaf(y0, y0, acc[1]);
  acc[2] += y1;
  acc[3] = fmaf(y1, y1, acc[3]);
  acc[4] += y2;
  acc[5] = fmaf(y2, y2, acc[5]);
  acc[6] += y3;
  acc[7] = fmaf(y3, y3, acc[7]);
}

template <typename T>
__global__ void __launch_bounds__(kPairs * kChunk, 2)
rc_stats_kernel(const T* __restrict__ e, const float* __restrict__ k5,
                const float* __restrict__ k3, const float* __restrict__ kv,
                const float* __restrict__ kh, float* __restrict__ part, int H, int W, int C,
                int Hs, int top, int ck, int ntx, int ntiles, int vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* es = reinterpret_cast<T*>(smem);  // halo, [hr][hc][k]
  const size_t halo = (size_t)kHRows * kHCols * ck * sizeof(T);
  float* wsh = reinterpret_cast<float*>(smem + (halo + 15) / 16 * 16);  // taps, [k][kTaps]
  float* red = wsh + kTaps * ck;  // 8 partials per thread, [statistic][thread]
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * ck;
  const int nk = min(ck, C - ch0);  // the last chunk may be partial
  const int tr0 = (tile / ntx) * kRows;
  const int tc0 = (tile % ntx) * kCols;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  // copy units: thread tid moves unit cv of pixels cp0, cp0 + cstep, ...
  // (ck * sizeof(T) / vb units a pixel divide the kPairs * ck threads, so no
  // thread divides by a run-time value in the loop); units past the chunk's
  // nk channels are skipped
  const int ps = ck * (int)sizeof(T);  // bytes per pixel in shared memory
  const int units = ps / vb;
  const int cv = tid % units;
  const int cp0 = tid / units;
  const int cstep = nthreads / units;
  const bool cin = cv * vb < nk * (int)sizeof(T);

  const T* eb = e + (int64_t)b * Hs * W * C + ch0;
  for (int p = cp0; cin && p < kHRows * kHCols; p += cstep) {
    const int hr = p / kHCols;
    const int hc = p - hr * kHCols;
    const int rr = top + tr0 - 2 + hr;  // a slab row
    const int cc = tc0 - 2 + hc;
    const bool in = rr >= 0 && rr < Hs && cc >= 0 && cc < W;
    const T* src = in ? eb + ((int64_t)rr * W + cc) * C : eb;
    copy_async(reinterpret_cast<unsigned char*>(es) + p * ps + cv * vb,
               reinterpret_cast<const unsigned char*>(src) + cv * vb, vb, in);
  }
  // the taps, channel-major: thread k reads its own kTaps-float row (an odd
  // stride: no bank conflicts)
  for (int i = tid; i < nk * 25; i += nthreads) {
    const int k = i / 25;
    wsh[k * kTaps + i - k * 25] = k5[(int64_t)ch0 * 25 + i];
  }
  for (int i = tid; i < nk * 9; i += nthreads) {
    const int k = i / 9;
    wsh[k * kTaps + 25 + i - k * 9] = k3[(int64_t)ch0 * 9 + i];
  }
  for (int i = tid; i < nk * 3; i += nthreads) {
    const int k = i / 3;
    wsh[k * kTaps + 34 + i - k * 3] = kv[(int64_t)ch0 * 3 + i];
    wsh[k * kTaps + 37 + i - k * 3] = kh[(int64_t)ch0 * 3 + i];
  }
  cp_async_wait_all();
  __syncthreads();

  const int k = tid % ck;
  const int r = 2 * (tid / ck);  // this thread's output rows r and r + 1
  const int ncol = min(kCols, W - tc0);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (k < nk && tr0 + r < H) {
    const bool second = tr0 + r + 1 < H;
    float w5[25], w3[9], wv[3], wh[3];
    const float* wl = wsh + k * kTaps;
#pragma unroll
    for (int i = 0; i < 25; ++i) w5[i] = wl[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) w3[i] = wl[25 + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      wv[i] = wl[34 + i];
      wh[i] = wl[37 + i];
    }
    const T* ep = es + r * kHCols * ck + k;  // halo row r is output row r - 2

    // win[i][j]: halo row r + i, halo column c + j for output column c; rows
    // 0-4 make output row r, rows 1-5 output row r + 1
    float win[6][5];
#pragma unroll
    for (int j = 1; j < 5; ++j) {
#pragma unroll
      for (int i = 0; i < 6; ++i) win[i][j] = to_f32(ep[(i * kHCols + j - 1) * ck]);
    }
    // unrolled, so that the window's shifts are register renames
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= ncol) break;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) win[i][j] = win[i][j + 1];
        win[i][4] = to_f32(ep[(i * kHCols + c + 4) * ck]);
      }
      accumulate<0>(acc, w5, w3, wv, wh, win);
      if (second) accumulate<1>(acc, w5, w3, wv, wh, win);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[j * nthreads + tid] = acc[j];
  __syncthreads();

  // the tile's partials, its row pairs in order: part[statistic][C][tile]
  if (r == 0 && k < nk) {
    const int64_t n = (int64_t)gridDim.y * ntiles;
    float* out = part + (int64_t)(ch0 + k) * n + (int64_t)b * ntiles + tile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float tot = 0.f;
      for (int q = 0; q < kPairs; ++q) tot += red[j * nthreads + q * ck + k];
      out[j * C * n] = tot;
    }
  }
}

template <typename T>
int launch(const void* e, const float* k5, const float* k3, const float* kv, const float* kh,
           float* out, float* part, int B, int H, int W, int C, int Hs, int top,
           const Geometry& g, cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(rc_stats_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(g.ntiles, B, g.nchunk);
  rc_stats_kernel<T><<<grid, kPairs * g.ck, g.smem, stream>>>(
      static_cast<const T*>(e), k5, k3, kv, kh, part, H, W, C, Hs, top, g.ck, g.ntx, g.ntiles,
      g.vb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * g.ntiles;
  reduce_partials_warp<<<(8 * C + kWarpsPerReduce - 1) / kWarpsPerReduce,
                         32 * kWarpsPerReduce, 0, stream>>>(part, out, 8 * C, n, 1, n, 1);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's own plan for H output rows of e (B, Hs, W*C) from slab row
// top, of dtype (0 = float32, 1 = bfloat16), into out[8]: tile rows, tile
// columns, channels per chunk, chunks, copy unit in bytes, shared-memory
// bytes, tiles per image, workspace. Returns 0, or -1 for a shape or window
// it does not take (out untouched).
extern "C" int lmnet_rc_stats_plan(int B, int H, int W, int C, int Hs, int top, int dtype,
                                   long long* out) {
  if (!shape_ok(B, H, W, C, Hs, top) || (dtype != 0 && dtype != 1)) return -1;
  const Geometry g = geometry(B, H, W, C, dtype == 0 ? 4 : 2);
  if (g.smem > kMaxSmem) return -1;
  const long long v[8] = {kRows, kCols, g.ck, g.nchunk, g.vb, (long long)g.smem, g.ntiles,
                          g.workspace};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (e, (B, Hs, W*C); output row r at slab
// row top + r); the four kernels are float32 OIHW depthwise; out is float32
// (4, 2, C): per branch (5x5, 3x3, 3x1, 1x3) the sum and the sum of squares
// over B x the H output rows x W; part is float32 scratch of
// `workspace` values. All contiguous. The plan (tile rows and columns,
// channels per chunk, copy unit in bytes, shared-memory bytes, workspace)
// must equal the kernel's own for this shape. Returns the first CUDA error
// of the two launches: 0 on success; cudaErrorInvalidValue for a shape or
// plan it does not take.
extern "C" int lmnet_rc_stats(const void* e, const void* k5, const void* k3, const void* kv,
                              const void* kh, void* out, void* part, int B, int H, int W, int C,
                              int Hs, int top, int dtype, int tile_rows, int tile_cols,
                              int chunk, int vb, long long smem, long long workspace,
                              void* stream) {
  if (!shape_ok(B, H, W, C, Hs, top) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g = geometry(B, H, W, C, dtype == 0 ? 4 : 2);
  if (tile_rows != kRows || tile_cols != kCols || chunk != g.ck || vb != g.vb ||
      smem != (long long)g.smem || workspace != g.workspace || g.smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(k5);
  const float* b = static_cast<const float*>(k3);
  const float* v = static_cast<const float*>(kv);
  const float* h = static_cast<const float*>(kh);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  if (dtype == 0) return launch<float>(e, a, b, v, h, o, p, B, H, W, C, Hs, top, g, s);
  return launch<__nv_bfloat16>(e, a, b, v, h, o, p, B, H, W, C, Hs, top, g, s);
}
