// Depthwise 5x5 conv + bias + tanh GELU, with the per-image channel sums of
// the result, on the flat (B, H, W*C) = NHWC activation layout.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/rc_flat.py::dw_gelu_flat
// (_dw_kernel). It computes the same function, not that kernel's TPU layout
// (25 lane-rolled weight vectors tiled over W with the border masks folded
// in, 16-row halo stripes, sums carried across a sequential grid):
//   t[b, r, c, ch] = gelu_tanh(bias[ch] + sum_{i,j} w[ch, i, j] e[b, r+i-2, c+j-2, ch])
// with zero padding (conv semantics), and
//   sums[b, ch] = sum_{r, c} t[b, r, c, ch]
// taken on the float32 t before it is stored in e's dtype. The weights are
// the OIHW depthwise kernel (C, 1, 5, 5) and the bias (C,), both float32.
//
// The row window (the mesh's 'spatial' axis, parallel/spatial.py): e is a
// slab of Hs rows and output row r is slab row top + r, for the H output
// rows; a tap whose row falls outside the slab reads zero, and the sums
// cover the H output rows alone. The whole map is Hs = H, top = 0.
//
// What bounds it on an H100: memory and instruction issue, close together.
// Per element it must read e once and write t once (2 x 2 B in bf16: 0.225
// ms for the 16 blocks of a 256^2, B=16 forward at 3.35 TB/s); its 25
// multiply-adds, 5 shared-memory loads and the GELU are ~40 instructions a
// element, about 0.3 ms of issue for the same work at full occupancy.
//
// The design. A block owns a 16 x 32 tile of one image and a chunk of at
// most 32 channels (8 x ck threads; C = 48 takes two chunks of 24). It
// copies the tile's 20 x 36 halo of the chunk into shared memory in e's own
// dtype (bf16 halves the footprint of a float32 halo and so fits more
// blocks on an SM), with cp.async in the widest unit that divides the
// channel run: 16 bytes (8 bf16 or 4 float32 channels) where C*sizeof(e)
// is a multiple of 16, else 8, 4 or 2 (C = 20: 8 bytes; C = 300 bf16: 8
// bytes), zero-filled outside the image; the tile re-reads 1.41x its
// pixels (PR 3's 8 x 16 tile 1.875x). Thread (row pair, channel), channel
// fastest, slides a 6 x 5 window of float32 registers along its two rows:
// 6 shared-memory loads for two outputs, 25 FMAs each in five independent
// row chains, its 25 taps in registers. t goes to a shared-memory tile and
// from there to device memory in the same vector unit (16-byte stores for
// bf16 C % 8 == 0), not as 2-byte stores from each thread. The GELU is
// x / (1 + 2^v) (rc_common.cuh), one MUFU ex2 in place of tanhf.
// The channel sums go through per-tile partials (each thread's two rows,
// column by column, then the tile's row pairs in order) and
// lmnet_rc::reduce_partials_warp, in a fixed order: no atomics, so two calls
// give bitwise-equal sums.
//
// Tried before, and slower on the H100 (the 16 served blocks of a 256^2,
// B=16 forward, bf16): one thread fetching its own window from device
// memory (~160 GB/s, waiting on each load in turn); an 8 x 16 tile with a
// float32 halo loaded 2 bytes a thread (PR 3's design: 2.15 ms, 351 GB/s),
// and that loop unrolled so all a thread's loads are in flight at once (its
// registers cost more occupancy than the overlap gained); an 8 x 32 tile
// with one output row a thread and the 16-byte halo (this PR's first
// design: 1.09-1.25 ms, 100 us at a 256^2 block, 0.95 TB/s).
//
// The launch geometry (tile, chunk, copy unit, shared memory, the partials'
// size) comes from the caller's plan (ops/rc_flat.py::dw_plan), which the
// entry point checks against its own.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_flat.py).

#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;

constexpr int kRows = 16;           // output tile rows
constexpr int kPairs = kRows / 2;   // thread rows: a thread computes two output rows
constexpr int kCols = 32;           // output tile columns
constexpr int kHRows = kRows + 4;   // halo rows
constexpr int kHCols = kCols + 4;   // halo columns
constexpr size_t kMaxSmem = 232448;

struct Geometry {
  int ck;        // channels per chunk (chunk_channels)
  int nchunk;    // channel chunks
  int ntx;       // tiles along W
  int ntiles;    // tiles per image
  int vb;        // copy unit in bytes
  size_t smem;   // dynamic shared memory bytes
  long long workspace;  // float32 partials
};

// halo and t tile in e's dtype, then the taps and one partial per thread
// (kPairs x ck) in float32
Geometry geometry(int B, int H, int W, int C, int esize) {
  Geometry g;
  g.ck = chunk_channels(C);
  g.nchunk = (C + g.ck - 1) / g.ck;
  g.ntx = (W + kCols - 1) / kCols;
  g.ntiles = ((H + kRows - 1) / kRows) * g.ntx;
  g.vb = vec_bytes((long long)C * esize);
  const size_t tiles = (size_t)(kHRows * kHCols + kRows * kCols) * g.ck * esize;
  g.smem = (tiles + 15) / 16 * 16 + (size_t)(25 + kPairs) * g.ck * sizeof(float);
  g.workspace = (long long)B * g.ntiles * C;
  return g;
}

bool shape_ok(int B, int H, int W, int C) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0) return false;
  const long long tiles = (long long)((H + kRows - 1) / kRows) * ((W + kCols - 1) / kCols);
  const int ck = chunk_channels(C);
  return tiles <= 0x7fffffffLL && (C + ck - 1) / ck <= 65535;
}

template <typename T>
__global__ void __launch_bounds__(kPairs * kChunk)
dw_gelu_kernel(const T* __restrict__ e, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ t, float* __restrict__ part,
               int H, int W, int C, int Hs, int top, int ck, int ntx, int ntiles, int vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* es = reinterpret_cast<T*>(smem);       // halo, [hr][hc][k]
  T* ts = es + kHRows * kHCols * ck;        // t tile, [r][c][k]
  const size_t tiles = (size_t)(kHRows * kHCols + kRows * kCols) * ck * sizeof(T);
  float* wsh = reinterpret_cast<float*>(smem + (tiles + 15) / 16 * 16);  // taps, [k][25]
  float* red = wsh + 25 * ck;               // one partial per thread
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * ck;
  const int nk = min(ck, C - ch0);  // the last chunk may be partial
  const int tr0 = (tile / ntx) * kRows;
  const int tc0 = (tile % ntx) * kCols;
  const int tid = threadIdx.x;
  // copy units: thread tid moves unit cv of pixels cp0, cp0 + cstep, ...
  // (ck * sizeof(T) / vb units a pixel divide the kPairs * ck threads, so no
  // thread divides by a run-time value in the loops); units past the
  // chunk's nk channels are skipped
  const int ps = ck * (int)sizeof(T);  // bytes per pixel in shared memory
  const int units = ps / vb;
  const int cv = tid % units;
  const int cp0 = tid / units;
  const int cstep = blockDim.x / units;
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
  for (int i = tid; i < 25 * nk; i += blockDim.x) wsh[i] = w[(int64_t)ch0 * 25 + i];
  cp_async_wait_all();
  __syncthreads();

  const int k = tid % ck;
  const int r = 2 * (tid / ck);  // this thread's output rows r and r + 1
  const int ncol = min(kCols, W - tc0);
  float s = 0.f;
  if (k < nk && tr0 + r < H) {
    const bool second = tr0 + r + 1 < H;
    float wr[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) wr[i] = wsh[k * 25 + i];
    const float bi = bias[ch0 + k];
    const T* ep = es + r * kHCols * ck + k;  // halo row r is output row r - 2
    T* tp = ts + r * kCols * ck + k;

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
      const float v0 = gelu_tanh(dw5x5<0>(bi, wr, win));
      const float v1 = gelu_tanh(dw5x5<1>(bi, wr, win));
      tp[c * ck] = from_f32<T>(v0);
      tp[(kCols + c) * ck] = from_f32<T>(v1);
      s += v0;
      if (second) s += v1;
    }
  }
  red[tid] = s;
  __syncthreads();

  // t out of the tile in copy units; the sums of the tile's rows in order
  T* tb = t + (int64_t)b * H * W * C + ch0;
  for (int o = cp0; cin && o < kRows * kCols; o += cstep) {
    const int rr = tr0 + o / kCols;
    const int cc = tc0 + o % kCols;
    if (rr < H && cc < W) {
      store_vec(reinterpret_cast<unsigned char*>(tb + ((int64_t)rr * W + cc) * C) + cv * vb,
                reinterpret_cast<const unsigned char*>(ts) + o * ps + cv * vb, vb);
    }
  }
  if (r == 0 && k < nk) {
    float tot = 0.f;
    for (int q = 0; q < kPairs; ++q) tot += red[q * ck + k];
    part[((int64_t)b * ntiles + tile) * C + ch0 + k] = tot;
  }
}

template <typename T>
int launch(const void* e, const float* w, const float* bias, void* t, float* sums, float* part,
           int B, int H, int W, int C, int Hs, int top, const Geometry& g, cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(dw_gelu_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(g.ntiles, B, g.nchunk);
  dw_gelu_kernel<T><<<grid, kPairs * g.ck, g.smem, stream>>>(
      static_cast<const T*>(e), w, bias, static_cast<T*>(t), part, H, W, C, Hs, top, g.ck,
      g.ntx, g.ntiles, g.vb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_warp<<<(B * C + kWarpsPerReduce - 1) / kWarpsPerReduce, 32 * kWarpsPerReduce,
                         0, stream>>>(part, sums, B * C, g.ntiles, C, (long long)g.ntiles * C, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (e and t share it); e is (B, Hs, W*C),
// t (B, H, W*C) with output row r at slab row top + r (0 <= top, top + H <=
// Hs); w is float32 (C, 1, 5, 5), bias float32 (C,), sums float32 (B, C) over
// the H output rows, part float32 scratch of `workspace` values. All
// contiguous. The plan (tile rows and columns,
// channels per chunk, copy unit in bytes, shared-memory bytes, workspace)
// must equal the kernel's own for this shape. Returns the first CUDA error
// of the two launches: 0 on success; cudaErrorInvalidValue for a shape or
// plan it does not take.
extern "C" int lmnet_rc_dw_gelu(const void* e, const void* w, const void* bias, void* t,
                                void* sums, void* part, int B, int H, int W, int C, int Hs,
                                int top, int dtype,
                                int tile_rows, int tile_cols, int chunk, int vb,
                                long long smem, long long workspace, void* stream) {
  if (!shape_ok(B, H, W, C) || (dtype != 0 && dtype != 1) || top < 0 || top + H > Hs) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g = geometry(B, H, W, C, dtype == 0 ? 4 : 2);
  if (tile_rows != kRows || tile_cols != kCols || chunk != g.ck || vb != g.vb ||
      smem != (long long)g.smem || workspace != g.workspace || g.smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* sf = static_cast<float*>(sums);
  float* pf = static_cast<float*>(part);
  if (dtype == 0) return launch<float>(e, wf, bf, t, sf, pf, B, H, W, C, Hs, top, g, s);
  return launch<__nv_bfloat16>(e, wf, bf, t, sf, pf, B, H, W, C, Hs, top, g, s);
}
