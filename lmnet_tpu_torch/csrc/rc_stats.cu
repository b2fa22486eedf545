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
// What bounds it on an H100: memory. It must read e once from device memory
// (2 B per element in bf16) and writes nothing but (4, 2, C); 40
// multiply-adds and 8 accumulations per element stay far below the card's
// ~295 flops/byte ridge. As in rc_dw_gelu.cu, the block copies its tile's
// halo into shared memory with every load in flight at once and slides the
// 5x5 window out of it (rc_common.cuh, load_halo); all four branch outputs
// come from that one window (the 3x3, 3x1 and 1x3 windows are its centre).
// Threads are (tile row, channel), channel fastest; the chunk's 40 taps per
// channel come through shared memory (coalesced reads), and each thread
// keeps its own taps and its 8 running sums in registers. A block sums them
// over its rows in order into one partial per (tile, statistic, channel);
// lmnet_rc::reduce_partials adds the partials of all B x tiles in a fixed
// order. No atomics, so two calls give bitwise-equal statistics.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_train.py).

#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;

constexpr int kTaps = 41;  // 25 + 9 + 3 + 3 taps per channel, padded to an odd stride (banks)

// halo, taps, 8 partials per thread
size_t smem_bytes(int ck) {
  return (size_t)(kHaloRows * halo_row_stride(ck) + kTaps * ck + 8 * kTileRows * ck) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kTileRows * kMaxChunk)
rc_stats_kernel(const T* __restrict__ e, const float* __restrict__ k5,
                const float* __restrict__ k3, const float* __restrict__ kv,
                const float* __restrict__ kh, float* __restrict__ part, int H, int W, int C,
                int ck, int ntx, int ntiles) {
  extern __shared__ float smem[];
  const int rs = halo_row_stride(ck);
  float* es = smem;
  float* wsh = es + kHaloRows * rs;  // the taps, kTaps floats per channel
  float* red = wsh + kTaps * ck;     // 8 floats per thread, statistic-major
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * ck;
  const int nk = min(ck, C - ch0);  // the last chunk may be partial
  const int tr0 = (tile / ntx) * kTileRows;
  const int tc0 = (tile % ntx) * kTileCols;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  load_halo(e, es, H, W, C, b, tr0, tc0, ch0, nk, ck, rs);
  for (int i = tid; i < 25 * nk; i += nthreads)
    wsh[(i / 25) * kTaps + i % 25] = k5[(int64_t)ch0 * 25 + i];
  for (int i = tid; i < 9 * nk; i += nthreads)
    wsh[(i / 9) * kTaps + 25 + i % 9] = k3[(int64_t)ch0 * 9 + i];
  for (int i = tid; i < 3 * nk; i += nthreads) {
    wsh[(i / 3) * kTaps + 34 + i % 3] = kv[(int64_t)ch0 * 3 + i];
    wsh[(i / 3) * kTaps + 37 + i % 3] = kh[(int64_t)ch0 * 3 + i];
  }
  __syncthreads();

  const int k = tid % ck;
  const int r = tid / ck;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  if (k < nk && tr0 + r < H) {
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
    const float* ep = es + r * rs + k;  // halo row r is output row r - 2
    const int ncol = min(kTileCols, W - tc0);

    // win[i][j]: halo row r + i, halo column c + j for output column c
    float win[5][5];
#pragma unroll
    for (int j = 1; j < 5; ++j) {
#pragma unroll
      for (int i = 0; i < 5; ++i) win[i][j] = ep[i * rs + (j - 1) * ck];
    }
    // unrolled, so that the window's shifts are register renames
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      if (c >= ncol) break;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) win[i][j] = win[i][j + 1];
        win[i][4] = ep[i * rs + (c + 4) * ck];
      }
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) y[0] += w5[i * 5 + j] * win[i][j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) y[1] += w3[i * 3 + j] * win[i + 1][j + 1];
        y[2] += wv[i] * win[i + 1][2];  // 3x1: down the centre column
        y[3] += wh[i] * win[2][i + 1];  // 1x3: along the centre row
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[2 * q] += y[q];
        acc[2 * q + 1] += y[q] * y[q];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) red[j * nthreads + tid] = acc[j];
  __syncthreads();
  if (r == 0 && k < nk) {
    float* out = part + ((int64_t)b * ntiles + tile) * 8 * C + ch0 + k;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float tot = 0.f;
      for (int q = 0; q < kTileRows; ++q) tot += red[j * nthreads + q * ck + k];
      out[j * C] = tot;
    }
  }
}

template <typename T>
int launch(const void* e, const float* k5, const float* k3, const float* kv, const float* kh,
           float* out, float* part, int B, int H, int W, int C, cudaStream_t stream) {
  const Tiling g = tiling(H, W, C);
  dim3 grid(g.ntiles, B, g.nchunk);
  rc_stats_kernel<T><<<grid, g.threads, smem_bytes(g.ck), stream>>>(
      static_cast<const T*>(e), k5, k3, kv, kh, part, H, W, C, g.ck, g.ntx, g.ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<8 * C, kReduceThreads, 0, stream>>>(part, out, B * g.ntiles, C, C,
                                                        8LL * C);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of float32 values the caller allocates for ``part`` (the tiles'
// partial statistics); -1 for a shape the kernel does not take.
extern "C" long long lmnet_rc_stats_workspace(int B, int H, int W, int C) {
  if (!tiling_ok(B, H, W, C)) return -1;
  return (long long)B * tiling(H, W, C).ntiles * 8 * C;
}

// dtype: 0 = float32, 1 = bfloat16 (e); the four kernels are float32 OIHW
// depthwise; out is float32 (4, 2, C): per branch (5x5, 3x3, 3x1, 1x3) the
// sum and the sum of squares over B*H*W; part is float32 scratch of
// lmnet_rc_stats_workspace(...) values. All contiguous. Returns the first
// CUDA error of the two launches: 0 on success.
extern "C" int lmnet_rc_stats(const void* e, const void* k5, const void* k3, const void* kv,
                              const void* kh, void* out, void* part, int B, int H, int W, int C,
                              int dtype, void* stream) {
  if (!tiling_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(k5);
  const float* b = static_cast<const float*>(k3);
  const float* v = static_cast<const float*>(kv);
  const float* h = static_cast<const float*>(kh);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  if (dtype == 0) return launch<float>(e, a, b, v, h, o, p, B, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(e, a, b, v, h, o, p, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
