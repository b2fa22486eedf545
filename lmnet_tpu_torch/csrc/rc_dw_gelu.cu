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
// What bounds it on an H100: memory. Per element it must read e once from
// device memory and write t once (2 x 2 B in bf16); 25 multiply-adds and one
// tanh per element are far below the card's ~295 flops/byte ridge. A design
// in which each thread fetches its own window from device memory waits on
// those loads one output after another and reaches ~160 GB/s. So the block
// copies its tile's halo into shared memory first, all loads in flight at
// once, and then slides the window out of shared memory (rc_common.cuh,
// load_halo). Threads are (tile row, channel) with the channel fastest, so a
// warp's stores of t are contiguous runs of channels. The taps of the
// chunk's channels come through shared memory too (one coalesced read).
// The channel sums go through per-tile partials (each thread's row in column
// order, then the tile's rows in order) and lmnet_rc::reduce_partials, in a
// fixed order: no atomics, so two calls give bitwise-equal sums.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/rc_flat.py).

#include "rc_common.cuh"

namespace {

using namespace lmnet_rc;

// halo, taps (25 per channel), one partial per thread
size_t smem_bytes(int ck) {
  return (size_t)(kHaloRows * halo_row_stride(ck) + 25 * ck + kTileRows * ck) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kTileRows * kMaxChunk)
dw_gelu_kernel(const T* __restrict__ e, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ t, float* __restrict__ part,
               int H, int W, int C, int ck, int ntx, int ntiles) {
  extern __shared__ float smem[];
  const int rs = halo_row_stride(ck);
  float* es = smem;
  float* wsh = es + kHaloRows * rs;
  float* red = wsh + 25 * ck;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.z * ck;
  const int nk = min(ck, C - ch0);  // the last chunk may be partial
  const int tr0 = (tile / ntx) * kTileRows;
  const int tc0 = (tile % ntx) * kTileCols;
  const int tid = threadIdx.x;

  load_halo(e, es, H, W, C, b, tr0, tc0, ch0, nk, ck, rs);
  for (int i = tid; i < 25 * nk; i += blockDim.x) wsh[i] = w[(int64_t)ch0 * 25 + i];
  __syncthreads();

  const int k = tid % ck;
  const int r = tid / ck;
  const int row = tr0 + r;
  float s = 0.f;
  if (k < nk && row < H) {
    float wr[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) wr[i] = wsh[k * 25 + i];
    const float bi = bias[ch0 + k];
    const float* ep = es + r * rs + k;  // halo row r is output row r - 2
    T* tp = t + (((int64_t)b * H + row) * W + tc0) * C + ch0 + k;
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
      float acc = bi;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) acc += wr[i * 5 + j] * win[i][j];
      }
      const float v = gelu_tanh(acc);
      tp[(int64_t)c * C] = from_f32<T>(v);
      s += v;
    }
  }

  red[tid] = s;
  __syncthreads();
  if (r == 0 && k < nk) {
    float tot = 0.f;
    for (int q = 0; q < kTileRows; ++q) tot += red[q * ck + k];
    part[((int64_t)b * ntiles + tile) * C + ch0 + k] = tot;
  }
}

template <typename T>
int launch(const void* e, const float* w, const float* bias, void* t, float* sums, float* part,
           int B, int H, int W, int C, cudaStream_t stream) {
  const Tiling g = tiling(H, W, C);
  dim3 grid(g.ntiles, B, g.nchunk);
  dw_gelu_kernel<T><<<grid, g.threads, smem_bytes(g.ck), stream>>>(
      static_cast<const T*>(e), w, bias, static_cast<T*>(t), part, H, W, C, g.ck, g.ntx,
      g.ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<B * C, kReduceThreads, 0, stream>>>(part, sums, g.ntiles, C,
                                                        (long long)g.ntiles * C, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of float32 values the caller allocates for ``part`` (the tiles'
// channel-sum partials); -1 for a shape the kernel does not take.
extern "C" long long lmnet_rc_dw_gelu_workspace(int B, int H, int W, int C) {
  if (!tiling_ok(B, H, W, C)) return -1;
  return (long long)B * tiling(H, W, C).ntiles * C;
}

// dtype: 0 = float32, 1 = bfloat16 (e and t share it); w is float32
// (C, 1, 5, 5), bias float32 (C,), sums float32 (B, C), part float32 scratch
// of lmnet_rc_dw_gelu_workspace(...) values. All contiguous. Returns the
// first CUDA error of the two launches: 0 on success.
extern "C" int lmnet_rc_dw_gelu(const void* e, const void* w, const void* bias, void* t,
                                void* sums, void* part, int B, int H, int W, int C, int dtype,
                                void* stream) {
  if (!tiling_ok(B, H, W, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* sf = static_cast<float*>(sums);
  float* pf = static_cast<float*>(part);
  if (dtype == 0) return launch<float>(e, wf, bf, t, sf, pf, B, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(e, wf, bf, t, sf, pf, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}
