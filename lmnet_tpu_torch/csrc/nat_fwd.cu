// Neighborhood attention forward, kernel size 3, NATTEN semantics, on the
// flat (B, H, W*C) activation layout (B1).
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_flat.py::nat_flat
// (_nat_flat_kernel). It computes the same function, not that kernel's TPU
// layout (lane rolls, 8-row halo edge blocks, stripe policy):
// for every (b, row, col, head),
//   the 3x3 key window starts at clamp(row-1, 0, H-3), clamp(col-1, 0, W-3)
//   (slid inward at the borders, never padded);
//   logit[i] = scale * <q, k_i> + rpb[head, kr-row+2, kc-col+2];
//   out = sum_i softmax(logit)[i] * v_i.
// Loads are bf16 or f32, the math is f32, the store is in q's dtype, and rpb
// stays f32. The softmax runs in base 2 (q scaled by scale*log2(e), rpb by
// log2(e), one ex2 a logit): the same function within float32 rounding.
//
// What bounds it on an H100: by its bytes, memory (q, k, v in and out once,
// 4 x 2 B an element in bf16: 188.7 MB, 0.056 ms at 3.35 TB/s over the four
// NAT stages of a 256^2, B=16 forward; ~36 flops an element, far below the
// card's ridge); in practice instruction issue and the exponentials (9 a
// (pixel, head), on the 16-a-clock MUFU unit). The earlier design, one thread
// per (pixel, head) with 2-byte loads of q, 9 k and 9 v through L1/L2 and
// 64-bit index division, reached 475 GB/s at the 256^2 stage (head_dim 1).
//
// The design.
//  * Grid (column tile, row tile, image x head chunk); a block owns a tile
//    of rows x cols pixels (32 x 32, fewer rows on small maps so that the
//    card gets at least two blocks an SM) and nh heads (all 12 of the
//    model's). No thread divides a 64-bit index; the few 32-bit divisions
//    are made once per thread (Walk).
//  * The block copies the clamped k and v halo of its tile, at most
//    (rows + 2) x (cols + 2) pixels (the clamped window never leaves the
//    map, so the halo needs no zero fill), into shared memory in the input
//    dtype with cp.async in the widest unit that divides a pixel's channel
//    run: 16 bytes, or 8 where the run is 8 mod 16. The 256^2 stage has
//    C = 12, a 24-byte bf16 pixel: it copies in 8-byte units (three a pixel;
//    a warp's copies still cover whole contiguous 32-byte sectors), which
//    costs copy instructions, not bytes, and keeps every unit aligned
//    without masking. rpb (times log2 e) goes to shared memory once.
//  * Thread (pixel, channel group) owns at most 4 heads (their 9 logits
//    each stay in registers) in one vector of 16 or 8 bytes: bf16 8
//    channels at head_dim 2, 4, 8 (4, 2, 1 heads a thread) and 4 channels,
//    8 bytes, at head_dim 1 (4 heads, the 256^2 stage's C = 12 included);
//    f32 4 channels, or one head of 8 (32 bytes). It loads q and
//    stores out as one vector each, straight to and from device memory, and
//    reads its 9 window pixels from shared memory as vectors.
//  * Any other head_dim (3, 16, ...), or a C that no 8-byte group divides,
//    takes the generic variant in this source: the same tiled grid, one
//    thread per (pixel, head) with a run-time head_dim, k and v read through
//    L1/L2 and rpb from shared memory.
// The launch plan (variant, tile, heads a block, threads, shared memory,
// copy unit) comes from the caller (ops/nat_flat.py::nat_plan); the entry
// point computes its own (nat_common.cuh::make_plan) and refuses a plan that
// differs.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_flat.py).

#include "nat_common.cuh"

namespace {

using namespace lmnet_nat;

// HD > 0: head_dim HD, NH heads a thread, halos staged in shared memory.
// HD == 0: the generic variant, one head a thread, head_dim hd_rt.
template <typename T, int HD, int NH>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
nat_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ rpb, T* __restrict__ out, int H, int W, int heads,
               int hd_rt, int nh, int rows, int cols, int ppb, int vb, float scale2) {
  constexpr int G = HD * NH;  // channels a thread (vec)
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD > 0 ? HD : hd_rt;
  const int nchunk = cdiv(heads, nh);
  const int b = blockIdx.z / nchunk;
  const int h0 = (blockIdx.z - b * nchunk) * nh;
  const int nhb = min(nh, heads - h0);  // heads of this block
  const int per = HD > 0 ? NH : 1;
  const int tpp = nh / per;
  const int cg = threadIdx.x % tpp;  // this thread's heads: h0 + cg*per ...
  const int C = heads * hd;
  const int ck = nh * hd;  // a halo pixel's elements
  const int tr0 = blockIdx.y * rows;
  const int tc0 = blockIdx.x * cols;
  const int hr0 = window_start(tr0, H);
  const int hc0 = window_start(tc0, W);
  const int hw = cols + 2;  // halo row, in pixels
  const Layout L = layout(kFwd, HD > 0, rows, cols, nh, hd, sizeof(T), blockDim.x);
  const T* ks = reinterpret_cast<const T*>(smem + L.k);
  const T* vs = reinterpret_cast<const T*>(smem + L.v);
  float* rp = reinterpret_cast<float*>(smem + L.rpb);  // [entry][head], times log2 e
  const int64_t img = (int64_t)b * H * W;

  if constexpr (HD > 0) {
    const int nr = min(rows + 2, H - hr0);
    const int nc = min(cols + 2, W - hc0);
    const int run = nhb * HD * (int)sizeof(T);
    const long long off = (img * C + (int64_t)h0 * HD) * (int64_t)sizeof(T);
    copy_halo(smem + L.k, reinterpret_cast<const unsigned char*>(k) + off, hr0, hc0, nr, nc, hw,
              W, (long long)C * sizeof(T), ck * (int)sizeof(T), run, vb);
    copy_halo(smem + L.v, reinterpret_cast<const unsigned char*>(v) + off, hr0, hc0, nr, nc, hw,
              W, (long long)C * sizeof(T), ck * (int)sizeof(T), run, vb);
  }
  for (int i = threadIdx.x; i < 25 * nhb; i += blockDim.x) {
    const int e = i / nhb;
    const int h = i - e * nhb;
    rp[e * nh + h] = rpb[(h0 + h) * 25 + e] * kLog2e;
  }
  cp_async_wait_all();
  __syncthreads();
  if (cg * per >= nhb) return;  // a head group past the last head

  const int nr = min(rows, H - tr0);
  const int nc = min(cols, W - tc0);
  for (Walk w(threadIdx.x / tpp, ppb, nc); w.r < nr; w.next()) {
    const int row = tr0 + w.r;
    const int col = tc0 + w.c;
    const int r0 = window_start(row, H);
    const int c0 = window_start(col, W);
    const int base = (2 - (row - r0)) * 5 + (2 - (col - c0));  // rpb entry of window slot 0
    const int64_t pix = (img + (int64_t)row * W + col) * C;
    if constexpr (HD > 0) {
      const int64_t qo = pix + (int64_t)h0 * HD + cg * G;
      const int wo = ((r0 - hr0) * hw + (c0 - hc0)) * ck + cg * G;  // window slot 0 in the halo
      window_vec<T, HD, NH>(q + qo, ks + wo, vs + wo, hw, ck, rp + base * nh + cg * NH, nh,
                            scale2, out + qo);
    } else {
      const int64_t qo = pix + (int64_t)(h0 + cg) * hd;
      const int64_t wo = (img + (int64_t)r0 * W + c0) * C + (int64_t)(h0 + cg) * hd;
      window_generic<T, int64_t>(q + qo, k + wo, v + wo, (int64_t)W * C, (int64_t)C, hd,
                                 rp + base * nh + cg, nh, scale2, out + qo);
    }
  }
}

template <typename T, int HD, int NH>
int launch_one(const void* q, const void* k, const void* v, const float* rpb, void* out, int H,
               int W, int heads, int hd, const Plan& p, float scale2, cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(nat_fwd_kernel<T, HD, NH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  nat_fwd_kernel<T, HD, NH><<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rpb,
      static_cast<T*>(out), H, W, heads, hd, p.nh, p.rows, p.cols, p.ppb, p.vb, scale2);
  return (int)cudaGetLastError();
}

// the (head_dim, heads a thread) pairs make_plan gives the vec variant:
// bf16 8 or 4 channels a thread, f32 4 or 2, or one f32 head of 8; at most
// 4 heads a thread
template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rpb, void* out, int H,
           int W, int heads, int hd, const Plan& p, float scale2, cudaStream_t stream) {
  if (!p.vec) return launch_one<T, 0, 1>(q, k, v, rpb, out, H, W, heads, hd, p, scale2, stream);
#define LMNET_NAT_FWD(HDC, NHC)                                                                 \
  if (hd == HDC && p.per == NHC)                                                               \
    return launch_one<T, HDC, NHC>(q, k, v, rpb, out, H, W, heads, hd, p, scale2, stream);
  LMNET_NAT_FWD(8, 1)
  if constexpr (sizeof(T) == 2) {
    LMNET_NAT_FWD(2, 4) LMNET_NAT_FWD(4, 2) LMNET_NAT_FWD(1, 4) LMNET_NAT_FWD(2, 2)
    LMNET_NAT_FWD(4, 1)
  } else {
    LMNET_NAT_FWD(1, 4) LMNET_NAT_FWD(2, 2) LMNET_NAT_FWD(4, 1)
    LMNET_NAT_FWD(1, 2) LMNET_NAT_FWD(2, 1)
  }
#undef LMNET_NAT_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; rpb is float32
// (heads, 5, 5)). All tensors contiguous, q, k, v and out 16-byte aligned.
// The plan (variant 1 = vec / 0 = generic, heads a thread, tile rows and
// columns, heads a block, threads, shared-memory bytes, copy unit) must
// equal the kernel's own for this shape. Returns cudaGetLastError() after
// the launch: 0 on success; cudaErrorInvalidValue for a shape or plan it
// does not take.
extern "C" int lmnet_nat_fwd(const void* q, const void* k, const void* v, const void* rpb,
                             void* out, int B, int H, int W, int heads, int hd, float scale,
                             int dtype, int vec, int per, int rows, int cols, int nh, int threads,
                             long long smem, int vb, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(kFwd, B, H, W, heads, hd, dtype == 0 ? 4 : 2, &p)) return (int)cudaErrorInvalidValue;
  if (vec != p.vec || per != p.per || rows != p.rows || cols != p.cols || nh != p.nh ||
      threads != p.threads || smem != p.smem || vb != p.vb) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  const float scale2 = scale * kLog2e;
  if (dtype == 0) return launch<float>(q, k, v, r, out, H, W, heads, hd, p, scale2, s);
  return launch<__nv_bfloat16>(q, k, v, r, out, H, W, heads, hd, p, scale2, s);
}

// The kernel's own plan for this shape (nat_common.cuh::export_plan: 14
// numbers into out), for the tests that hold ops/nat_flat.py::nat_plan to it.
extern "C" void lmnet_nat_fwd_plan(int B, int H, int W, int heads, int hd, int dtype,
                                   long long* out) {
  export_plan(kFwd, B, H, W, heads, hd, dtype == 0 ? 4 : 2, out);
}
