// Neighborhood attention backward, kernel size 3, NATTEN semantics, on the
// flat (B, H, W*C) activation layout.
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_flat.py::nat_flat_bwd
// (_nat_flat_bwd_kernel, _combine_halo, _unflatten_dbias). It computes the
// gradient of the forward in csrc/nat_fwd.cu from its definition, not that
// kernel's TPU layout: no base-2 softmax (and no ln2 on dk), no stripe halos
// to combine, no flat-lane bias table to unflatten.
//
// For every (b, query pixel p, head h), with the clamped window k_i(p) of
// the forward (rows clamp(r-1, 0, H-3) .. +2, the same for columns),
// a = softmax(scale * <q_p, k_i> + rpb[h, off_i]) and upstream gradient g_p:
//   da_i = <g_p, v_{k_i}>,  delta_p = sum_i a_i da_i,  dl_i = a_i (da_i - delta_p)
//   dq_p = scale * sum_i dl_i k_{k_i}
//   dk_j = scale * sum_{(p,i): k_i(p)=j} dl_i(p) q_p
//   dv_j =         sum_{(p,i): k_i(p)=j} a_i(p) g_p
//   d_rpb[h, off_i] = sum_{b,p} dl_i(p)
//
// Three launches on the caller's stream, no atomics, so two calls with the
// same inputs give bitwise-equal outputs:
//   1. nat_bwd_query_kernel, one thread per (query, head): recomputes the
//      softmax, writes dq, the log-sum-exp and delta (float32, one each per
//      (query, head)), and sums dl into 25 per-thread bias accumulators. A
//      block reduces those over its pixels in a fixed tree and writes one
//      (heads, 25) partial. The grid is a fixed number of blocks that stride
//      over the pixels, so the partial buffer is small and its size depends
//      on the shape alone.
//   2. nat_bwd_key_kernel, one thread per (key, head): gathers dk and dv over
//      the inverse neighbourhood, the queries within +-2 rows and columns of
//      the key whose clamped window covers it (at most 5x5 candidates at the
//      borders, 3x3 inside), recomputing a_i(p) from the log-sum-exp.
//   3. nat_bwd_dbias_reduce, one block per (head, offset): sums the partials
//      in a fixed order.
// Loads are bf16 or f32, the math is f32, dq/dk/dv are stored in q's dtype,
// d_rpb in f32.
//
// What bounds it on an H100: memory. It reads q, k, v and g and writes dq,
// dk and dv (7 x 2 B per element in bf16), plus 2 x 4 B of log-sum-exp and
// delta per (pixel, head) written once and read up to 25 times; the
// arithmetic is a few dozen flops per element. The window re-reads are
// served from L1/L2 because neighbouring threads read neighbouring pixels.
// As in the forward, head_dim is a compile-time constant where it is 1, 2, 4
// or 8 and a runtime loop otherwise. Shared-memory tiles of k/v and q/g are
// later work.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_flat.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueryThreads = 256;   // upper bound on the query kernel's block
constexpr int kQueryBlocks = 4096;   // the query kernel's grid (it strides)
constexpr int kKeyThreads = 256;
constexpr int kReduceThreads = 256;  // a power of two

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

// first row (or column) of the clamped 3-wide window around x in [0, n)
__device__ __forceinline__ int window_start(int x, int n) { return min(max(x - 1, 0), n - 3); }

template <typename T, int HD>
__device__ __forceinline__ float dot(const T* __restrict__ a, const T* __restrict__ b, int hd_rt) {
  float s = 0.f;
  if constexpr (HD > 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d) s += to_f32(a[d]) * to_f32(b[d]);
  } else {
    for (int d = 0; d < hd_rt; ++d) s += to_f32(a[d]) * to_f32(b[d]);
  }
  return s;
}

// Slot i of a query whose window starts DR rows and DC columns before it
// reads rpb[(i/3 + 2 - DR) * 5 + (i%3 + 2 - DC)]. Compile-time indices keep
// the 25 accumulators in registers.
template <int DR, int DC>
__device__ __forceinline__ void add_dbias(float (&acc)[25], const float (&dl)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[(i / 3 + 2 - DR) * 5 + (i % 3 + 2 - DC)] += dl[i];
}

__device__ __forceinline__ void add_dbias(float (&acc)[25], const float (&dl)[9], int dr, int dc) {
  switch (dr * 3 + dc) {
    case 0: add_dbias<0, 0>(acc, dl); break;
    case 1: add_dbias<0, 1>(acc, dl); break;
    case 2: add_dbias<0, 2>(acc, dl); break;
    case 3: add_dbias<1, 0>(acc, dl); break;
    case 4: add_dbias<1, 1>(acc, dl); break;
    case 5: add_dbias<1, 2>(acc, dl); break;
    case 6: add_dbias<2, 0>(acc, dl); break;
    case 7: add_dbias<2, 1>(acc, dl); break;
    default: add_dbias<2, 2>(acc, dl); break;
  }
}

// Block: ppb pixels x heads threads, thread = (pixel slot, head) with the
// head fastest, so a block reads one contiguous run of (pixel, head) rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kQueryThreads)
nat_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ rpb,
                     T* __restrict__ dq, float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ dbias_part, int B, int H, int W, int heads, int hd_rt,
                     int ppb, float scale) {
  __shared__ float red[25 * kQueryThreads];
  const int hd = HD > 0 ? HD : hd_rt;
  const int nthreads = blockDim.x;  // heads * ppb
  const int tid = threadIdx.x;
  const int head = tid % heads;
  const int slot = tid / heads;
  const int64_t C = (int64_t)heads * hd;
  const int64_t npix = (int64_t)B * H * W;
  const float* bias = rpb + head * 25;

  float acc[25];
#pragma unroll
  for (int e = 0; e < 25; ++e) acc[e] = 0.f;

  for (int64_t pix = (int64_t)blockIdx.x * ppb + slot; pix < npix;
       pix += (int64_t)gridDim.x * ppb) {
    const int col = (int)(pix % W);
    const int row = (int)((pix / W) % H);
    const int64_t img = pix - ((int64_t)row * W + col);  // b * H * W
    const int r0 = window_start(row, H);
    const int c0 = window_start(col, W);
    const int dr = row - r0;
    const int dc = col - c0;
    const int64_t qoff = pix * C + (int64_t)head * hd;

    int64_t koff[9];
    float a[9], da[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      koff[i] = (img + (int64_t)(r0 + i / 3) * W + (c0 + i % 3)) * C + (int64_t)head * hd;
      a[i] = scale * dot<T, HD>(q + qoff, k + koff[i], hd) +
             bias[(i / 3 + 2 - dr) * 5 + (i % 3 + 2 - dc)];
      da[i] = dot<T, HD>(g + qoff, v + koff[i], hd);
    }
    float m = a[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) m = fmaxf(m, a[i]);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      a[i] = expf(a[i] - m);
      den += a[i];
    }
    const float inv = 1.f / den;
    float dsum = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      a[i] *= inv;
      dsum += a[i] * da[i];
    }
    float dl[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) dl[i] = a[i] * (da[i] - dsum);

    for (int d = 0; d < hd; ++d) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 9; ++i) s += dl[i] * to_f32(k[koff[i] + d]);
      dq[qoff + d] = from_f32<T>(s * scale);
    }
    lse[pix * heads + head] = m + logf(den);
    delta[pix * heads + head] = dsum;
    add_dbias(acc, dl, dr, dc);
  }

  // per-head sums over the block's ppb pixel slots, in a fixed tree
#pragma unroll
  for (int e = 0; e < 25; ++e) red[e * nthreads + tid] = acc[e];
  __syncthreads();
  for (int s = ppb / 2; s > 0; s >>= 1) {
    if (slot < s) {
#pragma unroll
      for (int e = 0; e < 25; ++e) red[e * nthreads + tid] += red[e * nthreads + tid + s * heads];
    }
    __syncthreads();
  }
  if (slot == 0) {
    float* out = dbias_part + ((int64_t)blockIdx.x * heads + head) * 25;
#pragma unroll
    for (int e = 0; e < 25; ++e) out[e] = red[e * nthreads + tid];
  }
}

// Candidate c = (dy, dx) in [-2, 2]^2 of the key (row, col): the query at
// (row + dy, col + dx) if it lies in the map and its clamped window covers
// the key. Then it sets the query's flat pixel index and offset.
__device__ __forceinline__ bool covers(int row, int col, int dy, int dx, int H, int W,
                                       int64_t img, int64_t* qpix) {
  const int rq = row + dy;
  const int cq = col + dx;
  if (rq < 0 || rq >= H || cq < 0 || cq >= W) return false;
  const int r0 = window_start(rq, H);
  const int c0 = window_start(cq, W);
  if (row < r0 || row > r0 + 2 || col < c0 || col > c0 + 2) return false;
  *qpix = img + (int64_t)rq * W + cq;
  return true;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kKeyThreads)
nat_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ g, const float* __restrict__ rpb,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int B, int H, int W, int heads,
                   int hd_rt, float scale) {
  const int hd = HD > 0 ? HD : hd_rt;
  const int64_t total = (int64_t)B * H * W * heads;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;

  const int head = (int)(t % heads);
  const int64_t pix = t / heads;
  const int col = (int)(pix % W);
  const int row = (int)((pix / W) % H);
  const int64_t img = pix - ((int64_t)row * W + col);
  const int64_t C = (int64_t)heads * hd;
  const int64_t koff = pix * C + (int64_t)head * hd;
  const float* bias = rpb + head * 25;

  // the key sits at offset (-dy, -dx) from the query: bias index
  // (2 - dy) * 5 + (2 - dx)
  if constexpr (HD > 0) {
    float sk[HD], sv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) sk[d] = sv[d] = 0.f;
#pragma unroll
    for (int c = 0; c < 25; ++c) {
      const int dy = c / 5 - 2;
      const int dx = c % 5 - 2;
      int64_t qp;
      if (!covers(row, col, dy, dx, H, W, img, &qp)) continue;
      const int64_t qoff = qp * C + (int64_t)head * hd;
      const float s = scale * dot<T, HD>(q + qoff, k + koff, hd) + bias[(2 - dy) * 5 + (2 - dx)];
      const float a = expf(s - lse[qp * heads + head]);
      const float dl = a * (dot<T, HD>(g + qoff, v + koff, hd) - delta[qp * heads + head]);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        sk[d] += dl * to_f32(q[qoff + d]);
        sv[d] += a * to_f32(g[qoff + d]);
      }
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[koff + d] = from_f32<T>(sk[d] * scale);
      dv[koff + d] = from_f32<T>(sv[d]);
    }
  } else {
    float a[25], dl[25];
    int64_t qoffs[25];
    unsigned valid = 0u;
#pragma unroll
    for (int c = 0; c < 25; ++c) {
      const int dy = c / 5 - 2;
      const int dx = c % 5 - 2;
      int64_t qp;
      a[c] = 0.f;
      dl[c] = 0.f;
      qoffs[c] = 0;
      if (!covers(row, col, dy, dx, H, W, img, &qp)) continue;
      valid |= 1u << c;
      const int64_t qoff = qp * C + (int64_t)head * hd;
      qoffs[c] = qoff;
      const float s = scale * dot<T, 0>(q + qoff, k + koff, hd) + bias[(2 - dy) * 5 + (2 - dx)];
      a[c] = expf(s - lse[qp * heads + head]);
      dl[c] = a[c] * (dot<T, 0>(g + qoff, v + koff, hd) - delta[qp * heads + head]);
    }
    for (int d = 0; d < hd; ++d) {
      float sk = 0.f, sv = 0.f;
#pragma unroll
      for (int c = 0; c < 25; ++c) {
        if (valid & (1u << c)) {
          sk += dl[c] * to_f32(q[qoffs[c] + d]);
          sv += a[c] * to_f32(g[qoffs[c] + d]);
        }
      }
      dk[koff + d] = from_f32<T>(sk * scale);
      dv[koff + d] = from_f32<T>(sv);
    }
  }
}

// One block per (head, offset) entry e of d_rpb: the partials of all query
// blocks, strided over the threads, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
nat_bwd_dbias_reduce(const float* __restrict__ part, float* __restrict__ drpb, int nblocks,
                     int n) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int b = tid; b < nblocks; b += kReduceThreads) s += part[(int64_t)b * n + e];
  red[tid] = s;
  __syncthreads();
  for (int st = kReduceThreads / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) drpb[e] = red[0];
}

// pixels per query block: the largest power of two with heads * ppb <= 256
int pixels_per_block(int heads) {
  int ppb = 1;
  while (heads * ppb * 2 <= kQueryThreads) ppb *= 2;
  return ppb;
}

int query_blocks(int B, int H, int W, int heads) {
  const int64_t npix = (int64_t)B * H * W;
  const int ppb = pixels_per_block(heads);
  const int64_t need = (npix + ppb - 1) / ppb;
  return (int)(need < kQueryBlocks ? need : kQueryBlocks);
}

bool shape_ok(int B, int H, int W, int heads, int hd) {
  return B > 0 && H >= 3 && W >= 3 && heads > 0 && heads <= kQueryThreads && hd > 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const float* rpb,
           void* dq, void* dk, void* dv, float* drpb, float* lse, float* delta, float* part,
           int B, int H, int W, int heads, int hd, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);

  const int ppb = pixels_per_block(heads);
  const int qblocks = query_blocks(B, H, W, heads);
  const int qthreads = heads * ppb;
#define LMNET_NAT_BWD_QUERY(HDC)                                                               \
  nat_bwd_query_kernel<T, HDC><<<qblocks, qthreads, 0, stream>>>(                              \
      qt, kt, vt, gt, rpb, dqt, lse, delta, part, B, H, W, heads, hd, ppb, scale)
  switch (hd) {
    case 1: LMNET_NAT_BWD_QUERY(1); break;
    case 2: LMNET_NAT_BWD_QUERY(2); break;
    case 4: LMNET_NAT_BWD_QUERY(4); break;
    case 8: LMNET_NAT_BWD_QUERY(8); break;
    default: LMNET_NAT_BWD_QUERY(0); break;
  }
#undef LMNET_NAT_BWD_QUERY
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t total = (int64_t)B * H * W * heads;
  const unsigned kblocks = (unsigned)((total + kKeyThreads - 1) / kKeyThreads);
#define LMNET_NAT_BWD_KEY(HDC)                                                                 \
  nat_bwd_key_kernel<T, HDC><<<kblocks, kKeyThreads, 0, stream>>>(                             \
      qt, kt, vt, gt, rpb, lse, delta, dkt, dvt, B, H, W, heads, hd, scale)
  switch (hd) {
    case 1: LMNET_NAT_BWD_KEY(1); break;
    case 2: LMNET_NAT_BWD_KEY(2); break;
    case 4: LMNET_NAT_BWD_KEY(4); break;
    case 8: LMNET_NAT_BWD_KEY(8); break;
    default: LMNET_NAT_BWD_KEY(0); break;
  }
#undef LMNET_NAT_BWD_KEY
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  nat_bwd_dbias_reduce<<<heads * 25, kReduceThreads, 0, stream>>>(part, drpb, qblocks,
                                                                   heads * 25);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of float32 values the caller allocates for ``part`` (the query
// blocks' d_rpb partials); -1 for a shape the kernel does not take.
extern "C" long long lmnet_nat_bwd_workspace(int B, int H, int W, int heads, int hd) {
  if (!shape_ok(B, H, W, heads, hd)) return -1;
  return (long long)query_blocks(B, H, W, heads) * heads * 25;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk and dv share it);
// rpb and drpb are float32 (heads, 5, 5); lse and delta are float32
// (B*H*W*heads) scratch; part is float32 scratch of
// lmnet_nat_bwd_workspace(...) values. All contiguous. Returns the first
// CUDA error of the three launches: 0 on success.
extern "C" int lmnet_nat_bwd(const void* q, const void* k, const void* v, const void* g,
                             const void* rpb, void* dq, void* dk, void* dv, void* drpb,
                             void* lse, void* delta, void* part, int B, int H, int W, int heads,
                             int hd, float scale, int dtype, void* stream) {
  if (!shape_ok(B, H, W, heads, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  float* dr = static_cast<float*>(drpb);
  float* l = static_cast<float*>(lse);
  float* de = static_cast<float*>(delta);
  float* p = static_cast<float*>(part);
  if (dtype == 0) {
    return launch<float>(q, k, v, g, r, dq, dk, dv, dr, l, de, p, B, H, W, heads, hd, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, g, r, dq, dk, dv, dr, l, de, p, B, H, W, heads, hd,
                                 scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
