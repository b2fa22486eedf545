// Neighborhood attention backward, kernel size 3, NATTEN semantics, on the
// flat (B, H, W*C) activation layout (B2).
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/nat_flat.py::nat_flat_bwd
// (_nat_flat_bwd_kernel, _combine_halo, _unflatten_dbias). It computes the
// gradient of the forward in csrc/nat_fwd.cu from its definition, not that
// kernel's TPU layout (no stripe halos to combine, no flat-lane bias table).
//
// For every (b, query pixel p, head h), with the clamped window k_i(p) of
// the forward (rows clamp(r-1, 0, H-3) .. +2, the same for columns),
// a = softmax(scale * <q_p, k_i> + rpb[h, off_i]) and upstream gradient g_p:
//   da_i = <g_p, v_{k_i}>,  delta_p = sum_i a_i da_i,  dl_i = a_i (da_i - delta_p)
//   dq_p = scale * sum_i dl_i k_{k_i}
//   dk_j = scale * sum_{(p,i): k_i(p)=j} dl_i(p) q_p
//   dv_j =         sum_{(p,i): k_i(p)=j} a_i(p) g_p
//   d_rpb[h, off_i] = sum_{b,p} dl_i(p)
// Loads are bf16 or f32, the math is f32 (the softmax in base 2, as in the
// forward), dq/dk/dv are stored in q's dtype, d_rpb in f32.
//
// What bounds it on an H100: instruction issue and latency, not memory.
// The bytes it must move (q, k, v and g read and dq, dk and dv written
// once, 7 x 2 B an element in bf16: 330 MB, 0.099 ms at 3.35 TB/s over the
// four stages of a 256^2, B=16 step) take a fraction of its time; the ~24
// exponentials and ~400 instructions a (pixel, head) at head_dim 1 (the
// halo recompute included) take the rest. The earlier design took three
// launches: a query kernel that wrote a float32 log-sum-exp and delta per
// (pixel, head) to device memory (8 bytes against the 14 a head_dim-1
// element must move), a key kernel that read them back up to 25 times per
// key through L1/L2 beside q and g, both with 2-byte loads and 64-bit index
// division, and the d_rpb reduction: 1.42 ms.
//
// The design: one tiled pass and the d_rpb reduction, two launches.
//  * A block owns a tile of rows x cols keys (32 x 16; fewer rows on small
//    maps) of one image and nh heads (a chunk of the 12 where shared memory
//    asks for it: 6 at the 256^2 and 128^2 stages). The queries whose
//    clamped window can cover a tile key lie within +-2 rows and columns of
//    the tile (a border query's window slides inward by one); their windows
//    lie within +-3. The block copies k and v of that +-3 halo into shared
//    memory in the input dtype with cp.async in the widest unit that
//    divides a pixel's channel run: 16 bytes from head_dim 4 up; the 6-head
//    chunks of the 256^2 stage are 12 bytes a pixel, copied in 4-byte
//    units, and the 128^2 stage's 24 bytes in 8-byte units (the copy is a
//    few per cent of the block's instructions; the halo recompute is not).
//  * Pass 1, thread (query-halo pixel, head): loads the query's q and g as
//    one vector each, recomputes its 9 logits and da from the shared k and
//    v, its softmax, log-sum-exp and delta, and keeps them in shared memory
//    (at head_dim 1 as one float32 record (q * scale * log2 e, g, lse,
//    delta); otherwise (lse, delta)): nothing of it goes to device memory.
//    A query inside the tile also gets dq, written out. The halo queries
//    (1.41x the tile) are recomputed by each neighbouring block, which
//    costs arithmetic, not bytes.
//  * Pass 2, thread (tile key, head): gathers dk and dv over the inverse
//    neighbourhood, the queries within +-2 whose clamped window covers the
//    key: at head_dim 1 from their records (one 16-byte shared load each,
//    no conversion), otherwise with their q and g read through L1. The
//    3 x 3 core (all of an interior key's queries) runs without branches on
//    fixed offsets, with its 9 rpb entries in registers; only keys within 2
//    of the border visit the outer ring. Each (query, key) pair adds its dl
//    to the d_rpb entry (key - query + 2) in the thread's 25 sums: a pair
//    is counted once, by the block that owns its key.
//  * The block's d_rpb partial: the threads' sums go to shared memory (over
//    the records and halos, which are done) and are added over the block's
//    pixel slots in a fixed order; nat_bwd_dbias_reduce then adds the
//    blocks' partials in a fixed order. No atomics anywhere, so two calls
//    with the same inputs give bitwise-equal dq, dk, dv and d_rpb.
//  * Registers are bounded for two 384-thread blocks an SM (80 a thread);
//    head_dim 2 to 8 and the generic variant spill a little under that
//    bound, which measured faster than one block an SM without spills.
//  * Any head_dim other than 1, 2, 4, 8 takes the generic variant in this
//    source: the same tiles and passes with (lse, delta) in shared memory,
//    one thread per (pixel, head) with a run-time head_dim, q, k, v and g
//    read through L1/L2 instead of staged.
// The launch plan (variant, tile, heads a block, threads, shared memory,
// copy unit, partials) comes from the caller (ops/nat_flat.py::nat_plan);
// the entry point computes its own (nat_common.cuh::make_plan) and refuses a
// plan that differs.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/nat_flat.py).

#include "nat_common.cuh"

namespace {

using namespace lmnet_nat;

constexpr int kReduceThreads = 256;  // a power of two

// Bit o + 2 (o in -2..2) is set where the query at offset o from key j, on
// an axis of n pixels, lies in the map and its clamped window covers j: the
// queries lo..hi, lo = 0 up to j = 2 and j - 1 after, hi = j + 1 up to
// j = n - 4 and n - 1 after.
__device__ __forceinline__ unsigned cover_mask(int j, int n) {
  const int lo = j <= 2 ? 0 : j - 1;
  const int hi = j >= n - 3 ? n - 1 : j + 1;
  return ((1u << (hi - lo + 1)) - 1u) << (lo - j + 2);
}

// <a, b> over a run-time head_dim n (the generic variant)
template <typename T>
__device__ __forceinline__ float dot_rt(const T* a, const T* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(to_f32(a[d]), to_f32(b[d]), s);
  return s;
}

// HD > 0: head_dim HD, halos staged in shared memory. HD == 0: the generic
// variant, head_dim hd_rt, read from device memory.
template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
nat_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ g, const float* __restrict__ rpb, T* __restrict__ dq,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part, int H, int W,
               int heads, int hd_rt, int nh, int rows, int cols, int ppb, int vb, float scale,
               float scale2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD > 0 ? HD : hd_rt;
  const int nchunk = cdiv(heads, nh);
  const int b = blockIdx.z / nchunk;
  const int h0 = (blockIdx.z - b * nchunk) * nh;
  const int nhb = min(nh, heads - h0);
  const int hl = threadIdx.x % nh;  // this thread's head: h0 + hl
  const int slot = threadIdx.x / nh;
  const bool live = hl < nhb;
  const int head = h0 + hl;
  const int C = heads * hd;
  const int ck = nh * hd;
  const int tr0 = blockIdx.y * rows;
  const int tc0 = blockIdx.x * cols;
  const int nr = min(rows, H - tr0);
  const int nc = min(cols, W - tc0);
  // the query halo: the tile +-2, inside the map
  const int qr0 = max(tr0 - 2, 0);
  const int qc0 = max(tc0 - 2, 0);
  const int nqr = min(tr0 + nr + 2, H) - qr0;
  const int nqc = min(tc0 + nc + 2, W) - qc0;
  const int qw = cols + 4;  // query-halo row, in pixels
  // the key halo: the windows of the query halo
  const int kr0 = window_start(qr0, H);
  const int kc0 = window_start(qc0, W);
  const int kw = cols + 6;
  const Layout L = layout(kBwd, HD > 0, rows, cols, nh, hd, sizeof(T), blockDim.x);
  // [query-halo pixel][head]: vec (q * scale2, g, lse, delta), generic (lse, delta)
  float* rec = reinterpret_cast<float*>(smem + L.stats);
  // a record's floats: q, g, lse, delta at head_dim 1; lse, delta
  // otherwise (q and g are then read through L1)
  constexpr int RS = HD == 1 ? 4 : 2;
  float* rp = reinterpret_cast<float*>(smem + L.rp);          // [head][25], times log2 e
  const T* ks = reinterpret_cast<const T*>(smem + L.kb);
  const T* vs = reinterpret_cast<const T*>(smem + L.vbuf);
  const int64_t img = (int64_t)b * H * W;

  if constexpr (HD > 0) {
    const int run = nhb * HD * (int)sizeof(T);
    const long long off = (img * C + (int64_t)h0 * HD) * (int64_t)sizeof(T);
    const long long ps = (long long)C * sizeof(T);
    const int dps = ck * (int)sizeof(T);
    const int nkr = min(nqr + 2, H - kr0);
    const int nkc = min(nqc + 2, W - kc0);
    copy_halo(smem + L.kb, reinterpret_cast<const unsigned char*>(k) + off, kr0, kc0, nkr, nkc,
              kw, W, ps, dps, run, vb);
    copy_halo(smem + L.vbuf, reinterpret_cast<const unsigned char*>(v) + off, kr0, kc0, nkr,
              nkc, kw, W, ps, dps, run, vb);
  }
  for (int i = threadIdx.x; i < 25 * nhb; i += blockDim.x) rp[i] = rpb[h0 * 25 + i] * kLog2e;
  cp_async_wait_all();
  __syncthreads();

  // where head `head` of query-halo pixel (lr, lc) starts in device
  // memory; where it starts for map pixel (row, col) in the key halo (vec)
  // or in device memory (generic)
  auto qat = [&](const T* gl, int lr, int lc) -> const T* {
    return gl + (img + (int64_t)(qr0 + lr) * W + qc0 + lc) * C + (int64_t)head * hd;
  };
  auto kat = [&](const T* sh, const T* gl, int row, int col) -> const T* {
    if constexpr (HD > 0) return sh + ((row - kr0) * kw + (col - kc0)) * ck + hl * HD;
    return gl + (img + (int64_t)row * W + col) * C + (int64_t)head * hd;
  };
  constexpr int N = HD > 0 ? HD : 1;
  const float* bias = rp + hl * 25;
  // the 3 x 3 core of the head's bias table, the entries of an interior
  // query's window (pass 1) and of an interior key's queries (pass 2)
  float bc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) bc[i] = bias[(i / 3 + 1) * 5 + i % 3 + 1];

  // pass 1: (lse, delta) of every query-halo pixel, and dq of the tile's
  // queries
  for (Walk w(slot, ppb, nqc); live && w.r < nqr; w.next()) {
    const int row = qr0 + w.r;
    const int col = qc0 + w.c;
    const int r0 = window_start(row, H);
    const int c0 = window_start(col, W);
    const int base = (2 - (row - r0)) * 5 + (2 - (col - c0));  // slot 0's entry
    const bool interior = base == 6;  // the window centred on the query
    const T* qp = qat(q, w.r, w.c);
    const T* gp = qat(g, w.r, w.c);
    float s[9], da[9];
    float qf[N], gf[N];
    constexpr int NK = HD > 0 && HD <= 2 ? HD : 1;  // head_dim 1, 2: the window's k kept for dq
    float kk[9][NK];
    if constexpr (HD > 0) {
      load_f32<N>(qp, qf);
      load_f32<N>(gp, gf);
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const T* kp = kat(ks, k, r0 + i / 3, c0 + i % 3);
      const T* vp = kat(vs, v, r0 + i / 3, c0 + i % 3);
      float sd, dd;
      if constexpr (HD > 0) {
        float kf[N], vf[N];
        load_f32<N>(kp, kf);
        load_f32<N>(vp, vf);
        if constexpr (HD <= 2) {
#pragma unroll
          for (int d = 0; d < N; ++d) kk[i][d] = kf[d];
        }
        sd = dd = 0.f;
#pragma unroll
        for (int d = 0; d < N; ++d) {
          sd = fmaf(qf[d], kf[d], sd);
          dd = fmaf(gf[d], vf[d], dd);
        }
      } else {
        sd = dot_rt(qp, kp, hd);
        dd = dot_rt(gp, vp, hd);
      }
      s[i] = fmaf(sd, scale2, interior ? bc[i] : bias[base + (i / 3) * 5 + i % 3]);
      da[i] = dd;
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
    float delta = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      s[i] *= inv;  // a_i
      delta = fmaf(s[i], da[i], delta);
    }
    float* r = rec + ((w.r * qw + w.c) * nh + hl) * RS;
    if constexpr (HD == 1) {
      *reinterpret_cast<float4*>(r) = make_float4(qf[0] * scale2, gf[0], m + __log2f(den), delta);
    } else {
      *reinterpret_cast<float2*>(r) = make_float2(m + __log2f(den), delta);
    }
    if (row >= tr0 && row < tr0 + nr && col >= tc0 && col < tc0 + nc) {
      T* dqp = dq + (img + (int64_t)row * W + col) * C + (int64_t)head * hd;
      if constexpr (HD > 0) {
        float o[N];
#pragma unroll
        for (int d = 0; d < N; ++d) o[d] = 0.f;
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          float kf[N];
          if constexpr (HD <= 2) {
#pragma unroll
            for (int d = 0; d < N; ++d) kf[d] = kk[i][d];
          } else {
            load_f32<N>(kat(ks, k, r0 + i / 3, c0 + i % 3), kf);
          }
          const float dl = s[i] * (da[i] - delta);
#pragma unroll
          for (int d = 0; d < N; ++d) o[d] = fmaf(dl, kf[d], o[d]);
        }
#pragma unroll
        for (int d = 0; d < N; ++d) o[d] *= scale;
        store_f32<N>(dqp, o);
      } else {
        for (int d = 0; d < hd; ++d) {
          float o = 0.f;
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            o = fmaf(s[i] * (da[i] - delta), to_f32(kat(ks, k, r0 + i / 3, c0 + i % 3)[d]), o);
          }
          dqp[d] = from_f32<T>(o * scale);
        }
      }
    }
  }
  __syncthreads();

  // pass 2: dk and dv of the tile's keys, over the queries whose window
  // covers them, and the d_rpb sums: the pair (query p, key j) adds its dl
  // to entry (j - p + 2) of the block that owns key j, so every (query,
  // slot) pair is counted once
  float acc[25];
#pragma unroll
  for (int e = 0; e < 25; ++e) acc[e] = 0.f;
  for (Walk w(slot, ppb, nc); live && w.r < nr; w.next()) {
    const int row = tr0 + w.r;
    const int col = tc0 + w.c;
    // bit o+2: the query row (column) at offset o covers the key's
    const unsigned rmask = cover_mask(row, H);
    const unsigned cmask = cover_mask(col, W);
    const T* kp = kat(ks, k, row, col);
    const T* vp = kat(vs, v, row, col);
    const int64_t ko = (img + (int64_t)row * W + col) * C + (int64_t)head * hd;
    if constexpr (HD > 0) {
      float kf[N], vf[N], sk[N], sv[N];
      load_f32<N>(kp, kf);
      load_f32<N>(vp, vf);
#pragma unroll
      for (int d = 0; d < N; ++d) sk[d] = sv[d] = 0.f;
      // the query at offset (dy, dx), query-halo pixel pi
      // (the record holds q scaled by scale2: dk is scaled by 1 / log2 e)
      auto visit = [&](int pi, int dy, int dx, float b) {
        const float* r = rec + (pi * nh + hl) * RS;
        float qf[N], gf[N], st[2];
        if constexpr (HD == 1) {
          const float4 x = *reinterpret_cast<const float4*>(r);
          qf[0] = x.x;
          gf[0] = x.y;
          st[0] = x.z;
          st[1] = x.w;
        } else {
          const int64_t qo = ko + ((int64_t)dy * W + dx) * C;  // the query's q and g
          load_f32<N>(q + qo, qf);
          load_f32<N>(g + qo, gf);
#pragma unroll
          for (int d = 0; d < N; ++d) qf[d] *= scale2;
          load_f32<2>(r, st);
        }
        float sd = b - st[0], dd = -st[1];
#pragma unroll
        for (int d = 0; d < N; ++d) {
          sd = fmaf(qf[d], kf[d], sd);
          dd = fmaf(gf[d], vf[d], dd);
        }
        const float ac = ex2(sd);
        const float dlc = ac * dd;
        acc[(2 - dy) * 5 + (2 - dx)] += dlc;
#pragma unroll
        for (int d = 0; d < N; ++d) {
          sk[d] = fmaf(dlc, qf[d], sk[d]);
          sv[d] = fmaf(ac, gf[d], sv[d]);
        }
      };
      const int p0 = (row - qr0) * qw + (col - qc0);  // the key's own pixel as a query
      if ((rmask & cmask & 0x0eu) == 0x0eu) {
        // the 3 x 3 core is whole (every key but those on the map's edge):
        // no branch, the offsets fixed
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          visit(p0 + (c / 3 - 1) * qw + (c % 3 - 1), c / 3 - 1, c % 3 - 1, bc[8 - c]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const int dy = c / 3 - 1;
          const int dx = c % 3 - 1;
          if ((rmask >> (dy + 2)) & (cmask >> (dx + 2)) & 1u) visit(p0 + dy * qw + dx, dy, dx, bc[8 - c]);
        }
      }
      if ((rmask | cmask) & 0x11u) {  // a key within 2 of the border: the ring
#pragma unroll
        for (int c = 0; c < 25; ++c) {
          const int dy = c / 5 - 2;
          const int dx = c % 5 - 2;
          if ((dy == -2 || dy == 2 || dx == -2 || dx == 2) &&
              ((rmask >> (dy + 2)) & (cmask >> (dx + 2)) & 1u)) {
            visit(p0 + dy * qw + dx, dy, dx, bias[(2 - dy) * 5 + (2 - dx)]);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < N; ++d) sk[d] *= 1.f / kLog2e;
      store_f32<N>(dk + ko, sk);
      store_f32<N>(dv + ko, sv);
    } else {
      float a[25], dl[25];
#pragma unroll
      for (int c = 0; c < 25; ++c) {
        const int dy = c / 5 - 2;
        const int dx = c % 5 - 2;
        a[c] = dl[c] = 0.f;
        if (!((rmask >> (dy + 2)) & (cmask >> (dx + 2)) & 1u)) continue;
        const int lr = row + dy - qr0;
        const int lc = col + dx - qc0;
        const float2 st = *reinterpret_cast<const float2*>(rec + (lr * qw + lc) * nh * RS + hl * RS);
        const float sd = dot_rt(qat(q, lr, lc), kp, hd);
        const float dd = dot_rt(qat(g, lr, lc), vp, hd);
        a[c] = ex2(fmaf(sd, scale2, bias[(2 - dy) * 5 + (2 - dx)]) - st.x);
        dl[c] = a[c] * (dd - st.y);
        acc[(2 - dy) * 5 + (2 - dx)] += dl[c];
      }
      for (int d = 0; d < hd; ++d) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int c = 0; c < 25; ++c) {
          const int dy = c / 5 - 2;
          const int dx = c % 5 - 2;
          if (!((rmask >> (dy + 2)) & (cmask >> (dx + 2)) & 1u)) continue;
          const int lr = row + dy - qr0;
          const int lc = col + dx - qc0;
          s1 = fmaf(dl[c], to_f32(qat(q, lr, lc)[d]), s1);
          s2 = fmaf(a[c], to_f32(qat(g, lr, lc)[d]), s2);
        }
        dk[ko + d] = from_f32<T>(s1 * scale);
        dv[ko + d] = from_f32<T>(s2);
      }
    }
  }
  __syncthreads();  // the halos are done: their space takes the d_rpb sums

  // the block's d_rpb partial: per head, the pixel slots' sums in order
  float* red = reinterpret_cast<float*>(smem + L.red);  // [entry][thread]
#pragma unroll
  for (int e = 0; e < 25; ++e) red[e * blockDim.x + threadIdx.x] = acc[e];
  __syncthreads();
  float* out = part + ((int64_t)(b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * heads * 25;
  for (int t = threadIdx.x; t < nhb * 25; t += blockDim.x) {
    const int h = t / 25;
    const int e = t - h * 25;
    float s = 0.f;
    for (int sl = 0; sl < ppb; ++sl) s += red[e * blockDim.x + sl * nh + h];
    out[(h0 + h) * 25 + e] = s;
  }
}

// One block per d_rpb entry e: the partials of all tiles, strided over the
// threads, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
nat_bwd_dbias_reduce(const float* __restrict__ part, float* __restrict__ drpb, int ntiles, int n) {
  __shared__ float red[kReduceThreads];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int t = tid; t < ntiles; t += kReduceThreads) s += part[(int64_t)t * n + e];
  red[tid] = s;
  __syncthreads();
  for (int st = kReduceThreads / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) drpb[e] = red[0];
}

template <typename T, int HD>
int launch_one(const void* q, const void* k, const void* v, const void* g, const float* rpb,
               void* dq, void* dk, void* dv, float* part, int H, int W, int heads, int hd,
               const Plan& p, float scale, cudaStream_t stream) {
  static bool attr_set = false;  // raise the kernel's shared-memory ceiling once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(nat_bwd_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  nat_bwd_kernel<T, HD><<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), rpb, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), part, H, W, heads, hd, p.nh, p.rows, p.cols, p.ppb, p.vb, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, const float* rpb,
           void* dq, void* dk, void* dv, float* drpb, float* part, int B, int H, int W,
           int heads, int hd, const Plan& p, float scale, cudaStream_t stream) {
  int err;
  switch (p.vec ? hd : 0) {
    case 1: err = launch_one<T, 1>(q, k, v, g, rpb, dq, dk, dv, part, H, W, heads, hd, p, scale, stream); break;
    case 2: err = launch_one<T, 2>(q, k, v, g, rpb, dq, dk, dv, part, H, W, heads, hd, p, scale, stream); break;
    case 4: err = launch_one<T, 4>(q, k, v, g, rpb, dq, dk, dv, part, H, W, heads, hd, p, scale, stream); break;
    case 8: err = launch_one<T, 8>(q, k, v, g, rpb, dq, dk, dv, part, H, W, heads, hd, p, scale, stream); break;
    default: err = launch_one<T, 0>(q, k, v, g, rpb, dq, dk, dv, part, H, W, heads, hd, p, scale, stream);
  }
  if (err != cudaSuccess) return err;
  nat_bwd_dbias_reduce<<<heads * 25, kReduceThreads, 0, stream>>>(part, drpb, B * p.gx * p.gy,
                                                                   heads * 25);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk and dv share it; all
// 16-byte aligned); rpb and drpb are float32 (heads, 5, 5); part is float32
// scratch of `workspace` values. All contiguous. The plan (variant 1 = vec /
// 0 = generic, tile rows and columns, heads a block, threads, shared-memory
// bytes, copy unit, workspace) must equal the kernel's own for this shape.
// Returns the first CUDA error of the two launches: 0 on success;
// cudaErrorInvalidValue for a shape or plan it does not take.
extern "C" int lmnet_nat_bwd(const void* q, const void* k, const void* v, const void* g,
                             const void* rpb, void* dq, void* dk, void* dv, void* drpb,
                             void* part, int B, int H, int W, int heads, int hd, float scale,
                             int dtype, int vec, int rows, int cols, int nh, int threads,
                             long long smem, int vb, long long workspace, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(kBwd, B, H, W, heads, hd, dtype == 0 ? 4 : 2, &p)) return (int)cudaErrorInvalidValue;
  if (vec != p.vec || rows != p.rows || cols != p.cols || nh != p.nh || threads != p.threads ||
      smem != p.smem || vb != p.vb || workspace != p.workspace) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rpb);
  float* dr = static_cast<float*>(drpb);
  float* pt = static_cast<float*>(part);
  if (dtype == 0) {
    return launch<float>(q, k, v, g, r, dq, dk, dv, dr, pt, B, H, W, heads, hd, p, scale, s);
  }
  return launch<__nv_bfloat16>(q, k, v, g, r, dq, dk, dv, dr, pt, B, H, W, heads, hd, p, scale, s);
}

// The kernel's own plan for this shape (nat_common.cuh::export_plan: 14
// numbers into out), for the tests that hold ops/nat_flat.py::nat_plan to it.
extern "C" void lmnet_nat_bwd_plan(int B, int H, int W, int heads, int hd, int dtype,
                                   long long* out) {
  export_plan(kBwd, B, H, W, heads, hd, dtype == 0 ? 4 : 2, out);
}
