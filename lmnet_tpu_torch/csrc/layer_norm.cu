// LayerNorm over the last axis of a tensor viewed as (N, C) rows, C
// innermost: the forward and its backward, as flax's nn.LayerNorm computes
// them (models/blocks.py::LayerNorm).
//
// Replaces no TPU kernel: JAX leaves LayerNorm to XLA, which fuses it into
// the passes around it. It was added because the port's stock float32
// composition (x.float(), two means, the scale rsqrt(var) * weight as a full
// (N, C) float32 tensor, the cast back, and autograd's ~14 ops through all
// of it) moved ~58 bytes an element forward and ~110 backward, ~15x the
// compulsory bytes, over SegFormer-B5's 161 LayerNorms a forward, and saved
// float32 activations for the backward.
//
//   forward:  mean = sum x / C, var = max(sum x^2 / C - mean^2, 0) (flax's
//             E[x^2] - E[x]^2), rstd = rsqrt(var + eps), all in float32;
//             y = (x - mean) (rstd w) + b in float32, rounded once to x's
//             dtype; mean and rstd kept a row, rstd's sign bit set where
//             the clamp held (so that the backward drops the variance's
//             term there, as autograd of the clamp does);
//   backward: xhat = (x - mean) rstd, g = dy w,
//             dx = rstd (g - mean(g) - xhat mean(g xhat)) (the last term
//             0 where the clamp held), in float32, rounded once;
//             dw = sum over rows of dy xhat, db = sum of dy, in float32.
//
// What bounds it on an H100: bytes. A forward reads x and writes y, a
// backward reads dy and x and writes dx: 4 and 6 bytes an element in bf16,
// at 3.35 TB/s, with a handful of float32 operations an element. The design:
//
// - One pass each way. A group of lanes holds a whole row in registers:
//   16-byte vectors where 16 bytes of elements divide C, else 8-byte ones
//   where 8 bytes do, else single elements; lanes a row = the vectors a row
//   rounded up to a power of two, at most 32, doubled (up to the block's
//   256) while a lane would hold more than 16 float32 values (the register
//   budget); k = vectors a lane. So C = 12 or 64 packs 8 or 4 rows into a
//   warp, C = 512 spreads a row over one, C = 744 over two and C = 4096 (the
//   widest) over the block. The row's two sums go through a butterfly of
//   shuffles inside a warp, then, for a group wider than a warp, through
//   shared memory in warp order: every lane gets the same bits.
// - The forward takes one row a group and a block of 256 threads, as many
//   blocks as rows need; the backward runs persistent blocks (as many as fit
//   on the card at once) that walk the rows, each lane summing dy xhat and
//   dy for its own columns in registers; at the end the block adds its
//   groups' sums in a fixed order into per-block float32 partials
//   [2][blocks][C], and ln_rows_bwd_reduce adds those in a fixed order. No
//   atomics, so two calls give bitwise-equal results.
// - Nothing of the activation's size in float32 is written or kept: the
//   caller saves x in its own dtype and the two row vectors.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/layer_norm.py).

#include "rc_common.cuh"

namespace {

using lmnet_rc::from_f32;
using lmnet_rc::to_f32;

constexpr int kThreads = 256;                    // a block
constexpr int kLaneValues = 16;                  // float32 values of a row a lane holds, at most
constexpr int kMaxC = kThreads * kLaneValues;    // 4096 (ops/layer_norm.py's MAX_C)
constexpr int kReduceWarps = 8;

struct Plan {
  int vw;     // elements a vector: 16 bytes, 8 bytes or one element
  int lanes;  // lanes a row: a power of two, 1 .. kThreads
  int k;      // vectors a lane, the last ones of a row maybe absent
  int rows;   // rows a block takes at a time: kThreads / lanes
};

bool make_plan(int C, int dtype, Plan& p) {
  if ((dtype != 0 && dtype != 1) || C <= 0 || C > kMaxC) return false;
  const int esize = dtype == 0 ? 4 : 2;
  p.vw = C % (16 / esize) == 0 ? 16 / esize : dtype == 1 && C % 4 == 0 ? 4 : 1;
  const int nv = C / p.vw;
  p.lanes = 1;
  while (p.lanes < nv && p.lanes < 32) p.lanes *= 2;
  p.k = (nv + p.lanes - 1) / p.lanes;
  while (p.k * p.vw > kLaneValues && p.lanes < kThreads) {
    p.lanes *= 2;
    p.k = (nv + p.lanes - 1) / p.lanes;
  }
  p.rows = kThreads / p.lanes;
  return p.k * p.vw <= kLaneValues;
}

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec {
  T v[VW];
};

// Row `row`'s vectors of this lane into v[K][VW] as float32; zero where the
// row or the vector is absent.
template <typename T, int VW, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ src, long long row, bool live,
                                         int C, int lane, int lanes, float (&v)[K][VW]) {
  using V = Vec<T, VW>;
  const int nv = C / VW;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int vi = k * lanes + lane;
    if (live && vi < nv) {
      const V a = *reinterpret_cast<const V*>(src + row * C + vi * VW);
#pragma unroll
      for (int j = 0; j < VW; ++j) v[k][j] = to_f32(a.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) v[k][j] = 0.f;
    }
  }
}

// v[K][VW] rounded to T into row `row`'s vectors of this lane.
template <typename T, int VW, int K>
__device__ __forceinline__ void store_row(T* __restrict__ dst, long long row, int C, int lane,
                                          int lanes, const float (&v)[K][VW]) {
  const int nv = C / VW;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int vi = k * lanes + lane;
    if (vi < nv) {
      Vec<T, VW> a;
#pragma unroll
      for (int j = 0; j < VW; ++j) a.v[j] = from_f32<T>(v[k][j]);
      *reinterpret_cast<Vec<T, VW>*>(dst + row * C + vi * VW) = a;
    }
  }
}

// The float32 values of this lane's columns of a (C,) vector; zero past C.
template <int VW, int K>
__device__ __forceinline__ void load_cols(const float* __restrict__ src, int C, int lane,
                                          int lanes, float (&v)[K][VW]) {
  const int nv = C / VW;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int vi = k * lanes + lane;
#pragma unroll
    for (int j = 0; j < VW; ++j) v[k][j] = vi < nv ? src[vi * VW + j] : 0.f;
  }
}

// The sum of a over the group's lanes, the same bits in each: a butterfly
// of xor shuffles inside a warp (lanes is a power of two, so each stays in
// its group; a + b and b + a are the same float); a group wider than a warp
// then adds its warps' sums from `warp_sums` (kThreads / 32 floats of shared
// memory) in warp order. Every thread of the block calls it alike: it waits
// at the block's barriers there.
__device__ __forceinline__ float group_sum(float a, int lanes, float* warp_sums) {
  for (int o = (lanes < 32 ? lanes : 32) >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
  }
  if (lanes <= 32) return a;
  __syncthreads();  // the last call's readers are done
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = a;
  __syncthreads();
  const int warps = lanes >> 5;
  const float* w = warp_sums + (threadIdx.x / lanes) * warps;
  a = 0.f;
  for (int i = 0; i < warps; ++i) a += w[i];
  return a;
}

template <typename T, int VW, int K>
__global__ void __launch_bounds__(kThreads)
ln_rows_fwd(const T* __restrict__ x, const float* __restrict__ weight,
            const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mean_out,
            float* __restrict__ rstd_out, long long N, int C, int lanes, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & (lanes - 1);
  const long long row = (long long)blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const bool live = row < N;
  float v[K][VW];
  load_row<T, VW, K>(x, row, live, C, lane, lanes, v);
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      s += v[k][j];
      q = fmaf(v[k][j], v[k][j], q);
    }
  }
  s = group_sum(s, lanes, warp_sums);
  q = group_sum(q, lanes, warp_sums);
  if (!live) return;  // past the shuffles and barriers: the whole group leaves
  const float mean = s / C;
  // no contraction: mean^2 rounded, then the difference, as the composition
  const float var = __fsub_rn(q / C, __fmul_rn(mean, mean));
  const bool clamped = var < 0.f;
  const float rstd = rsqrtf(__fadd_rn(clamped ? 0.f : var, eps));
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = clamped ? -rstd : rstd;
  }
  float w[K][VW], b[K][VW];
  load_cols<VW, K>(weight, C, lane, lanes, w);
  load_cols<VW, K>(bias, C, lane, lanes, b);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      v[k][j] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][j], mean), __fmul_rn(rstd, w[k][j])),
                          b[k][j]);
    }
  }
  store_row<T, VW, K>(y, row, C, lane, lanes, v);
}

template <typename T, int VW, int K>
__global__ void __launch_bounds__(kThreads)
ln_rows_bwd(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ weight,
            const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
            float* __restrict__ part, long long N, int C, int lanes) {
  __shared__ float red[2][kThreads * kLaneValues];  // [statistic][group][column]
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & (lanes - 1);
  const int grp = threadIdx.x / lanes;
  const int rows = kThreads / lanes;
  const float inv_c = 1.f / C;
  float w[K][VW], adw[K][VW], adb[K][VW];
  load_cols<VW, K>(weight, C, lane, lanes, w);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) adw[k][j] = adb[k][j] = 0.f;
  }
  // every group of the block takes the same turns, so the shuffles see all
  // lanes and every thread reaches group_sum's barriers
  for (long long base = (long long)blockIdx.x * rows; base < N;
       base += (long long)gridDim.x * rows) {
    const long long row = base + grp;
    const bool live = row < N;
    float d[K][VW], v[K][VW];
    load_row<T, VW, K>(dy, row, live, C, lane, lanes, d);
    load_row<T, VW, K>(x, row, live, C, lane, lanes, v);
    const float m = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    const float r = fabsf(rs);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        // dy is 0 on an absent row or column: nothing is added there
        const float xh = (v[k][j] - m) * r;
        const float g = d[k][j] * w[k][j];
        adw[k][j] = fmaf(d[k][j], xh, adw[k][j]);
        adb[k][j] += d[k][j];
        sg += g;
        sgx = fmaf(g, xh, sgx);
        v[k][j] = xh;
        d[k][j] = g;
      }
    }
    sg = group_sum(sg, lanes, warp_sums);
    sgx = group_sum(sgx, lanes, warp_sums);
    if (live && dx != nullptr) {
      const float mg = sg * inv_c;
      const float mgx = signbit(rs) ? 0.f : sgx * inv_c;
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < VW; ++j) v[k][j] = r * (d[k][j] - mg - v[k][j] * mgx);
      }
      store_row<T, VW, K>(dx, row, C, lane, lanes, v);
    }
  }
  // the block's partials: its groups' column sums added in group order
  const int nv = C / VW;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int vi = k * lanes + lane;
    if (vi < nv) {
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        red[0][grp * C + vi * VW + j] = adw[k][j];
        red[1][grp * C + vi * VW + j] = adb[k][j];
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    const int st = o / C;
    const int c = o - st * C;
    float a = 0.f;
    for (int gr = 0; gr < rows; ++gr) a += red[st][gr * C + c];
    part[((long long)st * gridDim.x + blockIdx.x) * C + c] = a;
  }
}

// grads (2, C): part[st][0 .. nblocks)[c] summed for each output o = st C +
// c, 32 outputs a block, its warps taking every kReduceWarps-th block's
// partial, then added in warp order.
__global__ void __launch_bounds__(32 * kReduceWarps)
ln_rows_bwd_reduce(const float* __restrict__ part, float* __restrict__ grads, int nblocks,
                   int C) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (o < 2 * C) {
    const int st = o / C;
    const int c = o - st * C;
    for (int b = wid; b < nblocks; b += kReduceWarps) {
      a += part[((long long)st * nblocks + b) * C + c];
    }
  }
  red[wid][lane] = a;
  __syncthreads();
  if (wid == 0 && o < 2 * C) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) s += red[i][lane];
    grads[o] = s;
  }
}

template <typename T, int V, int K>
struct Tag {
  using type = T;
  static constexpr int vw = V;
  static constexpr int k = K;
};

// f(Tag<T, 1, K>{}) for the smallest K of 1, 2, 4, 8, 16 that holds k
// single elements a lane (the absent ones are skipped)
template <typename T, typename F>
int dispatch_scalar(int k, F f) {
  if (k <= 1) return f(Tag<T, 1, 1>{});
  if (k <= 2) return f(Tag<T, 1, 2>{});
  if (k <= 4) return f(Tag<T, 1, 4>{});
  if (k <= 8) return f(Tag<T, 1, 8>{});
  return f(Tag<T, 1, 16>{});
}

// f(Tag<T, vw, k>{}) for the dtype (0 = float32, 1 = bfloat16) and the plan
template <typename F>
int dispatch(int dtype, const Plan& p, F f) {
  if (p.vw == 1) {
    return dtype == 1 ? dispatch_scalar<__nv_bfloat16>(p.k, f) : dispatch_scalar<float>(p.k, f);
  }
  if (dtype == 1 && p.vw == 8) {
    if (p.k == 1) return f(Tag<__nv_bfloat16, 8, 1>{});
    if (p.k == 2) return f(Tag<__nv_bfloat16, 8, 2>{});
  } else if (dtype == 1 && p.vw == 4) {
    if (p.k == 1) return f(Tag<__nv_bfloat16, 4, 1>{});
    if (p.k == 2) return f(Tag<__nv_bfloat16, 4, 2>{});
    if (p.k == 3) return f(Tag<__nv_bfloat16, 4, 3>{});
    if (p.k == 4) return f(Tag<__nv_bfloat16, 4, 4>{});
  } else if (dtype == 0 && p.vw == 4) {
    if (p.k == 1) return f(Tag<float, 4, 1>{});
    if (p.k == 2) return f(Tag<float, 4, 2>{});
    if (p.k == 3) return f(Tag<float, 4, 3>{});
    if (p.k == 4) return f(Tag<float, 4, 4>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The backward's persistent blocks: as many as fit on the card at once,
// fewer where the rows need fewer. A function of the card, C, the dtype and
// N alone, so two calls on one card sum in the same order.
int bwd_grid(long long N, int C, int dtype, const Plan& p, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  err = dispatch(dtype, p, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_rows_bwd<T, decltype(tag)::vw, decltype(tag)::k>, kThreads, 0);
  });
  if (err != 0) return err;
  const long long tiles = (N + p.rows - 1) / p.rows;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  grid = (int)(tiles < most ? tiles : most);
  return 0;
}

}  // namespace

// The entry points. x, dy, y, dx: (N, C) rows, C innermost, contiguous, of
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned; weight, bias, mean,
// rstd, part and grads float32 and contiguous, weight and bias 16-byte
// aligned. Each returns the first CUDA error of its launches: 0 on success,
// cudaErrorInvalidValue for a shape it does not take (C < 1, C > 4096,
// N < 1).

// The backward's persistent blocks for (N, C, dtype) on the current card,
// the grid the caller passes to lmnet_ln_rows_bwd (any grid >= 1 computes the
// same sums; one grid for a shape keeps their order, and so their bits).
extern "C" int lmnet_ln_rows_bwd_grid(long long N, int C, int dtype, int* grid) {
  Plan p;
  if (N <= 0 || !make_plan(C, dtype, p)) return (int)cudaErrorInvalidValue;
  return bwd_grid(N, C, dtype, p, *grid);
}

// y (N, C) in x's dtype, mean and rstd (N,) float32 (rstd negated where the
// variance was clamped at 0).
extern "C" int lmnet_ln_rows_fwd(const void* x, const void* weight, const void* bias, void* y,
                                 void* mean, void* rstd, long long N, int C, int dtype,
                                 float eps, void* stream) {
  Plan p;
  if (N <= 0 || !make_plan(C, dtype, p)) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + p.rows - 1) / p.rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, p, [&](auto tag) {
    using T = typename decltype(tag)::type;
    ln_rows_fwd<T, decltype(tag)::vw, decltype(tag)::k><<<(int)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(mean),
        static_cast<float*>(rstd), N, C, p.lanes, eps);
    return (int)cudaGetLastError();
  });
}

// dx (N, C) in x's dtype (not written where dx is null) and grads (2, C)
// float32: sum dy xhat (dweight), sum dy (dbias), from the forward's mean
// and rstd; part: scratch of 2 x grid x C floats, grid >= 1 (as
// lmnet_ln_rows_bwd_grid gives it for the same (N, C, dtype)).
extern "C" int lmnet_ln_rows_bwd(const void* dy, const void* x, const void* weight,
                                 const void* mean, const void* rstd, void* dx, void* part,
                                 int grid, void* grads, long long N, int C, int dtype,
                                 void* stream) {
  Plan p;
  if (N <= 0 || grid < 1 || !make_plan(C, dtype, p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  const int err = dispatch(dtype, p, [&](auto tag) {
    using T = typename decltype(tag)::type;
    ln_rows_bwd<T, decltype(tag)::vw, decltype(tag)::k><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(weight),
        static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
        pt, N, C, p.lanes);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  ln_rows_bwd_reduce<<<(2 * C + 31) / 32, 32 * kReduceWarps, 0, s>>>(
      pt, static_cast<float*>(grads), grid, C);
  return (int)cudaGetLastError();
}
