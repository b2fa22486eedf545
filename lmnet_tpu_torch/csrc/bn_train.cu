// Train-mode BatchNorm over the channel axis of an NHWC tensor, viewed as
// (N, C) rows with C innermost: the batch statistics, the normalisation, and
// the backward of both.
//
// Replaces no TPU kernel: JAX leaves BatchNorm to XLA, which fuses it into
// the passes around it. It was added because the port's stock float32
// composition (moments of x.float(), then ((x - mean) * inv + bias).to(x's
// dtype), and autograd of that) moved ~50 bytes an element forward and ~122
// backward, ~10x the compulsory bytes, over the 84 BatchNorms of a training
// forward (80 of them on the widest maps of the model, run again in rc_remat's
// recompute).
//
//   forward:  sums  = (sum x, sum x^2) per channel (float32 a thread,
//             float64 past it);
//             mean  = sum x / n, var = max(sum x^2 / n - mean^2, 0) (flax's
//             E[x^2] - E[x]^2, as parallel/batch.py::moments), rstd =
//             rsqrt(var + eps), formed in float64 and kept in float32;
//             y     = (x - mean) * (rstd * gamma) + beta, in float32,
//             rounded once to x's dtype;
//   backward: (sum dy, sum dy * xhat) per channel, xhat = (x - mean) rstd:
//             dbeta and dgamma, in float32;
//             dx    = gamma rstd (dy - sum dy / n - xhat sum(dy xhat) / n).
//
// n is the count over the global batch: inside a data-parallel step the
// caller all-reduces the per-channel sums between the statistics and the
// apply, forward and backward (ops/bn_train.py).
//
// What bounds it on an H100: bytes. A forward reads x for the statistics,
// then reads x and writes y; a backward reads dy and x for its two sums,
// then reads dy and x and writes dx: 6 and 10 bytes an element in bf16, at
// 3.35 TB/s, with a handful of float32 operations an element. The design
// keeps every pass a stream of 16-byte loads and stores and nothing else:
//
// - A period of lcm(vw, C) elements (vw = 16 bytes' worth: 8 bf16 or 4
//   float32) is ct = period / vw = C / gcd(vw, C) vectors, 256 at most (every
//   C up to 256 takes them; the model's are 12 .. 192). Thread (r, cv) of a
//   block of rt x ct threads takes vector cv of periods r, r + rt * grid,
//   ... so each lane j of its vectors keeps one channel, (cv vw + j) mod C,
//   for the whole pass: its sums and its scale and shift stay in registers. C = 12 and 24 take
//   periods of 24 elements (3 vectors), C = 48, 96, 192 periods of C. A
//   block's threads read one contiguous run of rt * period elements.
// - Each thread loads four vectors before it uses any, so that enough bytes
//   are in flight to cover the latency of device memory. The statistics
//   kernels run persistent blocks, 4 an SM (one wave), which walk the
//   periods, so that the partial sums are few; the apply kernels, which keep
//   none, a block for each four blocks' worth of periods (apply_grid).
// - The sums: each thread's lanes in float32, then its block's rows in a
//   fixed split and order through shared memory, give one partial per
//   (statistic, channel) and block, [2 C][grid]; bn_train_reduce adds each
//   output's partials, a warp an output, lanes strided, in a fixed shuffle
//   tree. No atomics, so two calls give bitwise-equal results. Every sum
//   past a thread's own is float64, and so are the (2, C) sums the caller
//   all-reduces and the per-channel constants formed from them: var =
//   E[x^2] - E[x]^2 cancels where E[x^2] >> var, and float32 partials then
//   left a data-parallel step's statistics ~1e-3 (relative) from one
//   process's on the same global batch, where the float32 composition's
//   order of summation had kept the two ~1e-5 apart.
// - The apply kernels form the per-channel constants from the sums in their
//   prologue (each block for itself; block 0 writes mean, var and rstd for
//   the caller and the backward), so a forward is three launches and a
//   backward three, with no float32 tensor of the activation's size.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/bn_train.py).

#include "rc_common.cuh"

namespace {

using lmnet_rc::from_f32;
using lmnet_rc::to_f32;

constexpr int kMaxC = 1024;         // channels at most
constexpr int kPeriodVectors = 256; // vectors a period, and threads a block, at most
                                    // (ops/bn_train.py's PERIOD_VECTORS)
constexpr int kBlocksPerSm = 4;     // persistent blocks an SM (ops/bn_train.py's BLOCKS_PER_SM)
constexpr int kUnroll = 4;          // vectors a thread loads before it uses them
constexpr int kReduceWarps = 8;

int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

struct Geometry {
  int vw;              // elements a vector
  int ct;              // vectors a period
  int rt;              // periods a block takes at a time
  int r0;              // rows a period
  int threads;         // rt * ct
  int grid;            // blocks of the statistics kernels (persistent)
  long long period;    // lcm(vw, C) elements
  long long nper;      // periods over the tensor, the last maybe partial
  long long tiles;     // blocks' worth of periods: nper / rt, rounded up
};

bool geometry(long long N, int C, int esize, int sms, Geometry& g) {
  if (N <= 0 || C <= 0 || C > kMaxC || sms <= 0 || (esize != 2 && esize != 4)) return false;
  g.vw = 16 / esize;
  const int d = gcd_int(g.vw, C);
  if (C / d > kPeriodVectors) return false;
  g.ct = C / d;
  g.r0 = g.vw / d;
  g.period = (long long)g.ct * g.vw;
  g.rt = kPeriodVectors / g.ct;
  g.threads = g.rt * g.ct;
  g.nper = (N + g.r0 - 1) / g.r0;
  g.tiles = (g.nper + g.rt - 1) / g.rt;
  g.grid = (int)(g.tiles < (long long)kBlocksPerSm * sms ? g.tiles : (long long)kBlocksPerSm * sms);
  return true;
}

// The apply kernels keep no partials: a block a group of kUnroll tiles, so
// that finished blocks make room for new ones as in a plain elementwise
// kernel (persistent blocks, each storing its four vectors before it loads
// the next four, left the memory system idle between: 2.36-2.49 TB/s against
// 2.81-3.02 for a copy at the train cell's shapes).
int apply_grid(const Geometry& g) {
  const long long blocks = (g.tiles + kUnroll - 1) / kUnroll;
  return (int)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
}

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec {
  T v[VW];
};

// The thread's vectors of NIN tensors of E elements (all of one layout):
// body(element offset, the NIN vectors, valid lanes) for each, the vectors
// of whole periods in groups of kUnroll loaded before any is used; lanes
// past the tensor's end (in the last, partial period) read zero.
template <typename T, int VW, int NIN, typename Body>
__device__ __forceinline__ void stream(const T* const (&in)[NIN], long long E,
                                       const Geometry& g, Body body) {
  using V = Vec<T, VW>;
  const int r = threadIdx.x / g.ct;
  const long long off = (long long)(threadIdx.x - r * g.ct) * VW;
  const long long step = (long long)gridDim.x * g.rt;
  const long long nfull = E / g.period;
  long long s = (long long)blockIdx.x * g.rt + r;
  for (; s + (kUnroll - 1) * step < nfull; s += kUnroll * step) {
    V v[kUnroll][NIN];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < NIN; ++i) {
        v[u][i] = *reinterpret_cast<const V*>(in[i] + (s + u * step) * g.period + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) body((s + u * step) * g.period + off, v[u], VW);
  }
  for (; s < nfull; s += step) {
    V v[NIN];
#pragma unroll
    for (int i = 0; i < NIN; ++i) v[i] = *reinterpret_cast<const V*>(in[i] + s * g.period + off);
    body(s * g.period + off, v, VW);
  }
  if (s == nfull) {  // the partial period, where this thread's walk reaches it
    const long long e0 = s * g.period + off;
    const long long left = E - e0;
    if (left > 0) {
      const int nv = left < VW ? (int)left : VW;
      V v[NIN];
#pragma unroll
      for (int i = 0; i < NIN; ++i) {
#pragma unroll
        for (int j = 0; j < VW; ++j) v[i].v[j] = j < nv ? in[i][e0 + j] : from_f32<T>(0.f);
      }
      body(e0, v, nv);
    }
  }
}

// Store lanes 0 .. nv - 1 of y at out + e: one vector store for a whole one.
template <typename T, int VW>
__device__ __forceinline__ void store(T* out, long long e, const Vec<T, VW>& y, int nv) {
  if (nv == VW) {
    *reinterpret_cast<Vec<T, VW>*>(out + e) = y;
  } else {
    for (int j = 0; j < nv; ++j) out[e + j] = y.v[j];
  }
}

// The thread's lane sums a[], b[] -> its block's 2 C partials, part[o][grid]
// with o = statistic * C + channel, in float64: the lanes and rows of each
// channel added in a fixed order, the block's rows in nsplit fixed runs
// first.
template <int VW>
__device__ __forceinline__ void block_partials(const float (&a)[VW], const float (&b)[VW],
                                               double* __restrict__ part, int C,
                                               const Geometry& g) {
  __shared__ float red[2 * 2048];  // [statistic][thread][lane]: 2 x 256 x 8 at most
  __shared__ double mid[2048];     // [output][split]
  const int tid = threadIdx.x;
  const int T = g.threads;
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    red[tid * VW + j] = a[j];
    red[(T + tid) * VW + j] = b[j];
  }
  __syncthreads();
  const int nout = 2 * C;
  const int nsplit = T / nout > 1 ? T / nout : 1;
  for (int i = tid; i < nout * nsplit; i += T) {
    const int o = i / nsplit;
    const int sp = i - o * nsplit;
    const int st = o / C;
    const int c = o - st * C;
    const int lo = sp * g.rt / nsplit;
    const int hi = (sp + 1) * g.rt / nsplit;
    // thread rr * ct + cv keeps element cv * VW + j of its period at
    // red[st][rr * period + cv * VW + j]; channel c is element k C + c
    const float* base = red + (long long)st * T * VW + c;
    double acc = 0.0;
    for (int rr = lo; rr < hi; ++rr) {
      for (int k = 0; k < g.r0; ++k) acc += base[rr * g.period + k * C];
    }
    mid[i] = acc;
  }
  __syncthreads();
  for (int o = tid; o < nout; o += T) {
    double acc = 0.0;
    for (int sp = 0; sp < nsplit; ++sp) acc += mid[o * nsplit + sp];
    part[(long long)o * gridDim.x + blockIdx.x] = acc;
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(kPeriodVectors)
bn_train_stats(const T* __restrict__ x, double* __restrict__ part, long long E, int C,
               Geometry g) {
  float s[VW], q[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) s[j] = q[j] = 0.f;
  const T* in[1] = {x};
  stream<T, VW, 1>(in, E, g, [&](long long, const Vec<T, VW>(&v)[1], int) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float a = to_f32(v[0].v[j]);
      s[j] += a;
      q[j] = fmaf(a, a, q[j]);
    }
  });
  block_partials<VW>(s, q, part, C, g);
}

template <typename T, int VW>
__global__ void __launch_bounds__(kPeriodVectors)
bn_train_bwd_stats(const T* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ stats, double* __restrict__ part, long long E,
                   int C, Geometry g) {
  const int off = (threadIdx.x % g.ct) * VW;
  float m[VW], s[VW], q[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    m[j] = stats[(off + j) % C];
    s[j] = q[j] = 0.f;
  }
  const T* in[2] = {dy, x};
  stream<T, VW, 2>(in, E, g, [&](long long, const Vec<T, VW>(&v)[2], int nv) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float d = to_f32(v[0].v[j]);
      // a lane past the end reads dy = 0 and x = 0; x - mean must add 0 there
      const float xc = j < nv ? to_f32(v[1].v[j]) - m[j] : 0.f;
      s[j] += d;
      q[j] = fmaf(d, xc, q[j]);
    }
  });
  block_partials<VW>(s, q, part, C, g);
}

// One warp an output o < nout: out[o] = the sum of part[o][0 .. n), lanes
// strided, then a fixed shuffle tree, in float64; with scale, out[C + c] is
// multiplied by scale[c] (the backward's sum of dy (x - mean) by rstd: sum dy
// xhat); with out_f, a float32 copy there too.
__global__ void __launch_bounds__(32 * kReduceWarps)
bn_train_reduce(const double* __restrict__ part, double* __restrict__ out,
                float* __restrict__ out_f, int nout, int n, int C,
                const float* __restrict__ scale) {
  const int o = blockIdx.x * kReduceWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (o >= nout) return;  // a whole warp
  const double* base = part + (long long)o * n;
  double s = 0.0;
  for (int k = lane; k < n; k += 32) s += base[k];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    if (scale != nullptr && o >= C) s *= scale[o - C];
    out[o] = s;
    if (out_f != nullptr) out_f[o] = (float)s;
  }
}

template <typename T, int VW>
__global__ void __launch_bounds__(kPeriodVectors)
bn_train_apply(const T* __restrict__ x, T* __restrict__ y, const double* __restrict__ sums,
               const float* __restrict__ weight, const float* __restrict__ bias,
               float* __restrict__ stats, long long E, int C, double count, double eps,
               Geometry g) {
  __shared__ float sh[3 * kMaxC];  // mean, rstd * gamma, beta
  for (int c = threadIdx.x; c < C; c += g.threads) {
    const double mean = sums[c] / count;
    const double var = fmax(sums[C + c] / count - mean * mean, 0.0);
    const float rstd = (float)(1.0 / sqrt(var + eps));
    sh[c] = (float)mean;
    sh[C + c] = rstd * weight[c];
    sh[2 * C + c] = bias[c];
    if (blockIdx.x == 0) {
      stats[c] = (float)mean;
      stats[C + c] = (float)var;
      stats[2 * C + c] = rstd;
    }
  }
  __syncthreads();
  const int off = (threadIdx.x % g.ct) * VW;
  float m[VW], a[VW], b[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    const int c = (off + j) % C;
    m[j] = sh[c];
    a[j] = sh[C + c];
    b[j] = sh[2 * C + c];
  }
  const T* in[1] = {x};
  stream<T, VW, 1>(in, E, g, [&](long long e, const Vec<T, VW>(&v)[1], int nv) {
    Vec<T, VW> out;
#pragma unroll
    for (int j = 0; j < VW; ++j) out.v[j] = from_f32<T>(fmaf(to_f32(v[0].v[j]) - m[j], a[j], b[j]));
    store<T, VW>(y, e, out, nv);
  });
}

template <typename T, int VW>
__global__ void __launch_bounds__(kPeriodVectors)
bn_train_bwd_apply(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
                   const double* __restrict__ gsums, const float* __restrict__ stats,
                   const float* __restrict__ weight, long long E, int C, double count,
                   Geometry g) {
  __shared__ float sh[4 * kMaxC];  // mean, gamma rstd, sum dy / n, rstd sum(dy xhat) / n
  for (int c = threadIdx.x; c < C; c += g.threads) {
    const float rstd = stats[2 * C + c];
    sh[c] = stats[c];
    sh[C + c] = weight[c] * rstd;
    sh[2 * C + c] = (float)(gsums[c] / count);
    sh[3 * C + c] = (float)(rstd * (gsums[C + c] / count));
  }
  __syncthreads();
  const int off = (threadIdx.x % g.ct) * VW;
  float m[VW], a[VW], b[VW], d[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    const int c = (off + j) % C;
    m[j] = sh[c];
    a[j] = sh[C + c];
    b[j] = sh[2 * C + c];
    d[j] = sh[3 * C + c];
  }
  const T* in[2] = {dy, x};
  stream<T, VW, 2>(in, E, g, [&](long long e, const Vec<T, VW>(&v)[2], int nv) {
    Vec<T, VW> out;
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float t = fmaf(-(to_f32(v[1].v[j]) - m[j]), d[j], to_f32(v[0].v[j]) - b[j]);
      out.v[j] = from_f32<T>(a[j] * t);
    }
    store<T, VW>(dx, e, out, nv);
  });
}

template <typename T, int V>
struct Tag {
  using type = T;
  static constexpr int vw = V;
};

// f(Tag<T, vw>{}) for the dtype (0 = float32, 1 = bfloat16): 16-byte vectors
template <typename F>
int dispatch(int dtype, F f) {
  if (dtype == 1) return f(Tag<__nv_bfloat16, 8>{});
  if (dtype == 0) return f(Tag<float, 4>{});
  return (int)cudaErrorInvalidValue;
}

int plan(long long N, int C, int dtype, int sms, long long workspace, Geometry& g) {
  if ((dtype != 0 && dtype != 1) || !geometry(N, C, dtype == 0 ? 4 : 2, sms, g) ||
      workspace < 2LL * C * g.grid) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int reduce(const double* part, double* out, float* out_f, int C, int n, const float* scale,
           cudaStream_t s) {
  bn_train_reduce<<<(2 * C + kReduceWarps - 1) / kReduceWarps, 32 * kReduceWarps, 0, s>>>(
      part, out, out_f, 2 * C, n, C, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points. x, dy, y, dx: (N, C) rows, C innermost, contiguous, of
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned; the (2, C) sums
// float64, everything else float32; all contiguous. sms: the card's SM count
// (the geometry depends on it, so two calls on one card give bitwise-equal
// sums); part: float64 scratch of workspace >= 2 C x kBlocksPerSm x sms
// values. Each returns the first CUDA error of its launches: 0 on success,
// cudaErrorInvalidValue for a shape it does not take (C > 1024, or more than
// 256 vectors a period).

// sums (2, C), float64: sum x, sum x^2 over the N rows.
extern "C" int lmnet_bn_train_stats(const void* x, void* sums, void* part, long long workspace,
                                    long long N, int C, int dtype, int sms, void* stream) {
  Geometry g;
  int err = plan(N, C, dtype, sms, workspace, g);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  err = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_train_stats<T, decltype(tag)::vw><<<g.grid, g.threads, 0, s>>>(
        static_cast<const T*>(x), p, N * C, C, g);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  return reduce(p, static_cast<double*>(sums), nullptr, C, g.grid, nullptr, s);
}

// y = (x - mean) (rstd gamma) + beta from sums (2, C) over count elements a
// channel; stats (3, C): mean, var, rstd.
extern "C" int lmnet_bn_train_apply(const void* x, void* y, const void* sums, const void* weight,
                                    const void* bias, void* stats, long long N, int C,
                                    int dtype, int sms, double count, double eps, void* stream) {
  Geometry g;
  const int err = plan(N, C, dtype, sms, 1LL << 62, g);
  if (err != 0 || !(count > 0)) return err != 0 ? err : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_train_apply<T, decltype(tag)::vw><<<apply_grid(g), g.threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const double*>(sums),
        static_cast<const float*>(weight), static_cast<const float*>(bias),
        static_cast<float*>(stats), N * C, C, count, eps, g);
    return (int)cudaGetLastError();
  });
}

// out (2, C), float64, and out_f, its float32 copy: sum dy (dbeta), sum dy
// xhat (dgamma) over the N rows, from the forward's stats (3, C).
extern "C" int lmnet_bn_train_bwd_stats(const void* dy, const void* x, const void* stats,
                                        void* out, void* out_f, void* part, long long workspace,
                                        long long N, int C, int dtype, int sms, void* stream) {
  Geometry g;
  int err = plan(N, C, dtype, sms, workspace, g);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  const float* st = static_cast<const float*>(stats);
  err = dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_train_bwd_stats<T, decltype(tag)::vw><<<g.grid, g.threads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), st, p, N * C, C, g);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  return reduce(p, static_cast<double*>(out), static_cast<float*>(out_f), C, g.grid, st + 2 * C,
                s);
}

// dx = gamma rstd (dy - sum dy / count - xhat sum(dy xhat) / count) from
// gsums (2, C) (the backward's sums, over the global batch) and the
// forward's stats (3, C).
extern "C" int lmnet_bn_train_bwd_apply(const void* dy, const void* x, void* dx,
                                        const void* gsums, const void* stats, const void* weight,
                                        long long N, int C, int dtype, int sms, double count,
                                        void* stream) {
  Geometry g;
  const int err = plan(N, C, dtype, sms, 1LL << 62, g);
  if (err != 0 || !(count > 0)) return err != 0 ? err : (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    bn_train_bwd_apply<T, decltype(tag)::vw><<<apply_grid(g), g.threads, 0, s>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx),
        static_cast<const double*>(gsums), static_cast<const float*>(stats),
        static_cast<const float*>(weight), N * C, C, count, g);
    return (int)cudaGetLastError();
  });
}
