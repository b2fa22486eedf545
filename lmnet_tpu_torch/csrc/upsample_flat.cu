// 2x bilinear upsample with align_corners=True on NHWC (B, H, W, C) ->
// (B, 2H, 2W, C): nn.Upsample(scale_factor=2, mode='bilinear',
// align_corners=True).
//
// Replaces the TPU kernel lmnet_tpu/ops/pallas/upsample_flat.py::
// upsample2x_flat (_upsample2x_flat_fwd, _upsample_flat_kernel). It computes
// the same function, not that kernel's TPU layout (8-row edge blocks, the
// log-depth lane-roll dilation ladder).
//
// At exactly 2x with aligned corners the taps of each output phase are fixed
// and only the weights vary with the position (upsample_flat.py:17-24):
//   even row 2k   = x[k] + a_k (x[k-1] - x[k]),  a_k = k / (2H - 1)
//   odd  row 2k+1 = x[k] + b_k (x[k+1] - x[k]),  b_k = (H - 1 - k) / (2H - 1)
// and the same along W; a_0 = 0 and b_{H-1} = 0, so the clamped neighbour at
// the border never contributes. Both variants lerp along H, then along W,
// in float32, and round once to the tensor's dtype, as
// ops/upsample_flat.py::upsample2x_flat_plain does.
//
// The row window (the mesh's 'spatial' axis, parallel/spatial.py): x is a
// slab of Hs rows of a map of global height Hg; the kernel writes the
// outputs of H input rows, whose first is slab row top and global row row0.
// k, H, a_k and b_k above are then the global row and Hg, and the
// neighbours k - 1 and k + 1 (clamped to the global map) are read from the
// slab, which must hold them (one halo row each side inside the map). The
// whole map is Hs = Hg = H, top = row0 = 0.
//
// What bounds it on an H100: memory. Each input element is read once and
// four output elements are written: 5 x 2 B per input element in bf16,
// writing is 80 % of the bytes; about 6 flops an output element. The
// served batch's small calls (16^2 and 32^2 maps, 2-5 us of bytes) are
// bound by the launch and the host.
//
// The design.
//  * variant 'tma' (a pixel of C x dtype bytes is a multiple of 16: every
//    shape the model gives, bf16 and float32). Grid (column tile, row tile,
//    image x channel chunk), so every index is 32-bit and no thread divides
//    a 64-bit one. A block owns th x tw input pixels and cc <= 256 channels
//    (C, or chunks of 256 with a zero-filled tail). One thread copies the
//    tile and its one-pixel halo, (th + 2) x (tw + 2) pixels x cc channels
//    in x's dtype, into shared memory from a 3-D tensor map over
//    (C, W, B*H) by TMA, in copies of at most 6 rows, each completing on
//    its own mbarrier, so that the first output rows are written while the
//    later input rows land. Each input element is read from device memory
//    once, plus the halo's share (its rows past the map or in the next
//    image, and its columns past the edge, are zero-filled or belong to
//    another image and are never read: the kernel clamps).
//  * Thread (o, ch) owns the 16-byte chunk ch of output column o of the
//    block's output row segment (2 tw pixels x cc channels, contiguous in
//    device memory when cc = C): neighbouring threads write neighbouring 16
//    bytes, so a warp stores 512 contiguous bytes; the two W phases of an
//    input column fall to neighbouring threads. The thread walks down the
//    tile's rows with the three rows it needs (k-1, k, k+1 at its column and
//    its W neighbour) in registers as raw 16-byte chunks, one new row from
//    shared memory a step, and writes output rows 2k and 2k+1 with
//    streaming (evict-first) stores: the output is not read again by this
//    kernel, and at 128^2 they took 24.2 against 27.3 us as a graph.
//  * The tile: 32 columns (fewer where the block's output row would pass
//    512 threads) and threads / 48 rows, halved while the grid has fewer
//    blocks than SMs: at the model's four bf16 shapes 2 x 8, 4 x 16, 8 x 32
//    and 4 x 32 (16^2 .. 128^2), the fastest of the tiles tried on the H100.
//  * variant 'generic' (a pixel whose bytes are not a multiple of 16, which
//    no tensor map can stride): one thread per (input pixel, chunk of the
//    widest unit dividing the pixel), reading its 3x3 neighbourhood from
//    device memory and writing its 2x2 outputs; grid (column block, row,
//    image), 32-bit indices.
// The launch plan (variant, tile, channel chunk, threads, grid, shared
// memory) comes from the caller (ops/upsample_flat.py::upsample_plan); the
// entry point computes its own (up_plan) and refuses a plan that differs,
// and the launch encodes the map and places the copies by that plan.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (lmnet_tpu_torch/ops/_build.py, lmnet_tpu_torch/ops/upsample_flat.py).

#include "nat_common.cuh"
#include "tma.cuh"

namespace {

using lmnet_nat::cdiv;
using lmnet_nat::from_f32;
using lmnet_nat::pack_bf16;
using lmnet_nat::to_f32;
using lmnet_nat::vec_bytes;
using namespace lmnet_tma;

constexpr int kSms = 132;               // H100 SXM
constexpr int kMaxThreads = 512;        // threads a block (tma), at most
constexpr int kTileBytes = 32 * 1024;   // a tile's shared memory (tma), at most
constexpr int kBoxRows = 6;             // rows a TMA copy of the tile moves
constexpr int kThreadsPerRow = 48;      // a block starts from threads / 48 rows
constexpr int kMaxChunk = 256;          // channels a block (a box dimension's limit)
constexpr int kGenericThreads = 256;    // threads a block (generic), at most
constexpr int kGridMax = 65535;         // grid y and z

inline int round_up(int a, int b) { return cdiv(a, b) * b; }

// rows a TMA copy of a th-row tile's th + 2 halo rows moves; the tile takes
// cdiv(th + 2, box_rows) copies, each on its own barrier, so that the first
// rows' outputs are written while the later rows land
inline int box_rows(int th) { return th + 2 < kBoxRows ? th + 2 : kBoxRows; }

// the shared memory a copy takes: its box's bytes, rounded up to 128 so that
// the next copy's destination is 128-byte aligned, as the TMA requires
inline int box_bytes(int rb, int tw, int cc, int es) {
  return (rb * (tw + 2) * cc * es + 127) / 128 * 128;
}

struct UpPlan {
  int tma;       // 1: variant 'tma'; 0: 'generic'
  int th, tw;    // input rows and columns a block
  int cc;        // channels a block (tma)
  int vec;       // elements a thread's chunk
  int threads;
  int gx, gy, gz;
  long long smem;  // dynamic shared memory bytes
  // tma: what the launch encodes and the kernel reads: the map's dims
  // (C, W, B*H) and byte strides, the box (channels, columns, rows), the
  // copies a tile takes, the byte offset of the first from the aligned
  // base (the barriers before it) and the bytes from one copy to the next
  uint64_t dims[3], strides[2];
  uint32_t box[3];
  int copies, offset, copy_stride;
};

// The plan for the outputs of H input rows of a (B, Hs, W, C) slab in
// elements of es bytes; false for a shape the kernel does not take (a grid
// dimension past 65535). The same function as
// ops/upsample_flat.py::upsample_plan.
bool up_plan(int B, int H, int W, int C, int es, int Hs, UpPlan* p) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Hs < H || (es != 2 && es != 4)) return false;
  *p = UpPlan{};
  if ((long long)C * es % 16 == 0) {
    const int V = 16 / es;
    const int cc = C < kMaxChunk ? C : kMaxChunk;
    const int nchunk = cdiv(C, cc);
    const int cpp = cc / V;
    int tw = 32;
    while (tw > 1 && 2 * tw * cpp > kMaxThreads) tw /= 2;
    tw = tw < W ? tw : W;
    const int threads = round_up(2 * tw * cpp, 32);
    // rows: threads / 48 (8 at 384 threads, 4 at 192; 2 to 16), halved
    // while the tile passes 32 KB or the grid has fewer blocks than SMs
    int th = threads / kThreadsPerRow;
    th = th < 2 ? 2 : th > 16 ? 16 : th;
    th = th < H ? th : H;
    while (th > 1 && (long long)(th + 2) * (tw + 2) * cc * es > kTileBytes) th /= 2;
    while (th > 1 && (long long)cdiv(W, tw) * cdiv(H, th) * B * nchunk < kSms) th /= 2;
    p->tma = 1;
    p->th = th;
    p->tw = tw;
    p->cc = cc;
    p->vec = V;
    p->threads = threads;
    p->gx = cdiv(W, tw);
    p->gy = cdiv(H, th);
    const long long gz = (long long)B * nchunk;
    if (p->gy > kGridMax || gz > kGridMax) return false;
    p->gz = (int)gz;
    // 128 bytes to align the tile to, 128 for the barriers, then the tile
    // in copies of kBoxRows rows: below 48 KB (a row of the tile is at most
    // 3 x 256 x 16 bytes), so no launch needs the shared-memory ceiling
    // raised
    const int rb = box_rows(th);
    p->dims[0] = (uint64_t)C;
    p->dims[1] = (uint64_t)W;
    p->dims[2] = (uint64_t)B * Hs;
    p->strides[0] = (uint64_t)C * es;
    p->strides[1] = (uint64_t)W * C * es;
    p->box[0] = (uint32_t)cc;
    p->box[1] = (uint32_t)tw + 2;
    p->box[2] = (uint32_t)rb;
    p->copies = cdiv(th + 2, rb);
    p->offset = 128;
    p->copy_stride = box_bytes(rb, tw, cc, es);
    p->smem = 256 + (long long)p->copies * p->copy_stride;
    return true;
  }
  const int V = vec_bytes((long long)C * es) / es;
  const int cpp = C / V;
  int ppx = kGenericThreads / cpp;
  ppx = ppx < 1 ? 1 : ppx;
  ppx = ppx < W ? ppx : W;
  const int items = ppx * cpp;
  p->tma = 0;
  p->th = 1;
  p->tw = ppx;
  p->cc = C;
  p->vec = V;
  p->threads = round_up(items < kGenericThreads ? items : kGenericThreads, 32);
  p->gx = cdiv(W, ppx);
  p->gy = H;
  p->gz = B;
  p->smem = 0;
  return H <= kGridMax && B <= kGridMax;
}

// 16 bytes of T (8 bf16 or 4 float32) in registers, and their float32 values
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                      pack_bf16(f[6], f[7]));
  } else {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
}

// One output chunk: the H lerp of rows (xk, xm) with weight wh at the
// thread's column (j) and its W neighbour (n), then the W lerp with ww.
template <typename T>
__device__ __forceinline__ uint4 lerp_chunk(const uint4& kj, const uint4& mj, const uint4& kn,
                                            const uint4& mn, float wh, float ww) {
  constexpr int V = 16 / sizeof(T);
  float a[V], b[V], c[V], d[V], o[V];
  unpack<T>(kj, a);
  unpack<T>(mj, b);
  unpack<T>(kn, c);
  unpack<T>(mn, d);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float ej = a[i] + wh * (b[i] - a[i]);
    const float en = c[i] + wh * (d[i] - c[i]);
    o[i] = ej + ww * (en - ej);
  }
  return pack<T>(o);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
up_tma_kernel(const __grid_constant__ CUtensorMap map, T* __restrict__ out, int H, int W, int C,
              int Hs, int top, int Hg, int row0, int th, int tw, int cc, int nchunk, int rb,
              int nbox, int offset, int copy_stride) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align128(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);  // one a copy
  const T* tile = reinterpret_cast<const T*>(base + offset);
  const int b = blockIdx.z / nchunk;
  const int ch0 = (blockIdx.z - b * nchunk) * cc;
  const int r0 = blockIdx.y * th;  // the tile's first input row (of the H)
  const int c0 = blockIdx.x * tw;
  const int hw = tw + 2;
  const int bstride = copy_stride / (int)sizeof(T);  // from one copy to the next, in elements
  if (threadIdx.x == 0) {
    for (int i = 0; i < nbox; ++i) mbar_init(bar + i, 1);
    mbar_fence_init();
    for (int i = 0; i < nbox; ++i) {
      mbar_expect_tx(bar + i, (unsigned)(rb * hw * cc * (int)sizeof(T)));
      tma_load_3d(const_cast<T*>(tile) + i * bstride, &map, bar + i, ch0, c0 - 1,
                  b * Hs + top + r0 - 1 + i * rb);
    }
  }
  // the thread's output column and chunk, worked out while the copy flies
  const int cpp = cc / V;
  const int o = threadIdx.x / cpp;
  const int ch = threadIdx.x - o * cpp;
  const int j = c0 + (o >> 1);  // input column
  const int ph = o & 1;
  const int jn = ph ? min(j + 1, W - 1) : max(j - 1, 0);  // its W neighbour
  const float ww = (float)(ph ? W - 1 - j : j) / (float)(2 * W - 1);
  const bool active = o < 2 * tw && j < W && ch0 + ch * V < C;
  const T* colj = tile + (j - c0 + 1) * cc + ch * V;  // halo row 0 at the two columns
  const T* coln = tile + (jn - c0 + 1) * cc + ch * V;
  __syncthreads();  // the barriers are initialised before anyone waits on them
  int ready = 0;    // the copies waited for
  auto need = [&](int k) {  // wait for the copy that holds input row k
    while (ready * rb <= k - r0 + 1) mbar_wait(bar + ready++, 0);
  };
  if (active) {
    // input row k (of the H; -1 and H are the slab's halo rows) at a column
    auto row = [&](const T* col, int k) {
      const int lr = k - r0 + 1;
      return *reinterpret_cast<const uint4*>(col + (lr / rb) * bstride + (lr % rb) * hw * cc);
    };
    const int nr = min(th, H - r0);
    need(r0);
    const int km = row0 + r0 > 0 ? r0 - 1 : r0;  // clamped to the global map
    uint4 mj = row(colj, km), mn = row(coln, km);  // row k - 1
    uint4 kj = row(colj, r0), kn = row(coln, r0);  // row k
    const int64_t ostride = 2 * (int64_t)W * C;  // an output row
    T* dst =
        out + ((int64_t)b * 2 * H + 2 * r0) * ostride + (int64_t)(2 * c0 + o) * C + ch0 + ch * V;
    const float den = (float)(2 * Hg - 1);
    for (int i = 0; i < nr; ++i) {
      const int k = r0 + i;
      const int kg = row0 + k;  // the global row
      const int kp = kg < Hg - 1 ? k + 1 : k;
      need(kp);
      const uint4 pj = row(colj, kp), pn = row(coln, kp);  // row k + 1
      const float ah = (float)kg / den;
      const float bh = (float)(Hg - 1 - kg) / den;
      __stcs(reinterpret_cast<uint4*>(dst), lerp_chunk<T>(kj, mj, kn, mn, ah, ww));
      __stcs(reinterpret_cast<uint4*>(dst + ostride), lerp_chunk<T>(kj, pj, kn, pn, bh, ww));
      dst += 2 * ostride;
      mj = kj;
      mn = kn;
      kj = pj;
      kn = pn;
    }
  }
  // no block leaves while a copy into its shared memory is in flight
  if (threadIdx.x == 0) need(r0 + nbox * rb - 2);
}

// V elements (V * sizeof(T) bytes, a power of two below 16) as float32, and
// the store back
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f32(p[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&f)[V]) {
  struct alignas(V * sizeof(T)) U {
    T v[V];
  } u;
#pragma unroll
  for (int i = 0; i < V; ++i) u.v[i] = from_f32<T>(f[i]);
  *reinterpret_cast<U*>(p) = u;
}

template <typename T, int V>
__global__ void __launch_bounds__(kGenericThreads)
up_generic_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int Hs,
                  int top, int Hg, int row0, int ppx) {
  const int cpp = C / V;
  const int b = blockIdx.z;
  const int k = blockIdx.y;   // the input row, of the H
  const int kg = row0 + k;    // its global row
  const int j0 = blockIdx.x * ppx;
  const int items = min(ppx, W - j0) * cpp;
  const float ah = (float)kg / (float)(2 * Hg - 1);             // on x[k-1], even rows
  const float bh = (float)(Hg - 1 - kg) / (float)(2 * Hg - 1);  // on x[k+1], odd rows
  // slab rows k - 1, k, k + 1, clamped to the global map
  const int rows[3] = {top + (kg > 0 ? k - 1 : k), top + k, top + (kg < Hg - 1 ? k + 1 : k)};
  const int64_t img = (int64_t)b * Hs;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int p = it / cpp;
    const int ch = (it - p * cpp) * V;
    const int j = j0 + p;
    float ev[3][V], od[3][V];
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      const int col = min(max(j + dc - 1, 0), W - 1);
      float xr[3][V];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        load_v<T, V>(x + ((img + rows[dr]) * W + col) * C + ch, xr[dr]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ev[dc][i] = xr[1][i] + ah * (xr[0][i] - xr[1][i]);
        od[dc][i] = xr[1][i] + bh * (xr[2][i] - xr[1][i]);
      }
    }
    const float aw = (float)j / (float)(2 * W - 1);
    const float bw = (float)(W - 1 - j) / (float)(2 * W - 1);
    const int64_t W2 = 2 * (int64_t)W;
    const int64_t o0 = (((int64_t)b * 2 * H + 2 * k) * W2 + 2 * j) * C + ch;
    float o[V];
#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
      const float(*r)[V] = ph == 0 ? ev : od;
      const int64_t at = o0 + (int64_t)ph * W2 * C;
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = r[1][i] + aw * (r[0][i] - r[1][i]);
      store_v<T, V>(out + at, o);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = r[1][i] + bw * (r[2][i] - r[1][i]);
      store_v<T, V>(out + at + C, o);
    }
  }
}

template <typename T>
int launch_tma(const void* x, void* out, int B, int H, int W, int C, const int (&win)[4],
               const UpPlan& p, cudaStream_t s) {
  CUtensorMap map;
  const int enc = encode(&map, (int)sizeof(T), 3, x, p.dims, p.strides, p.box);
  if (enc != 0) return enc;
  up_tma_kernel<T><<<dim3(p.gx, p.gy, p.gz), p.threads, p.smem, s>>>(
      map, static_cast<T*>(out), H, W, C, win[0], win[1], win[2], win[3], p.th, p.tw, p.cc,
      p.gz / B, (int)p.box[2], p.copies, p.offset, p.copy_stride);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_generic_v(const void* x, void* out, int H, int W, int C, const int (&win)[4],
                     const UpPlan& p, cudaStream_t s) {
  up_generic_kernel<T, V><<<dim3(p.gx, p.gy, p.gz), p.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, win[0], win[1], win[2], win[3],
      p.tw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const void* x, void* out, int H, int W, int C, const int (&win)[4],
                   const UpPlan& p, cudaStream_t s) {
  switch (p.vec * (int)sizeof(T)) {  // the unit in bytes: below 16 here
    case 8: return launch_generic_v<T, 8 / sizeof(T)>(x, out, H, W, C, win, p, s);
    case 4: return launch_generic_v<T, 4 / sizeof(T)>(x, out, H, W, C, win, p, s);
    default:
      if constexpr (sizeof(T) == 2) return launch_generic_v<T, 1>(x, out, H, W, C, win, p, s);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, Hs, W, C) and out (B, 2H, 2W, C) contiguous and 16-byte aligned.
// args: B, H, W, C, dtype (0 = float32, 1 = bfloat16), then the plan
// (variant 1 = tma / 0 = generic, rows and columns a block, channels a
// block, elements a chunk, threads, shared-memory bytes), which must equal
// the kernel's own for this shape, then the row window: Hs, top, Hg, row0
// (the H input rows are slab rows top .. and global rows row0 .. of a map
// of Hg rows; the slab holds their neighbours inside the map): 16 numbers
// in one array, so that the call converts four arguments, not nineteen
// (its host cost is most of a small call's). Returns 0 on success; a CUDA
// error (cudaErrorInvalidValue for a shape, plan or window it does not
// take, else the launch's); or a negated CUresult when the tensor map
// cannot be encoded.
extern "C" int lmnet_upsample2x(const void* x, void* out, const long long* args, void* stream) {
  const int B = (int)args[0], H = (int)args[1], W = (int)args[2], C = (int)args[3];
  const int dtype = (int)args[4];
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int win[4] = {(int)args[12], (int)args[13], (int)args[14], (int)args[15]};
  const int Hs = win[0], top = win[1], Hg = win[2], row0 = win[3];
  if (top < 0 || top + H > Hs || row0 < 0 || row0 + H > Hg || (row0 > 0 && top < 1) ||
      (row0 + H < Hg && top + H >= Hs)) {
    return (int)cudaErrorInvalidValue;
  }
  UpPlan p;
  if (!up_plan(B, H, W, C, dtype == 0 ? 4 : 2, Hs, &p)) return (int)cudaErrorInvalidValue;
  if (args[5] != p.tma || args[6] != p.th || args[7] != p.tw || args[8] != p.cc ||
      args[9] != p.vec || args[10] != p.threads || args[11] != p.smem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return p.tma ? launch_tma<float>(x, out, B, H, W, C, win, p, s)
                 : launch_generic<float>(x, out, H, W, C, win, p, s);
  }
  return p.tma ? launch_tma<__nv_bfloat16>(x, out, B, H, W, C, win, p, s)
               : launch_generic<__nv_bfloat16>(x, out, H, W, C, win, p, s);
}

// The kernel's own plan for the outputs of H input rows of a (B, Hs, W, C)
// slab, 22 numbers: tma, th, tw, cc, vec,
// threads, gx, gy, gz, smem; the tma variant's geometry, as the launch
// encodes it and the kernel reads it (0 for generic): dims[3], strides[2],
// box[3], copies, offset, copy_stride; and last 1 (a plan was made) or 0
// (refused; the rest is then 0). For the tests that hold
// ops/upsample_flat.py::upsample_plan to it.
extern "C" void lmnet_upsample2x_plan(int B, int H, int W, int C, int Hs, int dtype,
                                      long long* out) {
  UpPlan p = {};
  const bool ok = up_plan(B, H, W, C, dtype == 0 ? 4 : 2, Hs, &p);
  const long long v[22] = {p.tma, p.th, p.tw, p.cc, p.vec, p.threads, p.gx, p.gy, p.gz, p.smem,
                           (long long)p.dims[0], (long long)p.dims[1], (long long)p.dims[2],
                           (long long)p.strides[0], (long long)p.strides[1], p.box[0], p.box[1],
                           p.box[2], p.copies, p.offset, p.copy_stride, ok};
  for (int i = 0; i < 22; ++i) out[i] = ok || i == 21 ? v[i] : 0;
}
