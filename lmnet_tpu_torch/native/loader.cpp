// Native batch loader: mmap'd decoded-image cache + threaded batch assembly.
//
// TPU-native replacement for the reference's 10-worker torch DataLoader
// (reference train.py:128-133): instead of forking Python processes that
// re-decode JPEG/PNG with cv2 every epoch, the dataset is decoded ONCE into
// a flat binary cache (see lmnet_tpu_torch/data/native_loader.py:build_cache) and
// this library streams shuffled batches out of the page cache at memory
// bandwidth with a small thread pool.  No Python executes per sample.
//
// Cache layout (little-endian):
//   magic  u64 = 0x4C4D4E45545F4331  ("LMNET_C1")
//   n      u64   number of samples
//   h, w   u64   image height/width
//   then n * (h*w*3) bytes of uint8 RGB images
//   then n * (h*w)   bytes of uint8 masks
//
// C ABI (used via ctypes):
//   void* lm_open(const char* path);
//   long  lm_count(void* handle);  long lm_height(void*); long lm_width(void*);
//   void  lm_gather(void* handle, const long* indices, long batch,
//                   unsigned char* out_images, unsigned char* out_masks,
//                   int num_threads);
//   void  lm_close(void* handle);
//   long  lm_build_cache_jpeg(const char* const* image_paths,
//                             const char* const* mask_paths, long n,
//                             long size, const char* out_path,
//                             int num_threads);
//
// lm_build_cache_jpeg is the native decode stage (replaces the decode-once
// Python/cv2 pass): each worker thread libjpeg-decodes an image/mask pair,
// bilinear-resizes the RGB image (cv2 INTER_LINEAR half-pixel mapping),
// thresholds the grayscale mask at 127 then nearest-resizes (matching
// dataset/data_loading.py:237-239 + datasets.py), and pwrites straight into
// the cache layout.  Returns 0 on success, or the 1-based index of the
// first sample that failed to decode.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <csetjmp>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

constexpr uint64_t kMagic = 0x4C4D4E45545F4331ULL;

struct Cache {
  int fd = -1;
  size_t file_size = 0;
  const uint8_t* base = nullptr;
  uint64_t n = 0, h = 0, w = 0;
  const uint8_t* images = nullptr;
  const uint8_t* masks = nullptr;
};

}  // namespace

extern "C" {

void* lm_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_WILLNEED);
  const size_t file_size = static_cast<size_t>(st.st_size);
  const size_t hdr_sz = 4 * sizeof(uint64_t);
  if (file_size < hdr_sz) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  const uint64_t* hdr = static_cast<const uint64_t*>(mem);
  const uint64_t n = hdr[1], h = hdr[2], w = hdr[3];
  // Overflow-safe validation of n*h*w*4 + hdr against the actual file size
  // BEFORE deriving any data pointers: a corrupted/truncated cache whose
  // header product wraps uint64 must be rejected, not mmap-read OOB.
  const uint64_t payload = file_size - hdr_sz;
  bool ok = hdr[0] == kMagic && n > 0 && h > 0 && w > 0;
  // each factor must individually fit, then check via division (no overflow)
  ok = ok && h <= payload && w <= payload / h && n <= payload / h / w / 4;
  ok = ok && n * h * w * 4 <= payload;  // exact bytes check (images+masks)
  if (!ok) {
    munmap(mem, st.st_size);
    ::close(fd);
    return nullptr;
  }
  Cache* c = new Cache();
  c->fd = fd;
  c->file_size = file_size;
  c->base = static_cast<const uint8_t*>(mem);
  c->n = n;
  c->h = h;
  c->w = w;
  c->images = c->base + hdr_sz;
  c->masks = c->images + n * h * w * 3;
  return c;
}

long lm_count(void* handle) { return static_cast<Cache*>(handle)->n; }
long lm_height(void* handle) { return static_cast<Cache*>(handle)->h; }
long lm_width(void* handle) { return static_cast<Cache*>(handle)->w; }

// Gather `batch` samples by index into contiguous output buffers.
void lm_gather(void* handle, const long* indices, long batch,
               unsigned char* out_images, unsigned char* out_masks,
               int num_threads) {
  Cache* c = static_cast<Cache*>(handle);
  const size_t img_sz = c->h * c->w * 3;
  const size_t msk_sz = c->h * c->w;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > batch) num_threads = static_cast<int>(batch);

  auto worker = [&](long lo, long hi) {
    for (long i = lo; i < hi; ++i) {
      const long idx = indices[i];
      std::memcpy(out_images + i * img_sz, c->images + idx * img_sz, img_sz);
      std::memcpy(out_masks + i * msk_sz, c->masks + idx * msk_sz, msk_sz);
    }
  };

  if (num_threads == 1) {
    worker(0, batch);
    return;
  }
  std::vector<std::thread> threads;
  const long per = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    long lo = t * per;
    long hi = lo + per > batch ? batch : lo + per;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

void lm_close(void* handle) {
  Cache* c = static_cast<Cache*>(handle);
  if (c->base) munmap(const_cast<uint8_t*>(c->base), c->file_size);
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG decode stage
// ---------------------------------------------------------------------------

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode a JPEG file to a tightly-packed buffer; `channels` must be 3 (RGB)
// or 1 (grayscale; libjpeg's BT.601 luma conversion, same weights as cv2).
bool decode_jpeg(const char* path, std::vector<uint8_t>& out, long& h, long& w,
                 int channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  h = cinfo.output_height;
  w = cinfo.output_width;
  out.resize(static_cast<size_t>(h) * w * channels);
  const size_t stride = static_cast<size_t>(w) * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// cv2 INTER_LINEAR semantics: src = (dst + 0.5) * (in/out) - 0.5, edge-clamped.
void resize_bilinear_rgb(const uint8_t* src, long sh, long sw, uint8_t* dst,
                         long size) {
  const float scale_h = static_cast<float>(sh) / size;
  const float scale_w = static_cast<float>(sw) / size;
  std::vector<long> x0(size), x1(size);
  std::vector<float> wx(size);
  for (long x = 0; x < size; ++x) {
    float sx = (x + 0.5f) * scale_w - 0.5f;
    if (sx < 0) sx = 0;
    long xi = static_cast<long>(sx);
    if (xi > sw - 1) xi = sw - 1;
    x0[x] = xi;
    x1[x] = xi + 1 < sw ? xi + 1 : sw - 1;
    wx[x] = sx - xi;
  }
  for (long y = 0; y < size; ++y) {
    float sy = (y + 0.5f) * scale_h - 0.5f;
    if (sy < 0) sy = 0;
    long yi = static_cast<long>(sy);
    if (yi > sh - 1) yi = sh - 1;
    const long y1 = yi + 1 < sh ? yi + 1 : sh - 1;
    const float fy = sy - yi;
    const uint8_t* r0 = src + yi * sw * 3;
    const uint8_t* r1 = src + y1 * sw * 3;
    uint8_t* o = dst + y * size * 3;
    for (long x = 0; x < size; ++x) {
      const long a = x0[x] * 3, b = x1[x] * 3;
      const float fx = wx[x];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[a + c] + fx * (r0[b + c] - r0[a + c]);
        const float bot = r1[a + c] + fx * (r1[b + c] - r1[a + c]);
        const float v = top + fy * (bot - top);
        o[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// cv2 INTER_NEAREST mapping: src = floor(dst * in/out).
void resize_nearest_u8(const uint8_t* src, long sh, long sw, uint8_t* dst,
                       long size) {
  const float scale_h = static_cast<float>(sh) / size;
  const float scale_w = static_cast<float>(sw) / size;
  std::vector<long> xs(size);
  for (long x = 0; x < size; ++x) {
    long sx = static_cast<long>(x * scale_w);
    xs[x] = sx < sw ? sx : sw - 1;
  }
  for (long y = 0; y < size; ++y) {
    long sy = static_cast<long>(y * scale_h);
    if (sy >= sh) sy = sh - 1;
    const uint8_t* r = src + sy * sw;
    uint8_t* o = dst + y * size;
    for (long x = 0; x < size; ++x) o[x] = r[xs[x]];
  }
}

}  // namespace

extern "C" {

long lm_build_cache_jpeg(const char* const* image_paths,
                         const char* const* mask_paths, long n, long size,
                         const char* out_path, int num_threads) {
  const size_t hdr_sz = 4 * sizeof(uint64_t);
  const size_t img_sz = static_cast<size_t>(size) * size * 3;
  const size_t msk_sz = static_cast<size_t>(size) * size;
  int fd = ::open(out_path, O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  const size_t total = hdr_sz + n * (img_sz + msk_sz);
  if (ftruncate(fd, total) != 0) {
    ::close(fd);
    return -1;
  }
  uint64_t hdr[4] = {kMagic, static_cast<uint64_t>(n),
                     static_cast<uint64_t>(size), static_cast<uint64_t>(size)};
  if (pwrite(fd, hdr, sizeof(hdr), 0) != sizeof(hdr)) {
    ::close(fd);
    return -1;
  }

  std::atomic<long> failed{0};  // 1-based index of first failure
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = static_cast<int>(n);

  auto worker = [&](long lo, long hi) {
    std::vector<uint8_t> raw, img(img_sz), msk_raw, msk(msk_sz);
    for (long i = lo; i < hi && failed.load() == 0; ++i) {
      long h = 0, w = 0;
      if (!decode_jpeg(image_paths[i], raw, h, w, 3)) {
        long expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        return;
      }
      resize_bilinear_rgb(raw.data(), h, w, img.data(), size);
      if (!decode_jpeg(mask_paths[i], msk_raw, h, w, 1)) {
        long expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        return;
      }
      // threshold(>127) BEFORE nearest resize (data_loading.py:237-239)
      for (auto& v : msk_raw) v = v > 127 ? 1 : 0;
      resize_nearest_u8(msk_raw.data(), h, w, msk.data(), size);
      pwrite(fd, img.data(), img_sz, hdr_sz + i * img_sz);
      pwrite(fd, msk.data(), msk_sz, hdr_sz + n * img_sz + i * msk_sz);
    }
  };

  if (num_threads == 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    const long per = (n + num_threads - 1) / num_threads;
    for (int t = 0; t < num_threads; ++t) {
      long lo = t * per;
      long hi = lo + per > n ? n : lo + per;
      if (lo >= hi) break;
      threads.emplace_back(worker, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  ::close(fd);
  return failed.load();
}

}  // extern "C"
