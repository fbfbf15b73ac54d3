// cp2_tpu native data loader: threaded JPEG/PNG decode + bilinear resize.
//
// The reference leans on torch DataLoader worker processes (32 workers,
// main.py:70-71) for its input pipeline.  Here the host-side runtime is a
// C++ worker pool feeding fixed-size uint8 frames into a bounded ring of
// preallocated batch buffers — no Python in the decode path, no
// per-batch allocation, GIL touched only at the ctypes boundary.
//
// C API (ctypes-friendly):
//   void* cp2_loader_create(const char** paths, int n, int batch,
//                           int height, int width, int threads,
//                           unsigned seed, int shuffle, int drop_last);
//   void  cp2_loader_set_shard(void*, int shard_id, int num_shards);
//   void  cp2_loader_start_epoch(void*, int epoch);
//   int   cp2_loader_next(void*, unsigned char* out);  // >0 valid rows, 0 end
//   int   cp2_loader_len(void*);                        // batches per epoch
//   int   cp2_loader_cache_attach(void*, const char* path, int build);
//         // raw-frame cache: 2 = valid cache mapped, 1 = built then mapped,
//         // 0 = unavailable (falls back to live decode)
//   void  cp2_loader_destroy(void*);
//
// next/next_pair return the number of VALID rows in the delivered batch
// (the final drop_last=false batch is padded by repeating the last sample;
// callers must mask rows >= the returned count out of eval statistics).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cpp -o libcp2loader.so \
//        -ljpeg -lpng -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Image {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0, w = 0;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->rgb.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const char* path, Image* out) {
  png_image image;
  memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;
  out->h = image.height;
  out->w = image.width;
  out->rgb.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out->rgb.data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  return true;
}

bool decode_any(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rewind(f);
    bool ok = decode_jpeg(f, out);
    fclose(f);
    return ok;
  }
  fclose(f);
  if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    return decode_png(path.c_str(), out);
  }
  return false;
}

// Antialiased bilinear resampling matching PIL Image.BILINEAR: a separable
// triangle filter whose support scales with the downscale factor (plain
// 2x2 point-sampled bilinear aliases on downscale and diverges from the
// Python/PIL host path the loader replaces).
struct ResampleKernel {
  std::vector<int> xmin, xlen;   // per output pixel: first tap, tap count
  std::vector<float> weights;    // taps, max_len per output pixel
  int max_len = 0;
};

ResampleKernel build_triangle_kernel(int in_size, int out_size) {
  ResampleKernel k;
  const double scale = double(in_size) / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = 1.0 * fscale;  // triangle filter support = 1
  k.max_len = int(std::ceil(support)) * 2 + 1;
  k.xmin.resize(out_size);
  k.xlen.resize(out_size);
  k.weights.assign(size_t(out_size) * k.max_len, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int x0 = std::max(0, int(center - support + 0.5));
    int x1 = std::min(in_size, int(center + support + 0.5));
    double ww = 0.0;
    std::vector<double> w(x1 - x0);
    for (int x = x0; x < x1; ++x) {
      double t = std::abs((x - center + 0.5) / fscale);
      double v = t < 1.0 ? 1.0 - t : 0.0;
      w[x - x0] = v;
      ww += v;
    }
    float* wf = k.weights.data() + size_t(xx) * k.max_len;
    for (int x = 0; x < x1 - x0; ++x)
      wf[x] = float(ww > 0 ? w[x] / ww : 0.0);
    k.xmin[xx] = x0;
    k.xlen[xx] = x1 - x0;
  }
  return k;
}

void resize_bilinear(const Image& src, uint8_t* dst, int dh, int dw) {
  if (src.h == dh && src.w == dw) {
    // same-size PIL BILINEAR is the identity (scale=1 triangle kernel has a
    // single unit-weight tap per output pixel) — skip the two filter passes
    std::memcpy(dst, src.rgb.data(), size_t(dh) * dw * 3);
    return;
  }
  ResampleKernel kx = build_triangle_kernel(src.w, dw);
  ResampleKernel ky = build_triangle_kernel(src.h, dh);
  // horizontal pass into a float intermediate (src.h x dw x 3)
  std::vector<float> tmp(size_t(src.h) * dw * 3);
  std::vector<float> frow(size_t(src.w) * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* row = src.rgb.data() + size_t(y) * src.w * 3;
    for (size_t i = 0; i < frow.size(); ++i) frow[i] = row[i];
    float* trow = tmp.data() + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* w = kx.weights.data() + size_t(x) * kx.max_len;
      const float* p = frow.data() + size_t(kx.xmin[x]) * 3;
      float a0 = 0, a1 = 0, a2 = 0;
      for (int t = 0; t < kx.xlen[x]; ++t, p += 3) {
        a0 += w[t] * p[0];
        a1 += w[t] * p[1];
        a2 += w[t] * p[2];
      }
      trow[x * 3 + 0] = a0;
      trow[x * 3 + 1] = a1;
      trow[x * 3 + 2] = a2;
    }
  }
  // vertical pass: accumulate whole rows (contiguous, vectorizable)
  std::vector<float> acc(size_t(dw) * 3);
  for (int y = 0; y < dh; ++y) {
    const float* w = ky.weights.data() + size_t(y) * ky.max_len;
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int t = 0; t < ky.xlen[y]; ++t) {
      const float wt = w[t];
      const float* trow = tmp.data() + size_t(ky.xmin[y] + t) * dw * 3;
      for (size_t i = 0; i < acc.size(); ++i) acc[i] += wt * trow[i];
    }
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (size_t i = 0; i < acc.size(); ++i)
      drow[i] = uint8_t(std::max(0.0f, std::min(255.0f, acc[i] + 0.5f)));
  }
}

// single-channel luminance, matching PIL Image.convert("L"):
// L = (299 R + 587 G + 114 B) / 1000 — for id/label masks stored as
// grayscale PNG this is the identity (R == G == B == id).
struct Gray {
  std::vector<int32_t> y;  // H*W
  int h = 0, w = 0;
};

void rgb_to_gray(const Image& src, Gray* out) {
  out->h = src.h;
  out->w = src.w;
  out->y.resize(size_t(src.h) * src.w);
  for (size_t i = 0; i < out->y.size(); ++i) {
    const uint8_t* p = src.rgb.data() + i * 3;
    out->y[i] = int32_t((299 * p[0] + 587 * p[1] + 114 * p[2]) / 1000);
  }
}

// nearest resize, bit-exact to PIL Image.NEAREST: PIL's ImagingScaleAffine
// ACCUMULATES the step (xx += step) rather than computing (x+0.5)*step, and
// the float drift changes which source pixel wins at exact tile boundaries
// — so accumulate the same way.
void resize_nearest(const Gray& src, int32_t* dst, int dh, int dw) {
  if (src.h == dh && src.w == dw) {
    // same-size PIL NEAREST is the identity (xx accumulation starts at 0.5
    // and steps by 1, so int(xx) == x exactly)
    std::memcpy(dst, src.y.data(), size_t(dh) * dw * sizeof(int32_t));
    return;
  }
  const double sy = double(src.h) / dh;
  const double sx = double(src.w) / dw;
  std::vector<int> xmap(dw);
  double xx = sx * 0.5;
  for (int x = 0; x < dw; ++x, xx += sx)
    xmap[x] = std::min(int(xx), src.w - 1);
  double yy = sy * 0.5;
  for (int y = 0; y < dh; ++y, yy += sy) {
    int ys = std::min(int(yy), src.h - 1);
    for (int x = 0; x < dw; ++x)
      dst[size_t(y) * dw + x] = src.y[size_t(ys) * src.w + xmap[x]];
  }
}

// What travels alongside each image frame:
//   AUX_NONE   — images only (pretrain background/foreground streams)
//   AUX_RESIZE — aux map nearest-resized to the same base (H, W) as the
//                image (SAM region-id maps for REGION_ID pretrain,
//                reference loader.py:75-83)
//   AUX_CROP   — finetune (image, mask) pairs: SmallestMaxSize to the
//                target side then one shared random crop, image bilinear
//                / mask nearest (reference finetune_dataset.py:89-117)
enum AuxMode { AUX_NONE = 0, AUX_RESIZE = 1, AUX_CROP = 2 };

// ---------------------------------------------------------------------------
// Raw-frame cache: the decode+resample work per item is DETERMINISTIC (the
// per-epoch randomness — shuffle order, AUX_CROP window — happens after it),
// so it is computed once and mmap'd thereafter.  At the measured ~1 GB/s of
// page-cache reads this turns a decode-bound host (≈200 img/s/core) into a
// memcpy-bound one (thousands of img/s), which is what lets a small-core
// host keep a TPU chip fed.  Cached intermediate per mode:
//   AUX_NONE / AUX_RESIZE — the final (height, width) base frame [+ aux map]
//   AUX_CROP              — the SmallestMaxSize intermediate (rh, rw) pair;
//                           the shared random/center crop stays at read time
// Layout: header | 8-aligned blobs | index (one CacheRec per FILE index).
// The key hashes every path + size + mtime, so edits invalidate the file.
// ---------------------------------------------------------------------------

struct CacheHeader {
  char magic[8];  // "CP2RAWC1"
  uint32_t mode;
  int32_t n, h, w;
  uint64_t key;
  uint64_t index_off;
};

struct CacheRec {
  uint64_t img_off, aux_off;
  int32_t h, w;  // blob dims (== base h/w except AUX_CROP intermediates)
};

constexpr char kCacheMagic[8] = {'C', 'P', '2', 'R', 'A', 'W', 'C', '1'};

uint64_t fnv1a(uint64_t h, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  for (size_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

uint64_t hash_path_stat(uint64_t h, const std::string& path) {
  h = fnv1a(h, path.data(), path.size());
  struct stat st;
  if (stat(path.c_str(), &st) == 0) {
    h = fnv1a(h, &st.st_size, sizeof(st.st_size));
    h = fnv1a(h, &st.st_mtime, sizeof(st.st_mtime));
  }
  return h;
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::string> aux_paths;
  int batch, height, width, threads, shuffle, drop_last;
  int aux_mode = AUX_NONE;
  int random_crop = 1;  // AUX_CROP: random (train/val) vs center (test)
  unsigned seed;
  int epoch = 0;
  // multi-host data sharding (DistributedSampler equivalent): each host
  // takes a strided slice of the epoch-truncated index stream, so every
  // shard sees the same number of batches (lockstep across hosts)
  int shard_id = 0, num_shards = 1;

  std::vector<size_t> order;
  std::atomic<size_t> next_index{0};
  size_t epoch_batches = 0;

  struct Batch {
    std::vector<uint8_t> img;
    std::vector<int32_t> aux;
    int valid = 0;  // rows that are real samples (rest are pad repeats)
  };

  // bounded reorder window of ready batches, delivered strictly in batch
  // order (a completion-order FIFO makes batch order depend on thread
  // scheduling even with shuffle=false — observed as flaky decode order
  // under CPU contention)
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Batch> ready;  // batch index -> frames
  size_t max_ready = 4;
  size_t consumed = 0;
  bool stopping = false;

  std::vector<std::thread> workers;

  // raw-frame cache (mmap'd; see CacheHeader above)
  const uint8_t* cache_map = nullptr;
  size_t cache_bytes = 0;
  const CacheRec* cache_recs = nullptr;
  bool cache_ok = false;

  size_t frame_bytes() const { return size_t(height) * width * 3; }
  size_t aux_elems() const { return size_t(height) * width; }

  // per-shard sample count: truncate to a multiple of num_shards so all
  // shards run the same number of batches (the Python HostDataLoader and
  // the reference's DistributedSampler obey the same law)
  size_t shard_len() const {
    if (num_shards <= 1) return paths.size();
    return paths.size() / num_shards;
  }

  void start_epoch(int ep) {
    join_workers();
    epoch = ep;
    order.resize(paths.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937 rng(seed + unsigned(epoch));
      std::shuffle(order.begin(), order.end(), rng);
    }
    if (num_shards > 1) {
      std::vector<size_t> mine;
      mine.reserve(shard_len());
      size_t even = shard_len() * num_shards;
      for (size_t i = shard_id; i < even; i += num_shards)
        mine.push_back(order[i]);
      order = std::move(mine);
    }
    epoch_batches = drop_last ? order.size() / batch
                              : (order.size() + batch - 1) / batch;
    next_index = 0;
    consumed = 0;
    stopping = false;
    ready.clear();
    int n = std::max(1, threads);
    for (int t = 0; t < n; ++t)
      workers.emplace_back([this] { worker_loop(); });
  }

  // deterministic decode+resample intermediate for FILE index fi (this is
  // exactly what the raw cache stores): final base frame for
  // AUX_NONE/AUX_RESIZE, the SmallestMaxSize pair for AUX_CROP
  void make_intermediate(size_t fi, Image* img_out, Gray* aux_out) {
    Image img;
    if (!decode_any(paths[fi], &img) || img.h == 0) {
      img_out->h = height;
      img_out->w = width;
      img_out->rgb.assign(frame_bytes(), 0);
      if (aux_mode != AUX_NONE) {
        aux_out->h = height;
        aux_out->w = width;
        aux_out->y.assign(aux_elems(), 0);
      }
      return;
    }
    Gray aux;
    if (aux_mode != AUX_NONE) {
      Image aux_rgb;
      if (!decode_any(aux_paths[fi], &aux_rgb) || aux_rgb.h == 0) {
        aux.h = img.h;
        aux.w = img.w;
        aux.y.assign(size_t(img.h) * img.w, 0);
      } else {
        rgb_to_gray(aux_rgb, &aux);
      }
    }
    if (aux_mode == AUX_CROP) {
      // SmallestMaxSize: scale so min side == target side (height == width
      // here); the crop itself is per-epoch random and NOT part of the
      // intermediate
      int s = height;  // square target
      float scale = float(s) / std::min(img.w, img.h);
      int rw = std::max(s, int(std::lround(img.w * scale)));
      int rh = std::max(s, int(std::lround(img.h * scale)));
      img_out->h = rh;
      img_out->w = rw;
      img_out->rgb.resize(size_t(rh) * rw * 3);
      resize_bilinear(img, img_out->rgb.data(), rh, rw);
      aux_out->h = rh;
      aux_out->w = rw;
      aux_out->y.resize(size_t(rh) * rw);
      resize_nearest(aux, aux_out->y.data(), rh, rw);
      return;
    }
    img_out->h = height;
    img_out->w = width;
    img_out->rgb.resize(frame_bytes());
    resize_bilinear(img, img_out->rgb.data(), height, width);
    if (aux_mode == AUX_RESIZE) {
      aux_out->h = height;
      aux_out->w = width;
      aux_out->y.resize(aux_elems());
      resize_nearest(aux, aux_out->y.data(), height, width);
    }
  }

  // AUX_CROP read-time tail: one crop window shared by image and mask,
  // deterministic per (seed, epoch, item) — reproducible epochs,
  // thread-schedule independent
  void crop_pair(const uint8_t* rimg, const int32_t* raux, int rh, int rw,
                 size_t fi, uint8_t* img_out, int32_t* aux_out) {
    int s = height;
    int y0, x0;
    if (random_crop) {
      std::mt19937 rng(seed * 2654435761u ^ unsigned(epoch) * 40503u ^
                       unsigned(fi) * 2246822519u);
      y0 = int(rng() % unsigned(rh - s + 1));
      x0 = int(rng() % unsigned(rw - s + 1));
    } else {
      y0 = (rh - s) / 2;
      x0 = (rw - s) / 2;
    }
    for (int y = 0; y < s; ++y) {
      memcpy(img_out + size_t(y) * s * 3,
             rimg + (size_t(y0 + y) * rw + x0) * 3, size_t(s) * 3);
      memcpy(aux_out + size_t(y) * s,
             raux + size_t(y0 + y) * rw + x0, size_t(s) * sizeof(int32_t));
    }
  }

  // one (image[, aux]) item into preallocated output slots
  void load_item(size_t idx, uint8_t* img_out, int32_t* aux_out) {
    size_t fi = order[idx];
    if (cache_ok) {
      const CacheRec& r = cache_recs[fi];
      const uint8_t* ib = cache_map + r.img_off;
      if (aux_mode == AUX_CROP) {
        crop_pair(ib, reinterpret_cast<const int32_t*>(cache_map + r.aux_off),
                  r.h, r.w, fi, img_out, aux_out);
      } else {
        memcpy(img_out, ib, frame_bytes());
        if (aux_mode == AUX_RESIZE)
          memcpy(aux_out, cache_map + r.aux_off,
                 aux_elems() * sizeof(int32_t));
      }
      return;
    }
    Image rimg;
    Gray raux;
    make_intermediate(fi, &rimg, &raux);
    if (aux_mode == AUX_CROP) {
      crop_pair(rimg.rgb.data(), raux.y.data(), rimg.h, rimg.w, fi, img_out,
                aux_out);
      return;
    }
    memcpy(img_out, rimg.rgb.data(), frame_bytes());
    if (aux_mode == AUX_RESIZE)
      memcpy(aux_out, raux.y.data(), aux_elems() * sizeof(int32_t));
  }

  uint64_t cache_key() const {
    uint64_t h = 14695981039346656037ull;
    int32_t meta[3] = {int32_t(aux_mode), height, width};
    h = fnv1a(h, meta, sizeof(meta));
    for (const auto& p : paths) h = hash_path_stat(h, p);
    for (const auto& p : aux_paths) h = hash_path_stat(h, p);
    return h;
  }

  void cache_detach() {
    if (cache_map) munmap(const_cast<uint8_t*>(cache_map), cache_bytes);
    cache_map = nullptr;
    cache_recs = nullptr;
    cache_bytes = 0;
    cache_ok = false;
  }

  bool cache_load(const char* path) {
    cache_detach();
    int fd = open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(CacheHeader)) {
      close(fd);
      return false;
    }
    void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);  // the mapping keeps the file alive
    if (m == MAP_FAILED) return false;
    const auto* hdr = static_cast<const CacheHeader*>(m);
    bool valid =
        memcmp(hdr->magic, kCacheMagic, 8) == 0 &&
        hdr->mode == uint32_t(aux_mode) && hdr->n == int32_t(paths.size()) &&
        hdr->h == height && hdr->w == width && hdr->key == cache_key() &&
        hdr->index_off + sizeof(CacheRec) * paths.size() <=
            uint64_t(st.st_size);
    if (valid) {
      // every blob must lie inside the mapping (a corrupt record would
      // otherwise send load_item reading outside the mmap)
      const auto* recs = reinterpret_cast<const CacheRec*>(
          static_cast<const uint8_t*>(m) + hdr->index_off);
      for (int32_t i = 0; valid && i < hdr->n; ++i) {
        const CacheRec& r = recs[i];
        uint64_t img_end = r.img_off + uint64_t(r.h) * r.w * 3;
        valid = r.h > 0 && r.w > 0 && r.img_off <= hdr->index_off &&
                img_end <= hdr->index_off;
        if (valid && r.aux_off)
          valid = r.aux_off + uint64_t(r.h) * r.w * sizeof(int32_t) <=
                  hdr->index_off;
      }
    }
    if (!valid) {
      munmap(m, st.st_size);
      return false;
    }
    cache_map = static_cast<const uint8_t*>(m);
    cache_bytes = st.st_size;
    cache_recs =
        reinterpret_cast<const CacheRec*>(cache_map + hdr->index_off);
    cache_ok = true;
    return true;
  }

  bool cache_build(const char* path) {
    // per-process tmp name: concurrent builders (multi-host shared cache
    // dir) each write their own file; the atomic rename means last-wins
    // with both results valid
    std::string tmp =
        std::string(path) + ".tmp." + std::to_string(getpid());
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return false;
    CacheHeader hdr{};
    memcpy(hdr.magic, kCacheMagic, 8);
    hdr.mode = uint32_t(aux_mode);
    hdr.n = int32_t(paths.size());
    hdr.h = height;
    hdr.w = width;
    hdr.key = cache_key();
    fwrite(&hdr, sizeof(hdr), 1, f);  // placeholder; rewritten at the end
    std::vector<CacheRec> recs(paths.size());
    uint64_t off = sizeof(CacheHeader);
    std::mutex wmu;
    std::atomic<size_t> cursor{0};
    std::atomic<bool> failed{false};
    auto pad8 = [&](uint64_t& o) {
      static const uint8_t zeros[8] = {0};
      uint64_t pad = (8 - o % 8) % 8;
      if (pad) fwrite(zeros, 1, pad, f);
      o += pad;
    };
    auto work = [&] {
      for (;;) {
        size_t i = cursor.fetch_add(1);
        if (i >= paths.size() || failed.load()) return;
        Image img;
        Gray aux;
        make_intermediate(i, &img, &aux);
        std::lock_guard<std::mutex> lock(wmu);
        pad8(off);
        recs[i].img_off = off;
        recs[i].h = img.h;
        recs[i].w = img.w;
        if (fwrite(img.rgb.data(), 1, img.rgb.size(), f) != img.rgb.size())
          failed = true;
        off += img.rgb.size();
        recs[i].aux_off = 0;
        if (aux_mode != AUX_NONE) {
          pad8(off);
          recs[i].aux_off = off;
          size_t nb = aux.y.size() * sizeof(int32_t);
          if (fwrite(aux.y.data(), 1, nb, f) != nb) failed = true;
          off += nb;
        }
      }
    };
    std::vector<std::thread> pool;
    int n = std::max(1, threads);
    for (int t = 0; t < n; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
    pad8(off);
    hdr.index_off = off;
    fwrite(recs.data(), sizeof(CacheRec), recs.size(), f);
    rewind(f);
    fwrite(&hdr, sizeof(hdr), 1, f);
    bool ok = !failed.load();
    ok = (fclose(f) == 0) && ok;
    if (!ok || rename(tmp.c_str(), path) != 0) {
      remove(tmp.c_str());
      return false;
    }
    return cache_load(path);
  }

  void worker_loop() {
    for (;;) {
      size_t b = next_index.fetch_add(1);
      if (b >= epoch_batches) return;
      Batch buf;
      buf.img.resize(size_t(batch) * frame_bytes());
      if (aux_mode != AUX_NONE) buf.aux.resize(size_t(batch) * aux_elems());
      buf.valid = int(std::min(size_t(batch), order.size() - b * batch));
      for (int i = 0; i < batch; ++i) {
        size_t idx = b * batch + i;
        if (idx >= order.size()) idx = order.size() - 1;  // pad last batch
        load_item(idx, buf.img.data() + size_t(i) * frame_bytes(),
                  aux_mode == AUX_NONE
                      ? nullptr
                      : buf.aux.data() + size_t(i) * aux_elems());
      }
      std::unique_lock<std::mutex> lock(mu);
      // admit only batches inside the reorder window so memory stays
      // bounded AND the consumer (which needs batch `consumed` next)
      // can always make progress
      cv_space.wait(lock, [this, b] {
        return b < consumed + max_ready || stopping;
      });
      if (stopping) return;
      ready.emplace(b, std::move(buf));
      cv_ready.notify_all();
    }
  }

  int next(uint8_t* img_out, int32_t* aux_out) {
    std::unique_lock<std::mutex> lock(mu);
    if (consumed >= epoch_batches) return 0;
    cv_ready.wait(lock, [this] { return ready.count(consumed) != 0; });
    auto it = ready.find(consumed);
    Batch buf = std::move(it->second);
    ready.erase(it);
    ++consumed;
    cv_space.notify_all();
    lock.unlock();
    memcpy(img_out, buf.img.data(), buf.img.size());
    if (aux_out && !buf.aux.empty())
      memcpy(aux_out, buf.aux.data(), buf.aux.size() * sizeof(int32_t));
    return buf.valid;
  }

  void join_workers() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
      cv_space.notify_all();
    }
    for (auto& t : workers) t.join();
    workers.clear();
  }

  ~Loader() {
    join_workers();
    cache_detach();
  }
};

}  // namespace

extern "C" {

void* cp2_loader_create(const char** paths, int n, int batch, int height,
                        int width, int threads, unsigned seed, int shuffle,
                        int drop_last) {
  auto* l = new Loader;
  l->paths.assign(paths, paths + n);
  l->batch = batch;
  l->height = height;
  l->width = width;
  l->threads = threads;
  l->seed = seed;
  l->shuffle = shuffle;
  l->drop_last = drop_last;
  return l;
}

// paired streams: images + aux maps (masks / region-id maps)
// aux_mode: 1 = nearest-resize aux to base (region maps),
//           2 = SmallestMaxSize + shared crop (finetune image/mask pairs;
//               random_crop 0 = deterministic center crop for test)
void* cp2_loader_create_pairs(const char** img_paths, const char** aux_paths,
                              int n, int batch, int height, int width,
                              int threads, unsigned seed, int shuffle,
                              int drop_last, int aux_mode, int random_crop) {
  auto* l = static_cast<Loader*>(cp2_loader_create(
      img_paths, n, batch, height, width, threads, seed, shuffle, drop_last));
  l->aux_paths.assign(aux_paths, aux_paths + n);
  l->aux_mode = aux_mode;
  l->random_crop = random_crop;
  return l;
}

void cp2_loader_set_shard(void* handle, int shard_id, int num_shards) {
  auto* l = static_cast<Loader*>(handle);
  l->shard_id = shard_id;
  l->num_shards = num_shards > 0 ? num_shards : 1;
}

void cp2_loader_start_epoch(void* handle, int epoch) {
  static_cast<Loader*>(handle)->start_epoch(epoch);
}

int cp2_loader_next(void* handle, unsigned char* out) {
  return static_cast<Loader*>(handle)->next(out, nullptr);
}

int cp2_loader_next_pair(void* handle, unsigned char* img_out,
                         int32_t* aux_out) {
  return static_cast<Loader*>(handle)->next(img_out, aux_out);
}

int cp2_loader_len(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  size_t n = l->shard_len();
  return l->drop_last ? int(n / l->batch) : int((n + l->batch - 1) / l->batch);
}

// Raw-frame cache: map `path` if it is a valid cache for this loader's
// file list (paths + sizes + mtimes participate in the key); otherwise,
// when `build` != 0, decode every item once with the worker pool, write the
// cache, and map it.  Returns 2 (existing cache mapped), 1 (built then
// mapped), 0 (unavailable — loader keeps decoding live).
int cp2_loader_cache_attach(void* handle, const char* path, int build) {
  auto* l = static_cast<Loader*>(handle);
  if (l->cache_load(path)) return 2;
  if (build && l->cache_build(path)) return 1;
  return 0;
}

void cp2_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
