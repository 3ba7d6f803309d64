// Native I/O runtime: 16-bit PNG codec + threaded batch decode +
// background prefetch queue.
//
// The reference's data path (L2/L3: PngUtilities.cpp, PngWrapper.cpp,
// TUMDataLoader.cpp) is native C++ over libpng; this is its equivalent
// here: the host-side feeding pipeline stays native so depth-frame
// decode overlaps device compute. Exposed as a plain C ABI for ctypes
// (no pybind11 in this image).
//
// Build: g++ -O2 -shared -fPIC tsdf_io.cpp -lpng -lz -lpthread -o libtsdf_io.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// 16-bit grey PNG decode (ref: load_png_from_file PngUtilities.cpp:13-90)
// ---------------------------------------------------------------------------
// strict: accept only native 16-bit greyscale files (no transform chain).
// The prefetch path uses strict so its output is bit-identical to the
// fallback PIL loader on every input it accepts; permissive mode keeps
// the reference's conversion chain for the general-purpose loader.
bool decode_png16(const char* path, std::vector<uint16_t>& out, uint32_t* w,
                  uint32_t* h, bool strict = false) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (strict && (bit_depth != 16 || color != PNG_COLOR_TYPE_GRAY)) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  if (color & PNG_COLOR_MASK_PALETTE) {
    png_set_palette_to_rgb(png);
  }
  if (color & PNG_COLOR_MASK_COLOR || color & PNG_COLOR_MASK_PALETTE) {
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  }
  if (color & PNG_COLOR_MASK_ALPHA) {
    png_set_strip_alpha(png);
  }
  if (png_get_valid(png, info, PNG_INFO_tRNS)) {
    png_set_strip_alpha(png);
  }
  if (bit_depth < 16) {
    png_set_expand_16(png);
  }
  png_set_swap(png);  // PNG is big-endian on disk; we want host LE
  png_read_update_info(png, info);

  // the row buffers below are sized for exactly one 16-bit grey channel;
  // refuse anything the transform chain did not reduce to that
  if (png_get_rowbytes(png, info) != size_t(*w) * 2) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  out.resize(size_t(*w) * *h);
  std::vector<png_bytep> rows(*h);
  for (uint32_t y = 0; y < *h; ++y)
    rows[y] = reinterpret_cast<png_bytep>(out.data() + size_t(y) * *w);
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

bool encode_png16(const char* path, const uint16_t* data, uint32_t w,
                  uint32_t h) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return false;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 16, PNG_COLOR_TYPE_GRAY, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  png_set_swap(png);
  std::vector<png_bytep> rows(h);
  for (uint32_t y = 0; y < h; ++y)
    rows[y] = reinterpret_cast<png_bytep>(
        const_cast<uint16_t*>(data + size_t(y) * w));
  png_write_image(png, rows.data());
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return true;
}

// ---------------------------------------------------------------------------
// Prefetch queue: worker threads decode ahead; consumer pops in order.
// ---------------------------------------------------------------------------
struct Frame {
  std::vector<uint16_t> data;
  uint32_t w = 0, h = 0;
  bool ok = false;
  bool taken = false;  // take() clears data; a second take must error
};

// Decode-ahead window: bounds resident frames to roughly this many
// beyond the consumer's position, so long sequences don't pile the whole
// dataset into RAM.
constexpr size_t kPrefetchWindow = 16;

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<Frame> frames;
  std::vector<int> state;  // 0 pending, 1 busy, 2 done; guarded by mu
  size_t next_job = 0;
  size_t consumed = 0;  // frames the consumer has taken
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  Prefetcher(const char** p, int n, int threads)
      : paths(p, p + n), frames(n), state(n, 0) {
    int nt = threads > 0 ? threads : 4;
    for (int t = 0; t < nt; ++t)
      workers.emplace_back([this] { work(); });
  }

  void work() {
    for (;;) {
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop || (next_job < paths.size() &&
                          next_job < consumed + kPrefetchWindow);
        });
        if (stop || next_job >= paths.size()) return;
        i = next_job++;
        state[i] = 1;
      }
      Frame f;
      // strict: prefetch only serves native 16-bit grey (TUM depth);
      // anything else errors so the caller can fall back to the PIL
      // loader and both paths always agree bit-for-bit.
      f.ok = decode_png16(paths[i].c_str(), f.data, &f.w, &f.h,
                          /*strict=*/true);
      {
        std::lock_guard<std::mutex> lk(mu);
        frames[i] = std::move(f);
        state[i] = 2;
      }
      cv.notify_all();
    }
  }

  Frame* wait(size_t i) {
    if (i >= frames.size()) return nullptr;
    std::unique_lock<std::mutex> lk(mu);
    if (i >= consumed) {
      consumed = i;  // opens the window for workers
      cv.notify_all();
    }
    cv.wait(lk, [&] { return state[i] == 2; });
    return &frames[i];
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

// Single image. Returns 0 on success; caller provides the buffer sized
// from tsdf_png16_size. Header-only read — no pixel decode.
int tsdf_png16_size(const char* path, uint32_t* w, uint32_t* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -1;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

int tsdf_load_png16(const char* path, uint16_t* out, uint32_t w, uint32_t h) {
  std::vector<uint16_t> tmp;
  uint32_t rw, rh;
  if (!decode_png16(path, tmp, &rw, &rh)) return -1;
  if (rw != w || rh != h) return -2;
  std::memcpy(out, tmp.data(), sizeof(uint16_t) * size_t(w) * h);
  return 0;
}

int tsdf_save_png16(const char* path, const uint16_t* data, uint32_t w,
                    uint32_t h) {
  return encode_png16(path, data, w, h) ? 0 : -1;
}

// Batch decode: n images of identical (w, h) into one contiguous buffer,
// parallel across `threads` workers. Returns count successfully decoded.
int tsdf_load_png16_batch(const char** paths, int n, uint16_t* out,
                          uint32_t w, uint32_t h, int threads) {
  std::atomic<int> ok{0};
  std::atomic<int> next{0};
  int nt = threads > 0 ? threads : 4;
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&] {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        if (tsdf_load_png16(paths[i], out + size_t(i) * w * h, w, h) == 0)
          ok.fetch_add(1);
      }
    });
  }
  for (auto& t : ts) t.join();
  return ok.load();
}

// Prefetcher lifecycle.
void* tsdf_prefetch_create(const char** paths, int n, int threads) {
  return new Prefetcher(paths, n, threads);
}

// Blocks until frame i is decoded; returns 0 and fills w/h on success.
int tsdf_prefetch_dims(void* handle, int i, uint32_t* w, uint32_t* h) {
  Frame* f = static_cast<Prefetcher*>(handle)->wait(i);
  if (!f || !f->ok) return -1;
  *w = f->w;
  *h = f->h;
  return 0;
}

int tsdf_prefetch_take(void* handle, int i, uint16_t* out, uint32_t w,
                       uint32_t h) {
  Prefetcher* p = static_cast<Prefetcher*>(handle);
  Frame* f = p->wait(i);
  if (!f || !f->ok || f->taken || f->w != w || f->h != h) return -1;
  std::memcpy(out, f->data.data(), sizeof(uint16_t) * size_t(w) * h);
  f->taken = true;
  f->data.clear();
  f->data.shrink_to_fit();
  return 0;
}

void tsdf_prefetch_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
