// vxs_io: native host-runtime data loader for visionx_slam_tpu.
//
// The reference's runtime around its compute is C++ (dataset parsing +
// cv::imread decode on the tracking thread, core/system/system.cpp:38-53).
// This is the framework's equivalent: a small C library that decodes TUM
// RGB-D PNG pairs (libpng) and runs a bounded multi-threaded prefetch
// pipeline so host decode overlaps device compute (the pipeline-parallelism
// analog in SURVEY.md §2.2). Python binds via ctypes (no pybind11 in the
// image); the pure-Python loader remains as fallback.
//
// Exposed C ABI:
//   vxs_decode_gray(path, out_u8, w, h)           PNG -> grayscale uint8
//   vxs_decode_depth(path, out_f32, w, h, scale)  16-bit PNG -> meters
//   vxs_prefetch_create / _next / _destroy        threaded decode pipeline

#include <png.h>

#include <atomic>
#include <chrono>
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

struct Image {
  std::vector<uint8_t> bytes;  // gray u8 or depth f32, row-major
  int w = 0, h = 0;
  bool ok = false;
};

// Decode any PNG into 8-bit RGB or keep 16-bit grayscale. Returns false on
// any error (missing file, bad signature, ...).
bool read_png(const char* path, std::vector<uint8_t>& data, int& w, int& h,
              int& channels, int& bit_depth) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // PNG is big-endian; we want LE
  png_read_update_info(png, info);

  channels = png_get_channels(png, info);
  bit_depth = png_get_bit_depth(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

Image decode_gray_impl(const char* path) {
  Image out;
  std::vector<uint8_t> data;
  int w, h, ch, depth;
  if (!read_png(path, data, w, h, ch, depth)) return out;
  out.w = w;
  out.h = h;
  out.bytes.resize(static_cast<size_t>(w) * h);
  if (depth == 8 && ch >= 3) {
    // RGB -> gray with the BT.601 integer weights cv::cvtColor uses
    // (gray = (9798 R + 19235 G + 3735 B + 16384) >> 15)
    for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i) {
      const uint8_t* p = &data[i * ch];
      out.bytes[i] = static_cast<uint8_t>(
          (9798 * p[0] + 19235 * p[1] + 3735 * p[2] + 16384) >> 15);
    }
  } else if (depth == 8 && ch == 1) {
    std::memcpy(out.bytes.data(), data.data(), out.bytes.size());
  } else if (depth == 16 && ch == 1) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(data.data());
    for (size_t i = 0, n = static_cast<size_t>(w) * h; i < n; ++i)
      out.bytes[i] = static_cast<uint8_t>(p[i] >> 8);
  } else {
    return out;
  }
  out.ok = true;
  return out;
}

Image decode_depth_impl(const char* path, double scale) {
  Image out;
  std::vector<uint8_t> data;
  int w, h, ch, depth;
  if (!read_png(path, data, w, h, ch, depth)) return out;
  if (ch != 1) return out;
  out.w = w;
  out.h = h;
  out.bytes.resize(static_cast<size_t>(w) * h * sizeof(float));
  float* dst = reinterpret_cast<float*>(out.bytes.data());
  const size_t n = static_cast<size_t>(w) * h;
  if (depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(data.data());
    const float inv = static_cast<float>(1.0 / scale);
    for (size_t i = 0; i < n; ++i) dst[i] = p[i] * inv;
  } else if (depth == 8) {
    const float inv = static_cast<float>(1.0 / scale);
    for (size_t i = 0; i < n; ++i) dst[i] = data[i] * inv;
  } else {
    return out;
  }
  out.ok = true;
  return out;
}

// ---------------------------------------------------------------------------
// bounded in-order prefetch pipeline
// ---------------------------------------------------------------------------

struct Frame {
  Image gray;
  Image depth;
};

struct Prefetcher {
  std::vector<std::string> rgb_paths, depth_paths;
  double depth_scale = 5000.0;
  size_t depth_q = 4;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  // slot i holds frame i once decoded; consumer takes them in order
  std::vector<Frame> slots;
  std::vector<char> ready;
  std::atomic<size_t> next_job{0};
  std::atomic<long> decode_us{0};  // total worker decode time (overlapped)
  size_t next_out = 0;
  bool stop = false;

  void worker() {
    for (;;) {
      size_t job = next_job.fetch_add(1);
      if (job >= rgb_paths.size()) return;
      {
        // bound how far decode runs ahead of consumption
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] { return stop || job < next_out + depth_q; });
        if (stop) {
          // a consumer may be blocked on this undecoded slot: mark it ready
          // (not ok -> consumer sees a decode failure, never a hang)
          ready[job] = 1;
          cv_consume.notify_all();
          return;
        }
      }
      Frame f;
      auto t0 = std::chrono::steady_clock::now();
      f.gray = decode_gray_impl(rgb_paths[job].c_str());
      f.depth = decode_depth_impl(depth_paths[job].c_str(), depth_scale);
      decode_us.fetch_add(std::chrono::duration_cast<std::chrono::microseconds>(
                              std::chrono::steady_clock::now() - t0)
                              .count());
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[job] = std::move(f);
        ready[job] = 1;
      }
      cv_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one PNG to grayscale uint8. Returns 0 on success. `out` must hold
// max_bytes; *w/*h receive dimensions.
int vxs_decode_gray(const char* path, uint8_t* out, long max_bytes, int* w,
                    int* h) {
  Image img = decode_gray_impl(path);
  if (!img.ok || static_cast<long>(img.bytes.size()) > max_bytes) return 1;
  std::memcpy(out, img.bytes.data(), img.bytes.size());
  *w = img.w;
  *h = img.h;
  return 0;
}

// Decode one 16-bit depth PNG to float32 meters (value/scale).
int vxs_decode_depth(const char* path, float* out, long max_elems, int* w,
                     int* h, double scale) {
  Image img = decode_depth_impl(path, scale);
  if (!img.ok ||
      static_cast<long>(img.bytes.size() / sizeof(float)) > max_elems)
    return 1;
  std::memcpy(out, img.bytes.data(), img.bytes.size());
  *w = img.w;
  *h = img.h;
  return 0;
}

void* vxs_prefetch_create(const char** rgb_paths, const char** depth_paths,
                          int n, int queue_depth, int n_threads,
                          double depth_scale) {
  auto* p = new Prefetcher();
  p->rgb_paths.assign(rgb_paths, rgb_paths + n);
  p->depth_paths.assign(depth_paths, depth_paths + n);
  p->depth_scale = depth_scale;
  p->depth_q = queue_depth > 0 ? queue_depth : 4;
  p->slots.resize(n);
  p->ready.assign(n, 0);
  int threads = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocking in-order dequeue. Returns 0 on success, 1 at end, 2 on decode
// failure of this frame.
int vxs_prefetch_next(void* handle, uint8_t* gray, long gray_max, float* depth,
                      long depth_max, int* w, int* h) {
  auto* p = static_cast<Prefetcher*>(handle);
  size_t i;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_out >= p->rgb_paths.size()) return 1;
    i = p->next_out;
    p->cv_consume.wait(lk, [&] { return p->stop || p->ready[i] != 0; });
    if (p->stop && p->ready[i] == 0) return 1;  // shutting down
    p->next_out = i + 1;
  }
  p->cv_produce.notify_all();
  Frame& f = p->slots[i];
  if (!f.gray.ok || !f.depth.ok) return 2;
  if (static_cast<long>(f.gray.bytes.size()) > gray_max ||
      static_cast<long>(f.depth.bytes.size() / sizeof(float)) > depth_max)
    return 2;
  std::memcpy(gray, f.gray.bytes.data(), f.gray.bytes.size());
  std::memcpy(depth, f.depth.bytes.data(), f.depth.bytes.size());
  *w = f.gray.w;
  *h = f.gray.h;
  // release memory of the consumed slot
  f = Frame();
  return 0;
}

// Total seconds worker threads spent decoding (overlapped with compute).
double vxs_prefetch_decode_seconds(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  return p->decode_us.load() * 1e-6;
}

void vxs_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
    p->next_out = p->rgb_paths.size();  // unblock producers
  }
  p->cv_produce.notify_all();
  p->cv_consume.notify_all();  // unblock a consumer stuck in next()
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
