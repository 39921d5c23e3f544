// Native runtime support for the SLAM engine.
//
// The reference implements its runtime scaffolding (dataset loaders, frame
// queues, per-stage timers) in C++ (`/root/reference/Examples/*/
// stereo_inertial_euroc.cc` LoadImages + main loop; `include/Config.h`
// REGISTER_TIMES timers). This library is the equivalent here: the
// device compute path is JAX/XLA, and the host-side feeding/timing runs
// here, off the Python GIL:
//
//  - a grayscale 8-bit PNG decoder (zlib inflate + PNG filters) covering the
//    EuRoC/TUM-VI image format, plus PGM;
//  - a multi-threaded prefetching frame loader with a bounded ring buffer
//    (the reference's producer/consumer queues, `src/LocalMapping.cc:296`);
//  - monotonic per-stage timers with mean/max dumps (REGISTER_TIMES).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG (grayscale) + PGM decoding
// ---------------------------------------------------------------------------

static uint32_t rd_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit PNG into a grayscale buffer. Returns 0 on success.
// Handles color types 0 (gray), 2 (RGB), 4 (gray+alpha), 6 (RGBA) with
// bit depth 8, no interlacing — everything EuRoC/TUM-VI/KITTI ship.
int slamrt_decode_png_gray(const uint8_t* data, long size, uint8_t* out,
                           int* out_w, int* out_h, long out_cap) {
  if (size < 8 || memcmp(data, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  long pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= size) {
    uint32_t len = rd_be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* payload = data + pos + 8;
    if (pos + 8 + len + 4 > (unsigned long)size) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      w = rd_be32(payload);
      h = rd_be32(payload + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
      if (bit_depth != 8 || interlace != 0) return -3;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 8 + len + 4;
  }
  if (w <= 0 || h <= 0) return -4;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return -5;
  }
  if ((long)w * h > out_cap) return -6;

  const long stride = (long)w * ch;
  std::vector<uint8_t> raw((stride + 1) * (long)h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return -7;

  std::vector<uint8_t> prev(stride, 0);
  std::vector<uint8_t> cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + (stride + 1) * (long)y;
    uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    for (long x = 0; x < stride; ++x) {
      int a = x >= ch ? cur[x - ch] : 0;
      int b = prev[x];
      int c = x >= ch ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -8;
      }
      cur[x] = (uint8_t)v;
    }
    uint8_t* dst = out + (long)y * w;
    if (ch == 1) {
      memcpy(dst, cur.data(), w);
    } else if (ch == 2) {
      for (int x = 0; x < w; ++x) dst[x] = cur[2 * x];
    } else {
      // BT.601 luma, same weights as cv::cvtColor BGR2GRAY on RGB input
      for (int x = 0; x < w; ++x) {
        const uint8_t* px = cur.data() + (long)ch * x;
        dst[x] = (uint8_t)((299 * px[0] + 587 * px[1] + 114 * px[2]) / 1000);
      }
    }
    std::swap(prev, cur);
  }
  *out_w = w;
  *out_h = h;
  return 0;
}

int slamrt_decode_pgm(const uint8_t* data, long size, uint8_t* out,
                      int* out_w, int* out_h, long out_cap) {
  if (size < 2 || data[0] != 'P' || (data[1] != '5' && data[1] != '2'))
    return -1;
  long pos = 2;
  int vals[3], nv = 0;
  while (nv < 3 && pos < size) {
    while (pos < size && (data[pos] == ' ' || data[pos] == '\n' ||
                          data[pos] == '\t' || data[pos] == '\r'))
      ++pos;
    if (pos < size && data[pos] == '#') {
      while (pos < size && data[pos] != '\n') ++pos;
      continue;
    }
    int v = 0;
    while (pos < size && data[pos] >= '0' && data[pos] <= '9')
      v = v * 10 + (data[pos++] - '0');
    vals[nv++] = v;
  }
  ++pos;  // single whitespace after maxval
  int w = vals[0], h = vals[1];
  if ((long)w * h > out_cap || pos + (long)w * h > size) return -2;
  memcpy(out, data + pos, (long)w * h);
  *out_w = w;
  *out_h = h;
  return 0;
}

int slamrt_load_image_gray(const char* path, uint8_t* out, int* out_w,
                           int* out_h, long out_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -101;
  }
  fclose(f);
  if (size >= 8 && memcmp(buf.data(), "\x89PNG", 4) == 0)
    return slamrt_decode_png_gray(buf.data(), size, out, out_w, out_h, out_cap);
  return slamrt_decode_pgm(buf.data(), size, out, out_w, out_h, out_cap);
}

// ---------------------------------------------------------------------------
// Prefetching frame loader (bounded ring buffer, worker threads)
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  int width = 0, height = 0, depth = 0;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<int> slot_frame;        // frame index held by slot, -1 empty
  std::vector<int> status;            // decode status per slot
  size_t next_submit = 0;
  size_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
};

void* slamrt_prefetch_open(const char** paths, int n_paths, int width,
                           int height, int n_buffers, int n_threads) {
  auto* p = new Prefetcher();
  for (int i = 0; i < n_paths; ++i) p->paths.emplace_back(paths[i]);
  p->width = width;
  p->height = height;
  p->depth = n_buffers;
  p->slots.resize(n_buffers, std::vector<uint8_t>((long)width * height));
  p->slot_frame.assign(n_buffers, -1);
  p->status.assign(n_buffers, 0);

  auto work = [p]() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(p->mu);
        p->cv_full.wait(lk, [p] {
          return p->stop || (p->next_submit < p->paths.size() &&
                             p->next_submit - p->next_consume <
                                 (size_t)p->depth);
        });
        if (p->stop) return;
        idx = p->next_submit++;
      }
      int slot = idx % p->depth;
      int w, h;
      int rc = slamrt_load_image_gray(p->paths[idx].c_str(),
                                      p->slots[slot].data(), &w, &h,
                                      (long)p->width * p->height);
      {
        std::lock_guard<std::mutex> lk(p->mu);
        p->status[slot] = rc;
        p->slot_frame[slot] = (int)idx;
      }
      p->cv_empty.notify_all();
    }
  };
  // NOTE: with >1 worker, completion order could race consume order; frames
  // must be delivered in order, so slot ownership is by index modulo depth
  // and the consumer waits for ITS frame id. One worker per ~2 buffers.
  for (int t = 0; t < n_threads; ++t) p->workers.emplace_back(work);
  return p;
}

// Blocks until frame `idx` is decoded; copies into out. Returns decode rc.
int slamrt_prefetch_get(void* handle, int idx, uint8_t* out) {
  auto* p = (Prefetcher*)handle;
  int slot = idx % p->depth;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_empty.wait(lk, [p, slot, idx] { return p->slot_frame[slot] == idx; });
  }
  memcpy(out, p->slots[slot].data(), (long)p->width * p->height);
  int rc = p->status[slot];
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->next_consume = idx + 1;
  }
  p->cv_full.notify_all();
  return rc;
}

void slamrt_prefetch_close(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_full.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Stage timers (REGISTER_TIMES equivalent)
// ---------------------------------------------------------------------------

struct Timers {
  struct Acc {
    double total_ms = 0, max_ms = 0;
    long count = 0;
    std::chrono::steady_clock::time_point start;
  };
  std::map<std::string, Acc> acc;
  std::mutex mu;
};

static Timers g_timers;

void slamrt_timer_start(const char* name) {
  std::lock_guard<std::mutex> lk(g_timers.mu);
  g_timers.acc[name].start = std::chrono::steady_clock::now();
}

void slamrt_timer_stop(const char* name) {
  auto now = std::chrono::steady_clock::now();
  std::lock_guard<std::mutex> lk(g_timers.mu);
  auto& a = g_timers.acc[name];
  double ms =
      std::chrono::duration<double, std::milli>(now - a.start).count();
  a.total_ms += ms;
  a.max_ms = ms > a.max_ms ? ms : a.max_ms;
  a.count += 1;
}

// Writes "name mean_ms max_ms count" lines (ExecTimeMean.txt style).
int slamrt_timer_dump(const char* path) {
  std::lock_guard<std::mutex> lk(g_timers.mu);
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  for (auto& kv : g_timers.acc) {
    const auto& a = kv.second;
    fprintf(f, "%s %.3f %.3f %ld\n", kv.first.c_str(),
            a.count ? a.total_ms / a.count : 0.0, a.max_ms, a.count);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
