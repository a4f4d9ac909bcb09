// Native frame loader + prefetcher of cusift_tpu_torch (a copy of
// native/frameloader.cpp, the JAX package's, bound by
// utils/native_loader.py and built into cusift_tpu_torch/_build/).
//
// What stays on the host and is latency-critical is file I/O + decode +
// format conversion, which this module does natively with a worker pool
// and a bounded prefetch ring so the GPU never waits on the disk.  Built
// with -ffp-contract=off, so its float arithmetic is the plain IEEE
// single-precision sequence that utils/imgcodec.py repeats in numpy: the
// two decoders agree byte for byte.
//
// Formats: PNG (8/16-bit gray/RGB/with-alpha, non-interlaced; zlib
// inflate + unfilter implemented here — this is what TUM RGB/depth and
// KITTI grayscale actually ship as), PGM P5 (8/16-bit), PPM P6
// (converted to grayscale), and raw .npy float32/uint8/uint16 2-D
// arrays.  Output is always float32: grayscale in [0,1] or depth scaled
// by a caller-provided factor.
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   fl_open(paths, n_paths, n_threads, queue_depth, scale) -> handle
//   fl_next(handle, out_buf, capacity, &h, &w) -> index or <0 when done
//   fl_close(handle)
//   fl_decode(path, out_buf, capacity, &h, &w, scale) -> 0 ok (one-shot)

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  int index = -1;
  int h = 0, w = 0;
  std::vector<float> data;
  bool ok = false;
};

// ---------- decoding ----------

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) { std::fclose(f); return false; }
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

// Skip PNM whitespace + comments; returns next token start or npos.
size_t pnm_token(const std::vector<uint8_t>& b, size_t pos, std::string& tok) {
  const size_t n = b.size();
  while (pos < n) {
    if (b[pos] == '#') { while (pos < n && b[pos] != '\n') pos++; }
    else if (isspace(b[pos])) pos++;
    else break;
  }
  tok.clear();
  while (pos < n && !isspace(b[pos]) && b[pos] != '#') tok.push_back(b[pos++]);
  return pos;
}

bool decode_pnm(const std::vector<uint8_t>& b, float scale, Frame& f) {
  if (b.size() < 10 || b[0] != 'P') return false;
  const char kind = static_cast<char>(b[1]);
  if (kind != '5' && kind != '6') return false;
  std::string tok;
  size_t pos = 2;
  pos = pnm_token(b, pos, tok); int w = std::atoi(tok.c_str());
  pos = pnm_token(b, pos, tok); int h = std::atoi(tok.c_str());
  pos = pnm_token(b, pos, tok); int maxv = std::atoi(tok.c_str());
  if (w <= 0 || h <= 0 || maxv <= 0) return false;
  pos++;  // single whitespace after maxval
  const int ch = (kind == '6') ? 3 : 1;
  const int bytes = (maxv > 255) ? 2 : 1;
  const size_t need = static_cast<size_t>(w) * h * ch * bytes;
  if (b.size() < pos + need) return false;
  f.h = h; f.w = w;
  f.data.resize(static_cast<size_t>(w) * h);
  const uint8_t* p = b.data() + pos;
  const float inv = (scale > 0.f) ? scale : 1.0f / static_cast<float>(maxv);
  // 16-bit samples are big-endian per the PNM spec
  auto sample = [&](size_t si) -> float {
    if (bytes == 2) return static_cast<float>((p[2 * si] << 8) | p[2 * si + 1]);
    return static_cast<float>(p[si]);
  };
  for (size_t i = 0; i < static_cast<size_t>(w) * h; i++) {
    float v;
    if (ch == 3) {  // PPM -> Rec.601 luminance (8- or 16-bit samples)
      v = 0.299f * sample(3 * i) + 0.587f * sample(3 * i + 1)
          + 0.114f * sample(3 * i + 2);
    } else {
      v = sample(i);
    }
    f.data[i] = v * inv;
  }
  return true;
}

bool decode_npy(const std::vector<uint8_t>& b, float scale, Frame& f) {
  if (b.size() < 10 || std::memcmp(b.data(), "\x93NUMPY", 6) != 0) return false;
  const int hlen = b[8] | (b[9] << 8);
  const std::string hdr(reinterpret_cast<const char*>(b.data() + 10), hlen);
  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = hdr.find(key);
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    size_t e = hdr.find(',', p);
    return hdr.substr(p + 1, e - p - 1);
  };
  const std::string descr = find_val("'descr'");
  // little-endian host decode only: '>f4'-style big-endian payloads would
  // reinterpret byte-swapped and normalise into plausible-looking garbage
  if (descr.find('>') != std::string::npos) return false;
  const bool fortran = find_val("'fortran_order'").find("True") != std::string::npos;
  if (fortran) return false;
  size_t sp = hdr.find("'shape'");
  sp = hdr.find('(', sp);
  size_t ep = hdr.find(')', sp);
  int h = 0, w = 0;
  if (std::sscanf(hdr.substr(sp, ep - sp + 1).c_str(), "(%d, %d)", &h, &w) != 2)
    return false;
  const size_t npix = static_cast<size_t>(h) * w;
  const uint8_t* p = b.data() + 10 + hlen;
  const size_t avail = b.size() - 10 - hlen;
  f.h = h; f.w = w;
  f.data.resize(npix);
  // scale == 0 means "normalise by the dtype's max" (the documented
  // contract); floats pass through unscaled in that case
  if (descr.find("f4") != std::string::npos && avail >= npix * 4) {
    const float s = (scale > 0.f) ? scale : 1.0f;
    const float* fp = reinterpret_cast<const float*>(p);
    for (size_t i = 0; i < npix; i++) f.data[i] = fp[i] * s;
  } else if (descr.find("u2") != std::string::npos && avail >= npix * 2) {
    const float s = (scale > 0.f) ? scale : 1.0f / 65535.0f;
    const uint16_t* up = reinterpret_cast<const uint16_t*>(p);
    for (size_t i = 0; i < npix; i++) f.data[i] = up[i] * s;
  } else if (descr.find("u1") != std::string::npos && avail >= npix) {
    const float s = (scale > 0.f) ? scale : 1.0f / 255.0f;
    for (size_t i = 0; i < npix; i++) f.data[i] = p[i] * s;
  } else {
    return false;
  }
  return true;
}

// ---------- PNG (zlib inflate + per-row unfilter) ----------

// `expected` bounds the output (known from IHDR before inflating) so a
// corrupt/crafted IDAT whose stream inflates far past the declared image
// size fails fast instead of exhausting memory.
bool inflate_all(const uint8_t* src, size_t n, size_t expected,
                 std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  out.clear();
  std::vector<uint8_t> buf(1 << 16);
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(buf.size());
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return false; }
    out.insert(out.end(), buf.data(),
               buf.data() + (buf.size() - zs.avail_out));
    if (out.size() > expected) { inflateEnd(&zs); return false; }
    if (rc != Z_STREAM_END && zs.avail_in == 0 && zs.avail_out != 0) break;
  }
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

bool decode_png(const std::vector<uint8_t>& b, float scale, Frame& f) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (b.size() < 8 + 25 || std::memcmp(b.data(), sig, 8) != 0) return false;
  auto u32 = [&](size_t p) -> uint32_t {
    return (uint32_t(b[p]) << 24) | (uint32_t(b[p + 1]) << 16) |
           (uint32_t(b[p + 2]) << 8) | b[p + 3];
  };
  size_t pos = 8;
  int64_t w = 0, h = 0;
  int depth = 0, ctype = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 12 <= b.size()) {
    const uint32_t len = u32(pos);
    if (pos + 12 + len > b.size()) return false;
    const char* tag = reinterpret_cast<const char*>(b.data() + pos + 4);
    const uint8_t* data = b.data() + pos + 8;
    if (std::memcmp(tag, "IHDR", 4) == 0) {
      if (len < 13) return false;
      w = u32(pos + 8);
      h = u32(pos + 12);
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
    } else if (std::memcmp(tag, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || w * h > (int64_t(1) << 28) || interlace != 0)
    return false;
  if (depth != 8 && depth != 16) return false;
  int ch;
  switch (ctype) {  // palette (3) deliberately unsupported
    case 0: ch = 1; break;   // gray (KITTI, TUM depth)
    case 2: ch = 3; break;   // RGB (TUM rgb)
    case 4: ch = 2; break;   // gray + alpha
    case 6: ch = 4; break;   // RGBA
    default: return false;
  }
  const size_t bpp = static_cast<size_t>(ch) * depth / 8;
  const size_t stride = static_cast<size_t>(w) * bpp;
  const size_t expected = (stride + 1) * static_cast<size_t>(h);
  std::vector<uint8_t> raw;
  if (!inflate_all(idat.data(), idat.size(), expected, raw)) return false;
  if (raw.size() < expected) return false;

  std::vector<uint8_t> img(stride * h);
  for (int64_t y = 0; y < h; y++) {
    const uint8_t ft = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = img.data() + stride * y;
    const uint8_t* up = y ? img.data() + stride * (y - 1) : nullptr;
    for (size_t x = 0; x < stride; x++) {
      const int a = x >= bpp ? dst[x - bpp] : 0;
      const int u = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int v = src[x];
      switch (ft) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += u; break;
        case 3: v += (a + u) / 2; break;
        case 4: {  // Paeth
          const int p = a + u - c;
          const int pa = std::abs(p - a), pb = std::abs(p - u),
                    pc = std::abs(p - c);
          v += (pa <= pb && pa <= pc) ? a : (pb <= pc ? u : c);
          break;
        }
        default: return false;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }

  const int maxv = (depth == 16) ? 65535 : 255;
  const float inv = (scale > 0.f) ? scale : 1.0f / static_cast<float>(maxv);
  const int sb = depth / 8;  // 16-bit samples are big-endian (PNG spec)
  auto sample = [&](const uint8_t* p, int c_) -> float {
    const uint8_t* q = p + c_ * sb;
    return (sb == 2) ? static_cast<float>((q[0] << 8) | q[1])
                     : static_cast<float>(q[0]);
  };
  f.h = static_cast<int>(h);
  f.w = static_cast<int>(w);
  f.data.resize(static_cast<size_t>(w) * h);
  for (size_t i = 0; i < f.data.size(); i++) {
    const uint8_t* p = img.data() + i * bpp;
    const float v = (ch >= 3)
        ? 0.299f * sample(p, 0) + 0.587f * sample(p, 1) +
              0.114f * sample(p, 2)
        : sample(p, 0);
    f.data[i] = v * inv;
  }
  return true;
}

bool decode_path(const std::string& path, float scale, Frame& f) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  if (decode_png(buf, scale, f)) return true;
  if (decode_pnm(buf, scale, f)) return true;
  if (decode_npy(buf, scale, f)) return true;
  return false;
}

// ---------- prefetcher ----------

struct Loader {
  std::vector<std::string> paths;
  float scale = 0.f;
  size_t queue_depth = 4;
  std::atomic<int> next_to_fetch{0};
  int next_to_emit = 0;
  std::map<int, Frame> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      int idx = next_to_fetch.fetch_add(1);
      if (idx >= static_cast<int>(paths.size())) return;
      Frame f;
      f.index = idx;
      f.ok = decode_path(paths[idx], scale, f);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || ready.size() < queue_depth ||
               idx < next_to_emit + static_cast<int>(queue_depth);
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(f));
      cv_ready.notify_all();
    }
  }

  bool next(Frame& out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= static_cast<int>(paths.size())) return false;
    cv_ready.wait(lk, [&] {
      return stop.load() || ready.count(next_to_emit) > 0;
    });
    if (stop.load()) return false;
    out = std::move(ready[next_to_emit]);
    ready.erase(next_to_emit);
    next_to_emit++;
    cv_space.notify_all();
    return true;
  }
};

std::mutex g_handles_mu;
std::map<int, std::unique_ptr<Loader>> g_handles;
int g_next_handle = 1;

}  // namespace

extern "C" {

int fl_open(const char** paths, int n_paths, int n_threads, int queue_depth,
            float scale) {
  auto ld = std::make_unique<Loader>();
  for (int i = 0; i < n_paths; i++) ld->paths.emplace_back(paths[i]);
  ld->scale = scale;
  ld->queue_depth = queue_depth > 0 ? queue_depth : 4;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; t++)
    ld->workers.emplace_back(&Loader::worker, ld.get());
  std::lock_guard<std::mutex> lk(g_handles_mu);
  int h = g_next_handle++;
  g_handles[h] = std::move(ld);
  return h;
}

// Returns the frame index (>= 0) or -1 when the stream is exhausted,
// -2 on decode failure, -3 if the buffer is too small (h/w still set).
int fl_next(int handle, float* out, int64_t capacity, int* h, int* w) {
  Loader* ld;
  {
    std::lock_guard<std::mutex> lk(g_handles_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return -2;
    ld = it->second.get();
  }
  Frame f;
  if (!ld->next(f)) return -1;
  *h = f.h;
  *w = f.w;
  if (!f.ok) return -2;
  if (static_cast<int64_t>(f.data.size()) > capacity) return -3;
  std::memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  return f.index;
}

void fl_close(int handle) {
  std::unique_ptr<Loader> ld;
  {
    std::lock_guard<std::mutex> lk(g_handles_mu);
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return;
    ld = std::move(it->second);
    g_handles.erase(it);
  }
  ld->stop.store(true);
  ld->cv_ready.notify_all();
  ld->cv_space.notify_all();
  for (auto& t : ld->workers) t.join();
}

int fl_decode(const char* path, float* out, int64_t capacity, int* h, int* w,
              float scale) {
  Frame f;
  if (!decode_path(path, scale, f)) return -2;
  *h = f.h;
  *w = f.w;
  if (static_cast<int64_t>(f.data.size()) > capacity) return -3;
  std::memcpy(out, f.data.data(), f.data.size() * sizeof(float));
  return 0;
}

}  // extern "C"
