// HiPAC-TPU native tile decoder.
//
// Host-side replacement for the reference's OpenSlide dependency
// (reference src/main.py:27,650): a libtiff-based pyramidal (Big)TIFF
// reader with a multithreaded batch region API, plus a tiled pyramidal
// TIFF writer used to fabricate hermetic test fixtures.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
//
// Threading model: libtiff handles are not thread-safe, so the decoder
// opens one TIFF* per worker thread (lazily) and the batch API shards
// regions across workers — the C++ analogue of the reference's OpenMP
// chunk pipeline (src/preprocessing/parallel-prog/chunk-based-proc.cpp),
// applied to the real bottleneck: tile decode feeding the TPU input
// pipeline.

// Where libtiff's headers are missing (a machine with the runtime library
// only), ops/build.py compiles with HIPAC_TIFF_ABI and the declarations
// of tiff_abi.h instead.
#ifdef HIPAC_TIFF_ABI
#include "tiff_abi.h"
#else
#include <tiffio.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <list>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct LevelInfo {
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t tile_width = 0;
  uint32_t tile_height = 0;
  bool tiled = false;
  uint16_t dir_index = 0;
};

// ---------------------------------------------------------------------------
// Decoded-tile LRU cache.
//
// Sliding-window inference reads overlapping full-width bands (stride <
// patch size), and grid extraction reads patches that straddle tile
// boundaries — without a cache each compressed tile is decoded 3-7x per
// slide pass (224-px cells at stride 112 over 256-px tiles: ~4.3x). The
// cache stores decoded top-down RGB tiles keyed by (directory, linear tile
// index), shared across all reader slots of a Handle. Entries are
// shared_ptr so a hit can copy outside the lock while eviction proceeds.
// ---------------------------------------------------------------------------

using TileData = std::shared_ptr<std::vector<uint8_t>>;

struct TileCache {
  struct Entry {
    uint64_t key;
    TileData data;
  };
  std::mutex mu;
  std::list<Entry> lru;  // front = most recently used
  std::unordered_map<uint64_t, std::list<Entry>::iterator> map;
  size_t bytes = 0;
  size_t capacity = 256ull << 20;  // 256 MB default; hipac_set_cache_bytes
  uint64_t hits = 0, misses = 0;

  TileData get(uint64_t key) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = map.find(key);
    if (it == map.end()) {
      ++misses;
      return nullptr;
    }
    lru.splice(lru.begin(), lru, it->second);  // touch
    ++hits;
    return it->second->data;
  }

  void put(uint64_t key, TileData data) {
    std::lock_guard<std::mutex> lock(mu);
    if (capacity == 0) return;
    auto it = map.find(key);
    if (it != map.end()) return;  // another thread raced the decode
    lru.push_front(Entry{key, data});
    map.emplace(key, lru.begin());
    bytes += data->size();
    while (bytes > capacity && !lru.empty()) {
      bytes -= lru.back().data->size();
      map.erase(lru.back().key);
      lru.pop_back();
    }
  }

  void clear() {
    std::lock_guard<std::mutex> lock(mu);
    lru.clear();
    map.clear();
    bytes = 0;
  }
};

// One lazily-opened TIFF* plus the mutex that serializes every use of it
// (TIFFSetDirectory + tile reads mutate per-handle state, so a TIFF* must
// never be shared between threads without exclusion). Slot 0 is reserved
// for single-region reads; batch workers use slots 1..N, so the two APIs
// can run concurrently on one Handle without racing on a shared TIFF*.
struct Slot {
  TIFF* tif = nullptr;
  std::mutex mu;
};

struct Handle {
  std::string path;
  std::vector<LevelInfo> levels;
  // deque: growth never invalidates Slot addresses held by workers
  std::deque<Slot> slots;
  std::mutex pool_mutex;  // guards deque growth only
  TileCache cache;

  ~Handle() {
    for (auto& s : slots)
      if (s.tif) TIFFClose(s.tif);
  }
};

// Cache key: directory index in the top 16 bits, linear tile index below.
// Linear index fits 48 bits for any real slide (level-0 CAMELYON16 at
// 256-px tiles is ~10^6 tiles).
uint64_t tile_key(const LevelInfo& lv, int64_t tx, int64_t ty) {
  const uint64_t tiles_per_row = (lv.width + lv.tile_width - 1) / lv.tile_width;
  const uint64_t linear =
      (static_cast<uint64_t>(ty) / lv.tile_height) * tiles_per_row +
      static_cast<uint64_t>(tx) / lv.tile_width;
  return (static_cast<uint64_t>(lv.dir_index) << 48) | linear;
}

thread_local char g_err[512] = {0};

void set_err(const std::string& msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg.c_str());
}

TIFF* open_tiff(const std::string& path) {
  // "m" disables memory mapping (large slides), "8" enables BigTIFF reads
  return TIFFOpen(path.c_str(), "rm");
}

bool scan_levels(TIFF* tif, std::vector<LevelInfo>* levels) {
  levels->clear();
  uint16_t dir = 0;
  do {
    LevelInfo info;
    info.dir_index = dir;
    if (!TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &info.width) ||
        !TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &info.height)) {
      return false;
    }
    info.tiled = TIFFIsTiled(tif) != 0;
    if (info.tiled) {
      TIFFGetField(tif, TIFFTAG_TILEWIDTH, &info.tile_width);
      TIFFGetField(tif, TIFFTAG_TILELENGTH, &info.tile_height);
    }
    levels->push_back(info);
    ++dir;
  } while (TIFFReadDirectory(tif));
  // Pyramid convention: directories ordered largest-first. Keep only the
  // monotonically shrinking prefix chain (skips e.g. embedded thumbnails
  // with unrelated dims interleaved by some scanners).
  std::vector<LevelInfo> pyramid;
  for (const auto& lv : *levels) {
    if (pyramid.empty() ||
        (lv.width <= pyramid.back().width && lv.height <= pyramid.back().height)) {
      pyramid.push_back(lv);
    }
  }
  *levels = pyramid;
  return !levels->empty();
}

// Fetch the Slot for a worker index, growing the pool if needed. The
// returned pointer is stable; callers must hold slot->mu while touching
// slot->tif (opening it lazily included).
Slot* acquire_slot(Handle* h, size_t idx) {
  std::lock_guard<std::mutex> lock(h->pool_mutex);
  while (h->slots.size() <= idx) h->slots.emplace_back();
  return &h->slots[idx];
}

// Open the slot's TIFF if not yet open. Caller holds slot->mu.
TIFF* slot_tiff_locked(Handle* h, Slot* s) {
  if (!s->tif) s->tif = open_tiff(h->path);
  return s->tif;
}

// Convert an RGBA buffer (libtiff bottom-up rows) to a top-down RGB tile.
TileData rgba_to_rgb_topdown(const uint32_t* rgba, int64_t tw, int64_t th,
                             int64_t valid_rows) {
  auto rgb = std::make_shared<std::vector<uint8_t>>(
      static_cast<size_t>(tw) * th * 3, 255);
  for (int64_t yy = 0; yy < valid_rows; ++yy) {
    const uint32_t* src_row = rgba + (th - 1 - yy) * tw;
    uint8_t* dst = rgb->data() + yy * tw * 3;
    for (int64_t xx = 0; xx < tw; ++xx) {
      const uint32_t px = src_row[xx];
      *dst++ = static_cast<uint8_t>(TIFFGetR(px));
      *dst++ = static_cast<uint8_t>(TIFFGetG(px));
      *dst++ = static_cast<uint8_t>(TIFFGetB(px));
    }
  }
  return rgb;
}

// Decode one region of one level into out (h x w x 3 values with a row
// stride of out_stride PIXELS — out_stride == w for a contiguous region;
// larger when writing a column chunk of a wider destination).
// (x, y) are LEVEL-space pixel coordinates of the top-left corner.
// Out-of-bounds area is filled white (the extraction pipeline's pad value,
// reference src/main.py:700-703). Decoded tiles/strips land in the
// Handle's shared LRU cache; hits copy without touching libtiff (the
// caller still holds its slot mutex, but cached copies don't need the
// TIFF* at all). ``tif`` may only be used under the caller's slot lock.
bool read_region_level(Handle* h, TIFF* tif, const LevelInfo& lv, int64_t x,
                       int64_t y, int64_t w, int64_t hh, uint8_t* out,
                       int64_t out_stride) {
  bool dir_set = false;  // TIFFSetDirectory once, and only if we decode
  for (int64_t yy = 0; yy < hh; ++yy) {
    std::memset(out + yy * out_stride * 3, 255, static_cast<size_t>(w) * 3);
  }

  const int64_t x0 = std::max<int64_t>(x, 0);
  const int64_t y0 = std::max<int64_t>(y, 0);
  const int64_t x1 = std::min<int64_t>(x + w, lv.width);
  const int64_t y1 = std::min<int64_t>(y + hh, lv.height);
  if (x0 >= x1 || y0 >= y1) return true;  // fully outside: stays white

  if (lv.tiled) {
    const int64_t tw = lv.tile_width, th = lv.tile_height;
    std::vector<uint32_t> rgba;
    for (int64_t ty = (y0 / th) * th; ty < y1; ty += th) {
      for (int64_t tx = (x0 / tw) * tw; tx < x1; tx += tw) {
        const uint64_t key = tile_key(lv, tx, ty);
        TileData tile = h->cache.get(key);
        if (!tile) {
          if (!dir_set) {
            if (!TIFFSetDirectory(tif, lv.dir_index)) {
              set_err("TIFFSetDirectory failed");
              return false;
            }
            dir_set = true;
          }
          // RGBA tile decode handles JPEG/YCbCr photometrics uniformly
          rgba.resize(static_cast<size_t>(tw) * th);
          if (!TIFFReadRGBATile(tif, static_cast<uint32_t>(tx),
                                static_cast<uint32_t>(ty), rgba.data())) {
            set_err("TIFFReadRGBATile failed");
            return false;
          }
          tile = rgba_to_rgb_topdown(rgba.data(), tw, th, th);
          h->cache.put(key, tile);
        }
        const int64_t cx0 = std::max(tx, x0), cx1 = std::min(tx + tw, x1);
        const int64_t cy0 = std::max(ty, y0), cy1 = std::min(ty + th, y1);
        for (int64_t yy = cy0; yy < cy1; ++yy) {
          std::memcpy(out + ((yy - y) * out_stride + (cx0 - x)) * 3,
                      tile->data() + ((yy - ty) * tw + (cx0 - tx)) * 3,
                      static_cast<size_t>(cx1 - cx0) * 3);
        }
      }
    }
  } else {
    // strip-organized level: decode overlapping rows via RGBA strips
    uint32_t rows_per_strip = 0;
    if (!TIFFSetDirectory(tif, lv.dir_index)) {
      set_err("TIFFSetDirectory failed");
      return false;
    }
    TIFFGetFieldDefaulted(tif, TIFFTAG_ROWSPERSTRIP, &rows_per_strip);
    if (rows_per_strip == 0) rows_per_strip = lv.height;
    // strips cache like full-width tiles: tw = level width, th = strip rows
    LevelInfo slv = lv;
    slv.tile_width = lv.width;
    slv.tile_height = rows_per_strip;
    std::vector<uint32_t> rgba;
    for (int64_t sy = (y0 / rows_per_strip) * rows_per_strip; sy < y1;
         sy += rows_per_strip) {
      const int64_t rows =
          std::min<int64_t>(rows_per_strip, lv.height - sy);
      const uint64_t key = tile_key(slv, 0, sy);
      TileData strip = h->cache.get(key);
      if (!strip) {
        rgba.resize(static_cast<size_t>(lv.width) * rows_per_strip);
        if (!TIFFReadRGBAStrip(tif, static_cast<uint32_t>(sy), rgba.data())) {
          set_err("TIFFReadRGBAStrip failed");
          return false;
        }
        // TIFFReadRGBAStrip puts row sy at buffer row (rows-1): convert
        // with the VALID row count as the flip height
        strip = rgba_to_rgb_topdown(rgba.data(), lv.width, rows, rows);
        h->cache.put(key, strip);
      }
      const int64_t cy0 = std::max(sy, y0), cy1 = std::min(sy + rows, y1);
      for (int64_t yy = cy0; yy < cy1; ++yy) {
        std::memcpy(out + ((yy - y) * out_stride + (x0 - x)) * 3,
                    strip->data() + ((yy - sy) * lv.width + x0) * 3,
                    static_cast<size_t>(x1 - x0) * 3);
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

const char* hipac_last_error() { return g_err; }

void* hipac_open(const char* path) {
  TIFFSetWarningHandler(nullptr);  // silence unknown-tag chatter
  auto h = new Handle();
  h->path = path;
  TIFF* tif = open_tiff(h->path);
  if (!tif) {
    set_err("cannot open TIFF: " + h->path);
    delete h;
    return nullptr;
  }
  if (!scan_levels(tif, &h->levels)) {
    set_err("no readable directories in " + h->path);
    TIFFClose(tif);
    delete h;
    return nullptr;
  }
  acquire_slot(h, 0)->tif = tif;  // slot 0: reserved for single-region reads
  return h;
}

void hipac_close(void* handle) { delete static_cast<Handle*>(handle); }

int hipac_level_count(void* handle) {
  return static_cast<int>(static_cast<Handle*>(handle)->levels.size());
}

int hipac_level_dims(void* handle, int level, int64_t* w, int64_t* hh) {
  auto* h = static_cast<Handle*>(handle);
  if (level < 0 || level >= static_cast<int>(h->levels.size())) return -1;
  *w = h->levels[level].width;
  *hh = h->levels[level].height;
  return 0;
}

// Read one region; (x, y) in LEVEL coordinates. out: h*w*3 bytes.
// Regions spanning many tile columns (full-width inference bands) are
// decoded in parallel: the x-range splits into tile-aligned column
// chunks sharded over the worker slots, each writing its chunk into the
// shared output with the region's row stride. Small regions stay on the
// single-thread slot-0 path (thread spawn would dominate).
int hipac_read_region(void* handle, int level, int64_t x, int64_t y,
                      int64_t w, int64_t hh, uint8_t* out) {
  auto* h = static_cast<Handle*>(handle);
  if (level < 0 || level >= static_cast<int>(h->levels.size())) {
    set_err("bad level");
    return -1;
  }
  const LevelInfo lv = h->levels[level];
  const int64_t tw = lv.tiled ? lv.tile_width : 0;
  int64_t tile_cols = lv.tiled && tw > 0 ? (w + tw - 1) / tw : 0;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int workers = std::max(1, std::min({hw, 16,
                                      static_cast<int>(tile_cols / 4)}));
  if (workers <= 1) {
    Slot* s = acquire_slot(h, 0);
    std::lock_guard<std::mutex> lock(s->mu);
    TIFF* tif = slot_tiff_locked(h, s);
    if (!tif) {
      set_err("cannot open worker TIFF handle");
      return -1;
    }
    return read_region_level(h, tif, lv, x, y, w, hh, out, w) ? 0 : -1;
  }

  // tile-aligned column chunks: chunk i covers x-range [c0, c1)
  const int64_t cols_per = ((tile_cols + workers - 1) / workers) * tw;
  std::atomic<int> failures(0);
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&, t]() {
      const int64_t c0 = t * cols_per;
      const int64_t c1 = std::min<int64_t>(w, c0 + cols_per);
      if (c0 >= c1) return;
      Slot* s = acquire_slot(h, static_cast<size_t>(t) + 1);
      std::lock_guard<std::mutex> lock(s->mu);
      TIFF* tif = slot_tiff_locked(h, s);
      if (!tif || !read_region_level(h, tif, lv, x + c0, y, c1 - c0, hh,
                                     out + c0 * 3, w)) {
        failures.fetch_add(1);
      }
    });
  }
  for (auto& t : threads) t.join();
  if (failures.load()) {
    set_err("parallel region read failed");
    return -1;
  }
  return 0;
}

// Configure the decoded-tile LRU cache (bytes; 0 disables). Applies per
// open handle; the default is 256 MB.
int hipac_set_cache_bytes(void* handle, int64_t bytes) {
  auto* h = static_cast<Handle*>(handle);
  if (bytes < 0) {
    set_err("negative cache size");
    return -1;
  }
  {
    std::lock_guard<std::mutex> lock(h->cache.mu);
    h->cache.capacity = static_cast<size_t>(bytes);
  }
  if (bytes == 0) h->cache.clear();
  return 0;
}

// Cache observability: decoded-tile hit/miss counters and resident bytes.
void hipac_cache_stats(void* handle, int64_t* hits, int64_t* misses,
                       int64_t* bytes) {
  auto* h = static_cast<Handle*>(handle);
  std::lock_guard<std::mutex> lock(h->cache.mu);
  *hits = static_cast<int64_t>(h->cache.hits);
  *misses = static_cast<int64_t>(h->cache.misses);
  *bytes = static_cast<int64_t>(h->cache.bytes);
}

// Batch region read sharded over worker threads.
// coords: n pairs of (x, y) level coordinates; out: n contiguous h*w*3
// regions. Returns 0 on full success, else the number of failed regions.
int hipac_read_regions(void* handle, int level, const int64_t* coords,
                       int64_t n, int64_t w, int64_t hh, uint8_t* out,
                       int num_threads) {
  auto* h = static_cast<Handle*>(handle);
  if (level < 0 || level >= static_cast<int>(h->levels.size())) {
    set_err("bad level");
    return -1;
  }
  const LevelInfo lv = h->levels[level];
  const size_t region_bytes = static_cast<size_t>(w) * hh * 3;
  int workers = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min<int>(workers, 16));
  workers = static_cast<int>(std::min<int64_t>(workers, n));

  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);

  // Batch workers use slots 1..workers (slot 0 stays free for concurrent
  // single-region reads); each decode holds its slot's mutex, so two
  // overlapping batch calls on one handle interleave safely too.
  auto work = [&](int slot) {
    Slot* s = acquire_slot(h, static_cast<size_t>(slot) + 1);
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) break;
      std::lock_guard<std::mutex> lock(s->mu);
      TIFF* tif = slot_tiff_locked(h, s);
      if (!tif) {
        failures.fetch_add(1);
        continue;
      }
      if (!read_region_level(h, tif, lv, coords[2 * i], coords[2 * i + 1], w,
                             hh, out + i * region_bytes, w)) {
        failures.fetch_add(1);
      }
    }
  };

  if (workers == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (int t = 0; t < workers; ++t) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// Write a tiled pyramidal TIFF (fixture generator / interop artifact).
// levels: n_levels pointers to RGB uint8 buffers of ws[i] x hs[i].
// compression: 0 = none, 1 = deflate (lossless), 2 = JPEG (the CAMELYON16
// production encoding — exercises the same decode path as real slides).
int hipac_write_pyramid(const char* path, const uint8_t** levels,
                        const int64_t* ws, const int64_t* hs, int n_levels,
                        int tile_size, int use_deflate) {
  TIFF* tif = TIFFOpen(path, "w8");  // BigTIFF
  if (!tif) {
    set_err(std::string("cannot create TIFF: ") + path);
    return -1;
  }
  std::vector<uint8_t> tile(static_cast<size_t>(tile_size) * tile_size * 3);
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int64_t w = ws[lvl], hgt = hs[lvl];
    TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, static_cast<uint32_t>(w));
    TIFFSetField(tif, TIFFTAG_IMAGELENGTH, static_cast<uint32_t>(hgt));
    TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 3);
    TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
    TIFFSetField(tif, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
    TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
    if (use_deflate == 3) {
      // the CAMELYON16 production encoding: chroma-subsampled YCbCr JPEG
      // tiles; RGB input auto-converts via JPEGCOLORMODE_RGB. The read
      // path (TIFFReadRGBATile) converts back transparently.
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_YCBCR);
      TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
      TIFFSetField(tif, TIFFTAG_JPEGQUALITY, 90);
      TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
      TIFFSetField(tif, TIFFTAG_YCBCRSUBSAMPLING, 2, 2);
    } else if (use_deflate == 2) {
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
      TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
      TIFFSetField(tif, TIFFTAG_JPEGQUALITY, 90);
    } else if (use_deflate == 1) {
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
      TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_ADOBE_DEFLATE);
    } else {
      TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
      TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_NONE);
    }
    TIFFSetField(tif, TIFFTAG_TILEWIDTH, static_cast<uint32_t>(tile_size));
    TIFFSetField(tif, TIFFTAG_TILELENGTH, static_cast<uint32_t>(tile_size));
    if (lvl > 0) TIFFSetField(tif, TIFFTAG_SUBFILETYPE, FILETYPE_REDUCEDIMAGE);

    for (int64_t ty = 0; ty < hgt; ty += tile_size) {
      for (int64_t tx = 0; tx < w; tx += tile_size) {
        std::memset(tile.data(), 255, tile.size());
        const int64_t cw = std::min<int64_t>(tile_size, w - tx);
        const int64_t ch = std::min<int64_t>(tile_size, hgt - ty);
        for (int64_t yy = 0; yy < ch; ++yy) {
          std::memcpy(tile.data() + (yy * tile_size) * 3,
                      levels[lvl] + ((ty + yy) * w + tx) * 3,
                      static_cast<size_t>(cw) * 3);
        }
        if (TIFFWriteTile(tif, tile.data(), static_cast<uint32_t>(tx),
                          static_cast<uint32_t>(ty), 0, 0) < 0) {
          set_err("TIFFWriteTile failed");
          TIFFClose(tif);
          return -1;
        }
      }
    }
    if (!TIFFWriteDirectory(tif)) {
      set_err("TIFFWriteDirectory failed");
      TIFFClose(tif);
      return -1;
    }
  }
  TIFFClose(tif);
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming pyramid writer: levels written in order, each as sequential
// row bands, so gigapixel fixtures (e.g. 97792x221184) can be fabricated
// with bounded memory — one band resident instead of the 65 GB level.
// ---------------------------------------------------------------------------

namespace {

struct Writer {
  TIFF* tif = nullptr;
  int tile_size = 256;
  int compression = 1;
  int64_t w = 0, h = 0;   // current level dims
  int64_t row_cursor = 0;  // next y0 expected by write_band
  bool in_level = false;
  std::vector<uint8_t> tile;
};

}  // namespace

void* hipac_writer_open(const char* path, int tile_size, int compression) {
  TIFF* tif = TIFFOpen(path, "w8");  // BigTIFF
  if (!tif) {
    set_err(std::string("cannot create TIFF: ") + path);
    return nullptr;
  }
  auto* wr = new Writer();
  wr->tif = tif;
  wr->tile_size = tile_size;
  wr->compression = compression;
  wr->tile.resize(static_cast<size_t>(tile_size) * tile_size * 3);
  return wr;
}

int hipac_writer_begin_level(void* writer, int64_t w, int64_t h,
                             int is_reduced) {
  auto* wr = static_cast<Writer*>(writer);
  if (wr->in_level) {
    set_err("begin_level while a level is open");
    return -1;
  }
  TIFF* tif = wr->tif;
  TIFFSetField(tif, TIFFTAG_IMAGEWIDTH, static_cast<uint32_t>(w));
  TIFFSetField(tif, TIFFTAG_IMAGELENGTH, static_cast<uint32_t>(h));
  TIFFSetField(tif, TIFFTAG_SAMPLESPERPIXEL, 3);
  TIFFSetField(tif, TIFFTAG_BITSPERSAMPLE, 8);
  TIFFSetField(tif, TIFFTAG_ORIENTATION, ORIENTATION_TOPLEFT);
  TIFFSetField(tif, TIFFTAG_PLANARCONFIG, PLANARCONFIG_CONTIG);
  if (wr->compression == 3) {
    // YCbCr JPEG (the CAMELYON16 production encoding) — see
    // hipac_write_pyramid
    TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_YCBCR);
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
    TIFFSetField(tif, TIFFTAG_JPEGQUALITY, 90);
    TIFFSetField(tif, TIFFTAG_JPEGCOLORMODE, JPEGCOLORMODE_RGB);
    TIFFSetField(tif, TIFFTAG_YCBCRSUBSAMPLING, 2, 2);
  } else if (wr->compression == 2) {
    TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_JPEG);
    TIFFSetField(tif, TIFFTAG_JPEGQUALITY, 90);
  } else if (wr->compression == 1) {
    TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_ADOBE_DEFLATE);
  } else {
    TIFFSetField(tif, TIFFTAG_PHOTOMETRIC, PHOTOMETRIC_RGB);
    TIFFSetField(tif, TIFFTAG_COMPRESSION, COMPRESSION_NONE);
  }
  TIFFSetField(tif, TIFFTAG_TILEWIDTH, static_cast<uint32_t>(wr->tile_size));
  TIFFSetField(tif, TIFFTAG_TILELENGTH, static_cast<uint32_t>(wr->tile_size));
  if (is_reduced) TIFFSetField(tif, TIFFTAG_SUBFILETYPE, FILETYPE_REDUCEDIMAGE);
  wr->w = w;
  wr->h = h;
  wr->row_cursor = 0;
  wr->in_level = true;
  return 0;
}

// buf: (rows, w, 3) uint8, appended at the current row cursor. rows must be
// a multiple of tile_size except for the final band of the level.
int hipac_writer_write_band(void* writer, int64_t rows, const uint8_t* buf) {
  auto* wr = static_cast<Writer*>(writer);
  if (!wr->in_level) {
    set_err("write_band outside a level");
    return -1;
  }
  const int ts = wr->tile_size;
  const int64_t y0 = wr->row_cursor;
  if (y0 % ts != 0) {
    set_err("band start not tile-aligned");
    return -1;
  }
  if (rows % ts != 0 && y0 + rows != wr->h) {
    set_err("band rows must be a tile multiple except the final band");
    return -1;
  }
  if (y0 + rows > wr->h) {
    set_err("band exceeds level height");
    return -1;
  }
  for (int64_t ty = 0; ty < rows; ty += ts) {
    const int64_t ch = std::min<int64_t>(ts, rows - ty);
    for (int64_t tx = 0; tx < wr->w; tx += ts) {
      std::memset(wr->tile.data(), 255, wr->tile.size());
      const int64_t cw = std::min<int64_t>(ts, wr->w - tx);
      for (int64_t yy = 0; yy < ch; ++yy) {
        std::memcpy(wr->tile.data() + (yy * ts) * 3,
                    buf + ((ty + yy) * wr->w + tx) * 3,
                    static_cast<size_t>(cw) * 3);
      }
      if (TIFFWriteTile(wr->tif, wr->tile.data(), static_cast<uint32_t>(tx),
                        static_cast<uint32_t>(y0 + ty), 0, 0) < 0) {
        set_err("TIFFWriteTile failed");
        return -1;
      }
    }
  }
  wr->row_cursor += rows;
  return 0;
}

int hipac_writer_end_level(void* writer) {
  auto* wr = static_cast<Writer*>(writer);
  if (!wr->in_level) {
    set_err("end_level outside a level");
    return -1;
  }
  if (wr->row_cursor != wr->h) {
    set_err("level ended before all rows were written");
    return -1;
  }
  wr->in_level = false;
  if (!TIFFWriteDirectory(wr->tif)) {
    set_err("TIFFWriteDirectory failed");
    return -1;
  }
  return 0;
}

int hipac_writer_close(void* writer) {
  auto* wr = static_cast<Writer*>(writer);
  int rc = 0;
  if (wr->in_level) {
    set_err("writer closed mid-level");
    rc = -1;
  }
  TIFFClose(wr->tif);
  delete wr;
  return rc;
}

}  // extern "C"
