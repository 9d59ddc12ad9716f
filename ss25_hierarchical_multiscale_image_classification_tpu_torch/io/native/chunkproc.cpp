// Chunk-parallel host preprocessing.
//
// TPU-native equivalent of the reference's standalone OpenMP tile
// processor (src/preprocessing/parallel-prog/chunk-based-proc.cpp:1-58),
// pointed at the pipeline's real host-side hot loops instead of a demo
// volume: per-patch tissue statistics, grid patchification of a decoded
// level plane, and packed uint8 gather for the input pipeline. Dynamic
// scheduling mirrors the reference's heterogeneity-aware intent — the
// runtime balances uneven tile costs instead of hardcoding P-core tile
// sizes.

#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Mean intensity per patch over all bytes (the tissue filter statistic,
// reference src/main.py:718: mean over H*W*3).
void hipac_patch_means(const uint8_t* patches, int64_t n,
                       int64_t patch_bytes, float* means) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = patches + i * patch_bytes;
    uint64_t sum = 0;
    for (int64_t j = 0; j < patch_bytes; ++j) sum += p[j];
    means[i] = static_cast<float>(sum) / static_cast<float>(patch_bytes);
  }
}

// Cut a decoded (H, W, 3) level plane into the non-overlapping patch grid
// with white pad-to-grid (reference src/main.py:658-703), writing patches
// in x-major reference order. coords_out receives (x, y) level coords.
// Returns the number of patches written.
int64_t hipac_patchify(const uint8_t* plane, int64_t width, int64_t height,
                       int64_t patch_size, uint8_t* patches_out,
                       int64_t* coords_out) {
  const int64_t nx = (width + patch_size - 1) / patch_size;
  const int64_t ny = (height + patch_size - 1) / patch_size;
  const int64_t n = nx * ny;
  const int64_t patch_bytes = patch_size * patch_size * 3;

#pragma omp parallel for collapse(2) schedule(dynamic)
  for (int64_t gx = 0; gx < nx; ++gx) {
    for (int64_t gy = 0; gy < ny; ++gy) {
      const int64_t idx = gx * ny + gy;  // x-major (main.py:682-686)
      const int64_t x = gx * patch_size, y = gy * patch_size;
      coords_out[2 * idx] = x;
      coords_out[2 * idx + 1] = y;
      uint8_t* dst = patches_out + idx * patch_bytes;
      const int64_t cw = std::min(patch_size, width - x);
      const int64_t ch = std::min(patch_size, height - y);
      std::memset(dst, 255, static_cast<size_t>(patch_bytes));
      for (int64_t yy = 0; yy < ch; ++yy) {
        std::memcpy(dst + (yy * patch_size) * 3,
                    plane + ((y + yy) * width + x) * 3,
                    static_cast<size_t>(cw) * 3);
      }
    }
  }
  return n;
}

// Gather rows from a packed (N, patch_bytes) uint8 store into a batch
// buffer — the host half of the training input pipeline.
void hipac_gather_rows(const uint8_t* store, const int64_t* indices,
                       int64_t batch, int64_t patch_bytes, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < batch; ++i) {
    std::memcpy(out + i * patch_bytes, store + indices[i] * patch_bytes,
                static_cast<size_t>(patch_bytes));
  }
}

// Gather rows from a packed (N, P, P, 3) uint8 store directly into the
// stem's space-to-depth batch layout (B, P/2, P/2, 12):
//   out[Y, X, (r*2+rx)*3 + c] = in[2Y+r, 2X+rx, c]
// so the int8 inference stem (a 4x4/stride-1 conv over 12 input channels,
// models/quantized.py) consumes the batch with NO on-device transpose.
// For each output row Y the four input (r, rx) taps group into two 6-byte
// runs per X: row 2Y bytes [6X, 6X+6) -> out [12X, 12X+6), and row 2Y+1
// bytes [6X, 6X+6) -> out [12X+6, 12X+12) — a pure interleave copy.
void hipac_gather_rows_s2d(const uint8_t* store, const int64_t* indices,
                           int64_t batch, int64_t patch, uint8_t* out) {
  const int64_t half = patch / 2;
  const int64_t row_in = patch * 3;          // input row stride (bytes)
  const int64_t row_out = half * 12;         // output row stride (bytes)
  const int64_t patch_bytes = patch * row_in;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t i = 0; i < batch; ++i) {
    for (int64_t Y = 0; Y < half; ++Y) {
      const uint8_t* src = store + indices[i] * patch_bytes + 2 * Y * row_in;
      uint8_t* dst = out + (i * half + Y) * row_out;
      for (int64_t X = 0; X < half; ++X) {
        std::memcpy(dst + 12 * X, src + 6 * X, 6);
        std::memcpy(dst + 12 * X + 6, src + row_in + 6 * X, 6);
      }
    }
  }
}

int hipac_omp_max_threads() { return omp_get_max_threads(); }

}  // extern "C"
