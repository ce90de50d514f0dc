// PNG scanline unfiltering (PNG specification, filter method 0) for 8-bit,
// non-interlaced images.
//
// The one step of PNG decoding that numpy cannot vectorise: the Sub,
// Average and Paeth filters predict each byte from the byte one pixel to
// its left in the same, already unfiltered, row. Inflating the IDAT stream
// (Python's zlib) and the colour conversion stay in Python
// (pod_compare_tpu_torch/data/image_io.py, which also keeps a numpy version
// of this loop as the plain reference for the tests).
//
// Built with g++ into build/ by pod_compare_tpu_torch/native/__init__.py
// and bound with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

}  // namespace

extern "C" {

// raw: `height` rows of 1 + row_bytes bytes each, a filter-type byte then
// the filtered row, as inflated. out: height x row_bytes unfiltered bytes.
// bpp: bytes per complete pixel (1 to 8). Returns 0, or 1 + the index of
// the first row whose filter type is unknown.
int png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes, int64_t bpp,
                 uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t filter = raw[y * (row_bytes + 1)];
    const uint8_t* in = raw + y * (row_bytes + 1) + 1;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? cur - row_bytes : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, in, (size_t)row_bytes);
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(1 + y);
    }
  }
  return 0;
}

}  // extern "C"
