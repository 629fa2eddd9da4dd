// PNG row unfilter for data/image_io.py's PNG decoder.
//
// A PNG's image data, once inflated, is `height` rows of one filter-type
// byte followed by `stride` bytes; each row's bytes are differences against
// a prediction from the pixel to the left (a), the one above (b) and the one
// above-left (c), `bpp` bytes apart (PNG spec, section 9: None, Sub, Up,
// Average, Paeth). Average and Paeth make every byte depend on the one
// before it in its row, so the loop runs here and not in Python.
//
// Built with native/colmap_reader.cc into one library by
// data/native_loader.py (g++ -O3 -fPIC -shared -std=c++17).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// raw: height * (1 + stride) bytes; out: height * stride bytes. Returns 0,
// or 1 + the index of the first row whose filter type is not 0-4 (rows
// before it are written).
extern "C" int64_t egs_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t height,
                                    int64_t stride, int32_t bpp) {
  const uint8_t* prev = nullptr;  // the row above, unfiltered; none for row 0
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t type = raw[y * (stride + 1)];
    const uint8_t* in = raw + y * (stride + 1) + 1;
    uint8_t* row = out + y * stride;
    switch (type) {
      case 0:
        std::memcpy(row, in, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = in[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) row[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          row[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          row[i] = in[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
    prev = row;
  }
  return 0;
}
