// PNG row unfiltering (host code).
//
// A PNG's image data, once inflated, is one filter-type byte followed by
// the filtered bytes of each row. This undoes the five filter types of the
// PNG specification (0 none, 1 sub, 2 up, 3 average, 4 Paeth) for 8-bit
// samples with 1 to 4 bytes per pixel. Average and Paeth depend on the
// byte just decoded to their left, so a row is one sequential pass; done
// in Python that pass costs seconds per megapixel, here milliseconds.
//
// Contract (mirrors utils/png.py::_unfilter_plain):
//   esr_png_unfilter(raw, H, stride, bpp, out) -> 0 on success, or
//   1 + the index of the first row with a filter type above 4;
//   raw holds H rows of 1 + stride bytes, out receives H rows of stride.
//
// Built by esrnerf_tpu_torch/ops/kernels.py (g++ -O3 -fPIC -shared) and
// loaded with ctypes.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

}  // namespace

extern "C" int64_t esr_png_unfilter(const uint8_t* raw, int64_t H,
                                    int64_t stride, int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above; none for row 0 (zeros)
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t ftype = raw[y * (stride + 1)];
    const uint8_t* line = raw + y * (stride + 1) + 1;
    uint8_t* cur = out + y * stride;
    switch (ftype) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) cur[i] = line[i];
        break;
      case 1:  // sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // up
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(line[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}
