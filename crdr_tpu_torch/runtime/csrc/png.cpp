// PNG image data -> 8-bit RGB on the host, as cv2.imread (libpng) and
// PIL's convert("RGB") give it.
//
// Plain C ABI, loaded with ctypes (utils/png.py), which parses the chunks
// and inflates the image data with Python's zlib:
//
//   int crdr_png_decode(data, n, width, height, depth, color, interlace,
//                       plte, nplte, gray16_clip, out, err, errlen)
//     data / n: the inflated image data (the filtered rows of every pass);
//     depth, color, interlace: the IHDR fields; plte / nplte: the PLTE
//     entries (RGB triples) of a palette image;
//     out: a width * height * 3 buffer the caller owns.
//     -> 0, or -1 with the reason in err.
//
// Covers the five row filters, the seven passes of Adam7, every bit depth
// each colour type allows, palette expansion (an index past the palette is
// black, as in both readers) and gray expansion as libpng's
// png_set_expand_gray_1_2_4_to_8 does it (x255 / x85 / x17).  Alpha and
// tRNS are dropped, not composited.  16 bits come down to 8 by the high
// byte (libpng's png_set_strip_16, cv2), except 16-bit gray with
// gray16_clip set, which PIL's "I;16" -> "RGB" conversion clips to 255.
// Image data past what the image needs is ignored (libpng warns "Too much
// image data"); too little raises.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

// Adam7 passes: x start, y start, x step, y step
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};

int channels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  fail("invalid color type " + std::to_string(color));
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo one row's filter in place: cur holds the filtered bytes, prev the
// row above (zeros for a pass's first row), bpp the filter's byte step.
void unfilter(int kind, uint8_t* cur, const uint8_t* prev, size_t len,
              int bpp) {
  switch (kind) {
    case 0:
      return;
    case 1:
      for (size_t i = bpp; i < len; i++) cur[i] += cur[i - bpp];
      return;
    case 2:
      for (size_t i = 0; i < len; i++) cur[i] += prev[i];
      return;
    case 3:
      for (size_t i = 0; i < len; i++) {
        int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
        cur[i] += (uint8_t)((a + prev[i]) >> 1);
      }
      return;
    case 4:
      for (size_t i = 0; i < len; i++) {
        int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
        int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
        cur[i] += (uint8_t)paeth(a, prev[i], c);
      }
      return;
  }
  fail("unknown PNG row filter " + std::to_string(kind));
}

struct Image {
  int width, height, depth, color, ch;
  const uint8_t* plte;
  int nplte;
  bool gray16_clip;
  uint8_t* out;

  // one unfiltered row of a pass -> the RGB pixels at (y, x0 + i * dx)
  void emit(const uint8_t* row, int pw, int y, int x0, int dx) const {
    uint8_t* o = out + ((size_t)y * width + x0) * 3;
    const size_t step = (size_t)dx * 3;
    if (depth < 8) {
      const int mask = (1 << depth) - 1;
      const int scale = 255 / mask;
      for (int i = 0; i < pw; i++, o += step) {
        int bit = i * depth;
        int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
        if (color == 3) {
          put_index(o, v);
        } else {
          o[0] = o[1] = o[2] = (uint8_t)(v * scale);
        }
      }
      return;
    }
    const int bytes = depth / 8;  // 1 or 2; the high byte comes first
    const int px = ch * bytes;
    for (int i = 0; i < pw; i++, o += step, row += px) {
      switch (color) {
        case 0:
        case 4:
          if (bytes == 2 && gray16_clip && color == 0) {
            int v = (row[0] << 8) | row[1];
            o[0] = o[1] = o[2] = (uint8_t)std::min(v, 255);
          } else {
            o[0] = o[1] = o[2] = row[0];
          }
          break;
        case 3:
          put_index(o, row[0]);
          break;
        default:  // 2, 6
          o[0] = row[0];
          o[1] = row[bytes];
          o[2] = row[2 * bytes];
      }
    }
  }

  void put_index(uint8_t* o, int v) const {
    if (v < nplte) {
      std::memcpy(o, plte + 3 * v, 3);
    } else {
      o[0] = o[1] = o[2] = 0;
    }
  }
};

void decode(const uint8_t* data, size_t n, const Image& img, int interlace) {
  const int bits = img.ch * img.depth;
  const int bpp = std::max(1, bits / 8);
  const int npass = interlace ? 7 : 1;
  const int whole[4] = {0, 0, 1, 1};
  size_t pos = 0;
  std::vector<uint8_t> cur, prev;
  for (int p = 0; p < npass; p++) {
    const int* a = interlace ? kAdam7[p] : whole;
    int pw = img.width > a[0] ? (img.width - a[0] + a[2] - 1) / a[2] : 0;
    int ph = img.height > a[1] ? (img.height - a[1] + a[3] - 1) / a[3] : 0;
    if (pw == 0 || ph == 0) continue;  // an empty pass has no bytes
    size_t len = ((size_t)pw * bits + 7) / 8;
    cur.assign(len, 0);
    prev.assign(len, 0);
    for (int r = 0; r < ph; r++) {
      if (pos + len + 1 > n) fail("truncated image data");
      int kind = data[pos];
      std::memcpy(cur.data(), data + pos + 1, len);
      pos += len + 1;
      unfilter(kind, cur.data(), prev.data(), len, bpp);
      img.emit(cur.data(), pw, a[1] + r * a[3], a[0], a[2]);
      std::swap(cur, prev);
    }
  }
}

}  // namespace

extern "C" {

int crdr_png_decode(const uint8_t* data, int64_t n, int width, int height,
                    int depth, int color, int interlace, const uint8_t* plte,
                    int nplte, int gray16_clip, uint8_t* out, char* err,
                    int errlen) {
  try {
    Image img{width, height, depth, color, channels(color), plte, nplte,
              gray16_clip != 0, out};
    decode(data, (size_t)n, img, interlace);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
