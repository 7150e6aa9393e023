// Run-length decoding on the host for the Sun raster and Radiance readers
// (utils/sunras.py, utils/hdr.py), as PIL's SunRleDecode.c reads a Sun
// raster body and OpenCV's rgbe.cpp a Radiance file's scanlines.
//
// Plain C ABI, loaded with ctypes:
//
//   int64 crdr_sun_rle(data, n, line, rows, out, err, errlen)
//     data / n: the image data after the header and colour map; line: the
//     bytes a row holds (unpadded); out: line * rows bytes the caller owns.
//     A byte 0x80 starts an escape: 0x80 0x00 is one 0x80, 0x80 k v is
//     k + 1 copies of v; any other byte is itself.  Runs carry over from a
//     row into the next.  -> the bytes of data read, or -1 with the reason
//     in err (the data ends before the last row).
//   int crdr_hdr_rle(data, n, width, height, out, err, errlen)
//     data / n: the pixels after the resolution line; out: width * height
//     RGBE quadruples the caller owns.  Each scanline starts 2 2 hi lo
//     (its width) and holds its four channels in turn, each as runs (a
//     count past 128: count - 128 copies of the next byte) and literals (a
//     count of 1-128, then that many bytes); a scanline that does not
//     start so ends the run-length coding, and it and the rest of the image
//     are flat quadruples.  Widths under 8 or past 32767 are flat from the
//     start.  -> 0, or -1 with the reason in err (a run of 0 or past the
//     scanline, another width, data that ends early).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>

namespace {

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

int64_t sun_rle(const uint8_t* d, int64_t n, int64_t line, int64_t rows,
                uint8_t* out) {
  const int64_t total = line * rows;
  int64_t x = 0, pos = 0;
  while (x < total) {
    if (pos >= n) fail("truncated Sun raster run-length data");
    if (d[pos] != 0x80) {
      out[x++] = d[pos++];
      continue;
    }
    if (pos + 2 > n) fail("truncated Sun raster run-length data");
    int k = d[pos + 1];
    if (k == 0) {
      out[x++] = 0x80;
      pos += 2;
      continue;
    }
    if (pos + 3 > n) fail("truncated Sun raster run-length data");
    int64_t count = k + 1;
    if (count > total - x) count = total - x;
    std::memset(out + x, d[pos + 2], (size_t)count);
    x += count;
    pos += 3;
  }
  return pos;
}

void hdr_rle(const uint8_t* d, int64_t n, int width, int height,
             uint8_t* out) {
  int64_t pos = 0;
  const int64_t total = (int64_t)width * height * 4;
  auto flat = [&](int64_t at) {
    if (n - pos < total - at)
      fail("truncated Radiance pixels (" + std::to_string(n - pos) +
           " bytes for " + std::to_string(total - at) + ")");
    std::memcpy(out + at, d + pos, (size_t)(total - at));
  };
  if (width < 8 || width > 0x7fff) return flat(0);
  for (int y = 0; y < height; y++) {
    if (n - pos < 4) fail("truncated Radiance scanline");
    const uint8_t* q = d + pos;
    if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80))
      return flat((int64_t)y * width * 4);  // flat from here on
    if (((q[2] << 8) | q[3]) != width)
      fail("Radiance scanline of width " + std::to_string((q[2] << 8) | q[3]) +
           " in an image " + std::to_string(width) + " wide");
    pos += 4;
    uint8_t* row = out + (int64_t)y * width * 4;
    for (int c = 0; c < 4; c++) {
      int x = 0;
      while (x < width) {
        if (n - pos < 2) fail("truncated Radiance scanline");
        int code = d[pos], v = d[pos + 1];
        pos += 2;
        int count = code > 128 ? code - 128 : code;
        if (count == 0 || count > width - x)
          fail("bad Radiance scanline data (a run of " +
               std::to_string(count) + " at " + std::to_string(x) + " of " +
               std::to_string(width) + ")");
        if (code > 128) {
          for (int i = 0; i < count; i++) row[(x + i) * 4 + c] = (uint8_t)v;
        } else {
          row[x * 4 + c] = (uint8_t)v;
          if (n - pos < count - 1) fail("truncated Radiance scanline");
          for (int i = 1; i < count; i++) row[(x + i) * 4 + c] = d[pos++];
        }
        x += count;
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t crdr_sun_rle(const uint8_t* data, int64_t n, int64_t line,
                     int64_t rows, uint8_t* out, char* err, int errlen) {
  try {
    return sun_rle(data, n, line, rows, out);
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

int crdr_hdr_rle(const uint8_t* data, int64_t n, int width, int height,
                 uint8_t* out, char* err, int errlen) {
  try {
    hdr_rle(data, n, width, height, out);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
