// LZW decoding on the host for the GIF and TIFF readers (utils/gif.py,
// utils/tiff.py), as PIL decodes a GIF frame and libtiff a TIFF strip.
//
// Plain C ABI, loaded with ctypes:
//
//   int crdr_gif_lzw(data, n, bits, width, height, interlace, out, err,
//                    errlen)
//     data / n: the frame's image data from its first sub-block's length
//     byte; bits: the minimum code size (1-8); out: width * height indexes
//     the caller owns, written in the frame's row order (interlaced: rows
//     0, 8, ..., 4, 12, ..., 2, 6, ..., 1, 3, ...).
//     -> 0 when the frame is complete, 1 when an end code came first (the
//        rows not reached keep what out held), 2 when the data ran out
//        first, or -1 with the reason in err.
//   int crdr_tiff_lzw(data, n, out, out_n, err, errlen)
//     one strip or tile: MSB-first codes of 9-12 bits that widen one code
//     early (at 511, 1023, 2047), clear 256, end 257.
//     -> the bytes written (out_n unless the strip ends early), or -1.
//
// GIF follows PIL's GifDecode.c: codes LSB first over sub-blocks, the code
// size grows when the code just added is the last of its width (up to 12
// bits); a full table (4096) adds nothing until a clear code (the
// "deferred clear"); a stream may start without a clear code; a code past
// the next free one is corrupt, the next free one itself is KwKwK.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& why) {
  throw std::runtime_error(why);
}

constexpr int kTable = 4096;

int gif_lzw(const uint8_t* d, size_t n, int bits, int width, int height,
            int interlace, uint8_t* out) {
  if (bits < 1 || bits > 8)
    fail("GIF LZW minimum code size " + std::to_string(bits) +
         " (1-8 are read)");
  const int clear = 1 << bits, end = clear + 1;
  uint8_t data[kTable], stack[kTable];
  uint16_t link[kTable];
  for (int i = 0; i < clear; i++) data[i] = (uint8_t)i;
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int lastcode = -1, lastdata = 0;
  bool fresh = true;  // the first code after a clear (or the start)
  uint32_t bitbuf = 0;
  int bitcount = 0;
  size_t pos = 0, block = 0;
  // the row order: pass 0 (interlaced: 4 passes)
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  auto newline = [&]() -> bool {  // false once every row is written
    x = 0;
    y += step;
    while (y >= height) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    while (bitcount < codesize) {
      if (block > 0) {
        bitbuf |= (uint32_t)d[pos++] << bitcount;
        bitcount += 8;
        block--;
      } else {  // a new sub-block, read only when it is whole
        if (pos >= n || n - pos < (size_t)d[pos] + 1) return 2;
        block = d[pos++];
      }
    }
    int c = (int)(bitbuf & (uint32_t)codemask);
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      fresh = true;
      continue;
    }
    if (c == end) return 1;
    int len;
    const uint8_t* p;
    uint8_t one;
    if (fresh) {
      if (c > clear) fail("corrupt GIF LZW data (a code past the table)");
      lastdata = lastcode = c;
      fresh = false;
      one = (uint8_t)c;
      p = &one;
      len = 1;
    } else {
      int thiscode = c;
      if (c > next) fail("corrupt GIF LZW data (a code past the table)");
      int sp = kTable;
      if (c == next) {
        stack[--sp] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (sp <= 0 || c >= kTable) fail("corrupt GIF LZW data");
        stack[--sp] = data[c];
        c = link[c];
      }
      lastdata = c;
      if (sp <= 0) fail("corrupt GIF LZW data");
      stack[--sp] = (uint8_t)c;
      if (next < kTable) {
        data[next] = (uint8_t)c;
        link[next] = (uint16_t)lastcode;
        if (next == codemask && codesize < 12) {
          codesize++;
          codemask = (1 << codesize) - 1;
        }
        next++;
      }
      lastcode = thiscode;
      p = stack + sp;
      len = kTable - sp;
    }
    for (int i = 0; i < len; i++) {
      out[(size_t)y * width + x] = p[i];
      if (++x >= width && !newline()) return 0;
    }
  }
}

int64_t tiff_lzw(const uint8_t* d, size_t n, uint8_t* out, size_t out_n) {
  if (n >= 2 && d[0] == 0 && (d[1] & 1))
    fail("old-style (LSB-first) TIFF LZW data");
  const int kClear = 256, kEnd = 257;
  std::vector<uint16_t> link(kTable), length(kTable);
  std::vector<uint8_t> value(kTable);
  for (int i = 0; i < 256; i++) {
    value[i] = (uint8_t)i;
    length[i] = 1;
  }
  int nbits = 9, free_ent = 258, old = -1;
  uint64_t buf = 0;
  int count = 0;
  size_t pos = 0, o = 0;
  auto width_for = [](int free_ent) {
    return free_ent >= 2047 ? 12 : free_ent >= 1023 ? 11 : free_ent >= 511 ? 10 : 9;
  };
  std::vector<uint8_t> tmp(kTable + 1);  // a string and its KwKwK byte
  while (o < out_n) {
    while (count < nbits) {
      if (pos >= n) return (int64_t)o;  // the strip ends without its end code
      buf = (buf << 8) | d[pos++];
      count += 8;
    }
    int code = (int)((buf >> (count - nbits)) & ((1u << nbits) - 1));
    count -= nbits;
    if (code == kEnd) break;
    if (code == kClear) {
      free_ent = 258;
      nbits = 9;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) fail("corrupt TIFF LZW data (a code after a clear)");
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_ent || free_ent > kTable)
      fail("corrupt TIFF LZW data (a code past the table)");
    int c = code == free_ent ? old : code;
    int len = length[c];
    for (int k = len - 1, e = c; k >= 0; k--, e = link[e]) tmp[k] = value[e];
    int fc = tmp[0];
    if (code == free_ent) tmp[len++] = (uint8_t)fc;
    if (free_ent < kTable) {
      link[free_ent] = (uint16_t)old;
      value[free_ent] = (uint8_t)fc;
      length[free_ent] = (uint16_t)(length[old] + 1);
      free_ent++;
    }
    nbits = width_for(free_ent);
    size_t take = std::min((size_t)len, out_n - o);
    std::memcpy(out + o, tmp.data(), take);
    o += take;
    old = code;
  }
  return (int64_t)o;
}

}  // namespace

extern "C" {

int crdr_gif_lzw(const uint8_t* data, int64_t n, int bits, int width,
                 int height, int interlace, uint8_t* out, char* err,
                 int errlen) {
  try {
    return gif_lzw(data, (size_t)n, bits, width, height, interlace, out);
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

int64_t crdr_tiff_lzw(const uint8_t* data, int64_t n, uint8_t* out,
                      int64_t out_n, char* err, int errlen) {
  try {
    return tiff_lzw(data, (size_t)n, out, (size_t)out_n);
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
