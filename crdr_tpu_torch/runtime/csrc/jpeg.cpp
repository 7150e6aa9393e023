// Baseline and progressive JPEG decoding on the host, Huffman or
// arithmetic-coded, byte-equal to libjpeg-turbo 3.1's default
// decompression (block smoothing, the islow IDCT as its SIMD paths run it,
// fancy upsampling, jdcolor.c's fixed-point YCbCr -> RGB), as cv2.imread
// and PIL run it.
//
// Plain C ABI, loaded with ctypes (utils/jpeg.py):
//
//   uint8_t* crdr_jpeg_decode(data, n, cmyk_mode, partial, space, &w, &h,
//                             &orientation, err, errlen)
//     -> a malloc'ed w*h*3 RGB buffer (free it with crdr_jpeg_free), or
//        NULL with the reason in err.
//
// cmyk_mode picks how a 4-component (CMYK / YCCK) image becomes RGB:
//   0: cv2's way (libjpeg's CMYK, then c = k - ((255 - c) * k >> 8));
//   1: PIL's way (Adobe-inverted CMYK, then nk - (c' * nk) / 255 rounded).
// space, when not -1, is the colour space a container says (0 gray, 1
// YCbCr, 2 RGB: libtiff's JPEG codec), in place of the markers'.
// orientation is the EXIF orientation tag of the first "Exif" APP1 (1 when
// there is none); the caller applies it or not.
//
// partial set (cv2.imread's file path): a file that ends early decodes as
// libjpeg-turbo decodes it after "Premature end of JPEG file", its source
// manager feeding a fake EOI (FF D9 FF D9 ...) past the end, which a marker
// segment the data ended in reads as its rest: in a Huffman scan the MCU
// the data ran out in is decoded with zero bits and the scan's later MCUs
// and every later scan are skipped (their coefficients stay as earlier
// scans left them, zero if none: gray 128); an arithmetic scan decodes on
// from zero bytes; a component that never had a scan is gray.  Unset (PIL's
// body path), such a file raises, as PIL raises.
//
// Block smoothing (jdcoefct.c smoothing_ok, decompress_smooth_data): a
// progressive image whose every component has some DC and a low (first 10
// in zigzag order) coefficient not known exactly has those coefficients,
// where still zero, estimated from the DC of a 5x5 window of blocks, and
// the DC too where no AC is known; an iMCU row past the one a truncated
// scan ran out in takes the coefficient states from before that scan.
//
// Raises (returns NULL) on what libjpeg-turbo refuses and what this does
// not reproduce: 12-bit precision, lossless and hierarchical frames,
// corrupt Huffman data (libjpeg warns and decodes on).

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

// zigzag index -> natural index; 16 extra entries catch a corrupt run past
// 63 as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed
// probability 0.5 of jdarith.c's fixed_bin
#define QE(i, qe, nlps, nmps, sw) \
  (((int64_t)(qe) << 16) | ((int64_t)(nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAriTab[114] = {
    QE(0, 0x5a1d, 1, 1, 1),      QE(1, 0x2586, 14, 2, 0),
    QE(2, 0x1114, 16, 3, 0),     QE(3, 0x080b, 18, 4, 0),
    QE(4, 0x03d8, 20, 5, 0),     QE(5, 0x01da, 23, 6, 0),
    QE(6, 0x00e5, 25, 7, 0),     QE(7, 0x006f, 28, 8, 0),
    QE(8, 0x0036, 30, 9, 0),     QE(9, 0x001a, 33, 10, 0),
    QE(10, 0x000d, 35, 11, 0),   QE(11, 0x0006, 9, 12, 0),
    QE(12, 0x0003, 10, 13, 0),   QE(13, 0x0001, 12, 13, 0),
    QE(14, 0x5a7f, 15, 15, 1),   QE(15, 0x3f25, 36, 16, 0),
    QE(16, 0x2cf2, 38, 17, 0),   QE(17, 0x207c, 39, 18, 0),
    QE(18, 0x17b9, 40, 19, 0),   QE(19, 0x1182, 42, 20, 0),
    QE(20, 0x0cef, 43, 21, 0),   QE(21, 0x09a1, 45, 22, 0),
    QE(22, 0x072f, 46, 23, 0),   QE(23, 0x055c, 48, 24, 0),
    QE(24, 0x0406, 49, 25, 0),   QE(25, 0x0303, 51, 26, 0),
    QE(26, 0x0240, 52, 27, 0),   QE(27, 0x01b1, 54, 28, 0),
    QE(28, 0x0144, 56, 29, 0),   QE(29, 0x00f5, 57, 30, 0),
    QE(30, 0x00b7, 59, 31, 0),   QE(31, 0x008a, 60, 32, 0),
    QE(32, 0x0068, 62, 33, 0),   QE(33, 0x004e, 63, 34, 0),
    QE(34, 0x003b, 32, 35, 0),   QE(35, 0x002c, 33, 9, 0),
    QE(36, 0x5ae1, 37, 37, 1),   QE(37, 0x484c, 64, 38, 0),
    QE(38, 0x3a0d, 65, 39, 0),   QE(39, 0x2ef1, 67, 40, 0),
    QE(40, 0x261f, 68, 41, 0),   QE(41, 0x1f33, 69, 42, 0),
    QE(42, 0x19a8, 70, 43, 0),   QE(43, 0x1518, 72, 44, 0),
    QE(44, 0x1177, 73, 45, 0),   QE(45, 0x0e74, 74, 46, 0),
    QE(46, 0x0bfb, 75, 47, 0),   QE(47, 0x09f8, 77, 48, 0),
    QE(48, 0x0861, 78, 49, 0),   QE(49, 0x0706, 79, 50, 0),
    QE(50, 0x05cd, 48, 51, 0),   QE(51, 0x04de, 50, 52, 0),
    QE(52, 0x040f, 50, 53, 0),   QE(53, 0x0363, 51, 54, 0),
    QE(54, 0x02d4, 52, 55, 0),   QE(55, 0x025c, 53, 56, 0),
    QE(56, 0x01f8, 54, 57, 0),   QE(57, 0x01a4, 55, 58, 0),
    QE(58, 0x0160, 56, 59, 0),   QE(59, 0x0125, 57, 60, 0),
    QE(60, 0x00f6, 58, 61, 0),   QE(61, 0x00cb, 59, 62, 0),
    QE(62, 0x00ab, 61, 63, 0),   QE(63, 0x008f, 61, 32, 0),
    QE(64, 0x5b12, 65, 65, 1),   QE(65, 0x4d04, 80, 66, 0),
    QE(66, 0x412c, 81, 67, 0),   QE(67, 0x37d8, 82, 68, 0),
    QE(68, 0x2fe8, 83, 69, 0),   QE(69, 0x293c, 84, 70, 0),
    QE(70, 0x2379, 86, 71, 0),   QE(71, 0x1edf, 87, 72, 0),
    QE(72, 0x1aa9, 87, 73, 0),   QE(73, 0x174e, 72, 74, 0),
    QE(74, 0x1424, 72, 75, 0),   QE(75, 0x119c, 74, 76, 0),
    QE(76, 0x0f6b, 74, 77, 0),   QE(77, 0x0d51, 75, 78, 0),
    QE(78, 0x0bb6, 77, 79, 0),   QE(79, 0x0a40, 77, 48, 0),
    QE(80, 0x5832, 80, 81, 1),   QE(81, 0x4d1c, 88, 82, 0),
    QE(82, 0x438e, 89, 83, 0),   QE(83, 0x3bdd, 90, 84, 0),
    QE(84, 0x34ee, 91, 85, 0),   QE(85, 0x2eae, 92, 86, 0),
    QE(86, 0x299a, 93, 87, 0),   QE(87, 0x2516, 86, 71, 0),
    QE(88, 0x5570, 88, 89, 1),   QE(89, 0x4ca9, 95, 90, 0),
    QE(90, 0x44d9, 96, 91, 0),   QE(91, 0x3e22, 97, 92, 0),
    QE(92, 0x3824, 99, 93, 0),   QE(93, 0x32b4, 99, 94, 0),
    QE(94, 0x2e17, 93, 86, 0),   QE(95, 0x56a8, 95, 96, 1),
    QE(96, 0x4f46, 101, 97, 0),  QE(97, 0x47e5, 102, 98, 0),
    QE(98, 0x41cf, 103, 99, 0),  QE(99, 0x3c3d, 104, 100, 0),
    QE(100, 0x375e, 99, 93, 0),  QE(101, 0x5231, 105, 102, 0),
    QE(102, 0x4c0f, 106, 103, 0), QE(103, 0x4639, 107, 104, 0),
    QE(104, 0x415e, 103, 99, 0), QE(105, 0x5627, 105, 106, 1),
    QE(106, 0x50e7, 108, 107, 0), QE(107, 0x4b85, 109, 103, 0),
    QE(108, 0x5597, 110, 109, 0), QE(109, 0x504f, 111, 107, 0),
    QE(110, 0x5a10, 110, 111, 1), QE(111, 0x5522, 112, 109, 0),
    QE(112, 0x59eb, 112, 111, 1), QE(113, 0x5a1d, 113, 113, 0)};
#undef QE

// jdarith.c's decoder state for one scan: the C and A registers, the
// statistics bins, and the input as jdarith.c reads it (stuffed FF 00 ->
// FF; at a marker, or past the end where libjpeg's source manager feeds a
// fake EOI, zero bytes from then on)
struct Arith {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  bool partial = false;
  bool at_marker = false;  // jdarith.c's unread_marker
  size_t marker_pos = 0;   // where that marker's FF is
  int64_t c = 0, a = 0;
  int ct = -16;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  int byte() {
    if (pos >= n) {
      if (!partial) fail("truncated data (the file ends inside a scan)");
      return (pos++ - n) % 2 ? 0xD9 : 0xFF;  // the fake EOI, over and over
    }
    return d[pos++];
  }
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  // jdarith.c arith_decode: one binary decision with the bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!at_marker) {
          data = byte();
          if (data == 0xFF) {
            size_t ff = pos - 1;
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              at_marker = true;
              marker_pos = ff;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* bits, const uint8_t* huffval, int nvals,
             bool is_dc) {
    std::memcpy(vals, huffval, nvals);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("bogus Huffman table definition");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l - 1]; i++, p++) {
        int lookbits = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); c++) {
          look_len[lookbits + c] = (uint8_t)l;
          look_sym[lookbits + c] = huffval[p];
        }
      }
    }
    if (is_dc)
      for (int i = 0; i < nvals; i++)
        if (huffval[i] > 15) fail("bogus DC Huffman table (symbol > 15)");
    present = true;
  }
};

// MSB-first entropy-coded segment reader: stuffed 0xFF00 -> 0xFF; at a
// marker (or the end of the data) it feeds zero bits, and consuming any
// of those is an error (truncated or corrupt data), or with partial set
// at the end of the data, ran_out.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int bits = 0;  // bits held in buf
  int fake = 0;  // of those, zero bits fed past a marker or the end
  bool stopped = false;
  bool partial = false, ran_out = false;

  // the byte at p: past the end, libjpeg's source manager's fake EOI
  // (FF D9 FF D9 ...) where partial is set, else -1
  int at(size_t p) const {
    if (p < n) return d[p];
    return partial ? ((p - n) % 2 ? 0xD9 : 0xFF) : -1;
  }
  void fill() {
    while (bits <= 56) {
      if (!stopped && pos < n && d[pos] != 0xFF) {  // a plain data byte
        buf = (buf << 8) | d[pos++];
        bits += 8;
        continue;
      }
      int b = stopped ? -1 : at(pos);
      if (b == 0xFF) {
        size_t q = pos + 1;
        while (at(q) == 0xFF) q++;
        if (at(q) == 0x00) {
          pos = q + 1;  // a stuffed data byte 0xFF
        } else {  // a marker (or the end of the data): zero bits from here
          pos = at(q) < 0 ? n : q - 1;
          stopped = true;
          b = -1;
        }
      } else if (b >= 0) {
        pos++;
      }
      if (b < 0) {
        stopped = true;
        fake += 8;
        b = 0;
      }
      buf = (buf << 8) | (uint64_t)b;
      bits += 8;
    }
  }
  void consume(int k) {
    bits -= k;
    if (bits < fake) {
      if (pos >= n && partial) {
        ran_out = true;  // libjpeg fills with zero bits and warns
        return;
      }
      fail(pos >= n ? "truncated data (the file ends inside a scan)"
                    : "corrupt data (a marker inside a scan's entropy data)");
    }
  }
  int peek(int k) {
    if (bits < k) fill();
    return (int)((buf >> (bits - k)) & ((1u << k) - 1));
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    consume(k);
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int look = (int)((buf >> (bits - kLookBits)) & ((1 << kLookBits) - 1));
    int l = h.look_len[look];
    if (l) {
      consume(l);
      return h.look_sym[look];
    }
    for (l = kLookBits + 1; l <= 16; l++) {
      int code = (int)((buf >> (bits - l)) & ((1u << l) - 1));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[code + h.valoffset[l]];
      }
    }
    fail("corrupt data (a Huffman code of more than 16 bits)");
  }
  void reset() {  // drop the rest of the segment's bits (restart, scan end)
    buf = 0;
    bits = 0;
    fake = 0;
    stopped = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks allocated (whole MCUs)
  int wblocks = 0, hblocks = 0;  // blocks holding image data
  int dw = 0, dh = 0;          // downsampled width, height
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  uint16_t quant[64];
  bool latched = false;
  int dc_pred = 0;
  int bits_known[64];          // successive-approximation state (-1 none)
  int prev_bits[10];           // bits_known[0..9] before its last scan
  int latch[10], latch_prev[10];  // jdcoefct.c's coef_bits_latch
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool exif_seen = false;
  bool partial = false;  // read a truncated file as libjpeg does
  int scans = 0;
  int last_good_row = 0;  // jdcoefct.c's last_good_iMCU_row
  int force_space = -1;   // a Space the caller sets (libtiff), else -1
  bool arith = false;     // arithmetic coding (SOF9, SOF10)
  uint8_t dac_l[16], dac_u[16], dac_k[16];  // DAC conditioning
  bool smooth = false;    // block smoothing on output (smoothing_ok)

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {
    for (int i = 0; i < 16; i++) {  // T.81's defaults, as SOI resets them
      dac_l[i] = 0;
      dac_u[i] = 1;
      dac_k[i] = 5;
    }
  }

  int u8() {
    if (pos >= n) {
      // past the end libjpeg's source manager feeds a fake EOI, FF D9 FF
      // D9 ..., which a marker segment the data ended in reads as its rest
      if (partial) return (pos++ - n) % 2 ? 0xD9 : 0xFF;
      fail("truncated data (the file ends inside a header)");
    }
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // the next marker code, skipping bytes that are not one (libjpeg warns
  // and skips them too)
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) {
        if (partial) return 0xD9;  // libjpeg's fake EOI past the end
        fail("truncated data (no EOI marker)");
      }
      int c = d[pos++];
      if (c != 0) return c;
    }
  }

  void parse_exif(const uint8_t* p, int len) {
    exif_seen = true;
    if (len < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    int tl = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](int o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](int o) -> uint32_t {
      return le ? ((uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) |
                   ((uint32_t)t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24))
                : (((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) |
                   ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3]);
    };
    if (r16(2) != 42) return;
    uint32_t ifd = r32(4);
    if (ifd + 2 > (uint32_t)tl) return;
    int count = r16((int)ifd);
    for (int i = 0; i < count; i++) {
      uint32_t e = ifd + 2 + 12 * (uint32_t)i;
      if (e + 12 > (uint32_t)tl) return;
      if (r16((int)e) == 0x0112) {
        int type = r16((int)e + 2);
        int v = type == 3 ? r16((int)e + 8)
                          : (type == 4 ? (int)r32((int)e + 8) : 0);
        if (v >= 1 && v <= 8) orientation = v;
        return;
      }
    }
  }

  void parse_app(int marker, int len) {
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    if (marker == 0xE1 && !exif_seen && len >= 6 &&
        std::memcmp(p, "Exif\0\0", 6) == 0)
      parse_exif(p, len);
  }

  void parse_dqt(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad quantization table");
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      qt_present[tq] = true;
    }
    if (pos != end) fail("bad DQT marker length");
  }

  void parse_dht(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table");
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; i++) total += bits[i] = (uint8_t)u8();
      if (total > 256 || pos + total > end) fail("bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = (uint8_t)u8();
      (tc ? ac : dc)[th].build(bits, vals, total, tc == 0);
    }
    if (pos != end) fail("bad DHT marker length");
  }

  // jdmarker.c get_dac: arithmetic conditioning of DC tables 0-15 (L, U)
  // and AC tables 16-31 (K)
  void parse_dac(int len) {
    size_t end = pos + len;
    while (pos + 1 < end) {
      int index = u8(), val = u8();
      if (index >= 32) fail("bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        dac_k[index - 16] = (uint8_t)val;
      } else {
        dac_l[index] = (uint8_t)(val & 15);
        dac_u[index] = (uint8_t)(val >> 4);
        if (dac_l[index] > dac_u[index]) fail("bad DAC value");
      }
    }
    if (pos != end) fail("bad DAC marker length");
  }

  void parse_sof(int marker, int len) {
    if (frame) fail("more than one frame (SOF) marker");
    size_t end = pos + len;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit samples (only 8-bit JPEG is read)");
    if (height == 0) fail("a frame height of 0 (DNL) is not supported");
    if (width == 0) fail("a frame width of 0");
    if ((int64_t)width * height > (int64_t)1 << 30)
      fail("image too large");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(std::to_string(ncomp) + " components (1, 3 or 4 are read)");
    if (len != 6 + 3 * ncomp) fail("bad SOF marker length");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or quantization table number");
    }
    if (pos != end) fail("bad SOF marker length");
    progressive = marker == 0xC2 || marker == 0xCA;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.bits_known[k] = -1;
      for (int k = 0; k < 10; k++) c.prev_bits[k] = -1;
    }
    frame = true;
  }

  // -------------------------------------------------------------- scans
  void decode_block_baseline(BitReader& br, Component& c, int16_t* blk,
                             const Huffman& hd, const Huffman& ha) {
    int s = br.decode(hd);
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      s = br.decode(ha);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void parse_sos(int len) {
    if (!frame) fail("SOS before SOF");
    size_t end = pos + len;
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail("bad SOS marker");
    Component* sc[4];
    int tdc[4], tac[4];
    for (int i = 0; i < ns; i++) {
      int cid = u8(), t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) fail("SOS names an unknown component");
      tdc[i] = t >> 4;
      tac[i] = t & 15;
      if (!arith && (tdc[i] > 3 || tac[i] > 3))
        fail("bad Huffman table number");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (pos != end) fail("bad SOS marker length");
    if (progressive) {
      if (ss > 63 || se > 63 || ss > se || ah > 13 || al > 13 ||
          (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          (arith && ah != 0 && al != ah - 1))
        fail("bad progressive scan parameters");
    }  // a sequential scan's Ss, Se, Ah, Al: libjpeg warns and ignores them
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a table at its first scan
        if (!qt_present[c.tq]) fail("a quantization table is missing");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      c.dc_pred = 0;
      bool need_dc = ss == 0 && ah == 0, need_ac = !progressive || ss > 0;
      if (!arith && ((need_dc && !dc[tdc[i]].present) ||
                     (need_ac && !ac[tac[i]].present)))
        fail("a Huffman table is missing");
      if (progressive) {
        // jdphuff.c start_pass_phuff_decoder: the state before this scan
        // (0 at the first scan), then the scan's own
        for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); k++)
          c.prev_bits[k] = scans > 0 ? c.bits_known[k] : 0;
        for (int k = ss; k <= se; k++) c.bits_known[k] = al;
      }
    }
    if (!progressive)
      for (int i = 0; i < ns; i++)
        for (int k = 0; k < 64; k++) sc[i]->bits_known[k] = 0;

    scans++;
    if (arith) {
      scan_arith(sc, ns, tdc, tac, ss, se, ah, al);
      return;
    }
    BitReader br;
    br.d = d;
    br.n = n;
    br.pos = pos;
    br.partial = partial;
    int eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    bool interleaved = ns > 1;
    int64_t total;
    int units_x;
    if (interleaved) {
      total = (int64_t)mcux * mcuy;
      units_x = mcux;
    } else {
      units_x = sc[0]->wblocks;
      total = (int64_t)sc[0]->wblocks * sc[0]->hblocks;
    }
    // the iMCU row of MCU m, for last_good_row
    auto imcu_row = [&](int64_t m) -> int {
      return interleaved ? (int)(m / units_x)
                         : (int)(m / units_x) / sc[0]->v;
    };
    int64_t m = 0;
    for (; m < total; m++) {
      if (br.ran_out) break;  // libjpeg leaves the rest of the scan as it is
      if (restart_interval) {
        if (restarts_to_go == 0) {
          br.reset();
          pos = br.pos;
          int mk = next_marker();
          if (mk == 0xD9 && partial && pos >= n) {
            // the data ends where a restart marker was due: libjpeg takes
            // its fake EOI for the marker, then decodes the next MCU from
            // zero bits
            br.pos = n;
          } else if (mk != 0xD0 + next_rst) {
            fail("corrupt data (restart marker missing or out of order)");
          } else {
            next_rst = (next_rst + 1) & 7;
            br.pos = pos;
          }
          restarts_to_go = restart_interval;
          eobrun = 0;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
        }
        restarts_to_go--;
      }
      int mx = (int)(m % units_x), my = (int)(m / units_x);
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int bx0, by0, nbx, nby;
        if (interleaved) {
          bx0 = mx * c.h;
          by0 = my * c.v;
          nbx = c.h;
          nby = c.v;
        } else {
          bx0 = mx;
          by0 = my;
          nbx = nby = 1;
        }
        for (int yy = 0; yy < nby; yy++)
          for (int xx = 0; xx < nbx; xx++) {
            int16_t* blk =
                &c.coef[((size_t)(by0 + yy) * c.bw + (bx0 + xx)) * 64];
            if (!progressive) {
              decode_block_baseline(br, c, blk, dc[tdc[i]], ac[tac[i]]);
            } else if (ss == 0) {
              if (ah == 0) {
                int s = br.decode(dc[tdc[i]]);
                int diff = s ? extend(br.get(s), s) : 0;
                c.dc_pred += diff;
                blk[0] = (int16_t)(c.dc_pred * (1 << al));
              } else if (br.get(1)) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(br, blk, ac[tac[i]], ss, se, al, eobrun);
            } else {
              ac_refine(br, blk, ac[tac[i]], ss, se, al, eobrun);
            }
          }
      }
    }
    // jdcoefct.c start_iMCU_row: an iMCU row started before the data ran
    // out is good, the one it ran out in too
    if (br.ran_out) {
      last_good_row = imcu_row(m - 1);
      pos = n;  // every later marker is the fake EOI
      return;
    }
    last_good_row = mcuy - 1;
    br.reset();
    pos = br.pos;
  }

  // ------------------------------------------------- arithmetic decoding
  // jdarith.c, for one scan: the statistics of the tables it names
  // cleared at its start and at each restart, the MCUs as the Huffman
  // path walks them, each block by the routine of its scan's kind
  void scan_arith(Component** sc, int ns, const int* tdc, const int* tac,
                  int ss, int se, int ah, int al) {
    Arith ar;
    ar.d = d;
    ar.n = n;
    ar.pos = pos;
    ar.partial = partial;
    int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    auto clear_stats = [&]() {
      for (int i = 0; i < ns; i++) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(ar.dc_stats[tdc[i]], 0, 64);
          last_dc[i] = 0;
          dc_ctx[i] = 0;
        }
        if (!progressive || ss) std::memset(ar.ac_stats[tac[i]], 0, 256);
      }
      ar.reset();
    };
    clear_stats();
    int restarts_to_go = restart_interval, next_rst = 0;
    bool interleaved = ns > 1;
    int units_x = interleaved ? mcux : sc[0]->wblocks;
    int64_t total = interleaved ? (int64_t)mcux * mcuy
                                : (int64_t)sc[0]->wblocks * sc[0]->hblocks;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (restarts_to_go == 0) {  // jdarith.c process_restart
          pos = ar.at_marker ? ar.marker_pos : ar.pos;
          int mk = next_marker();
          if (mk == 0xD9 && partial && pos >= n) {
            // the fake EOI where a restart marker was due: libjpeg leaves
            // it unread, and the interval decodes from zeros
            ar.pos = n;
            ar.at_marker = true;
            ar.marker_pos = n;
          } else if (mk != 0xD0 + next_rst) {
            fail("corrupt data (restart marker missing or out of order)");
          } else {
            ar.pos = pos;
            ar.at_marker = false;
          }
          next_rst = (next_rst + 1) & 7;
          clear_stats();
          restarts_to_go = restart_interval;
        }
        restarts_to_go--;
      }
      int mx = (int)(m % units_x), my = (int)(m / units_x);
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int nbx = interleaved ? c.h : 1, nby = interleaved ? c.v : 1;
        int bx0 = interleaved ? mx * c.h : mx, by0 = interleaved ? my * c.v : my;
        for (int yy = 0; yy < nby; yy++)
          for (int xx = 0; xx < nbx; xx++) {
            int16_t* blk =
                &c.coef[((size_t)(by0 + yy) * c.bw + (bx0 + xx)) * 64];
            if (!progressive || (ss == 0 && ah == 0)) {
              if (ar.ct == -1) continue;  // jdarith.c: after an error
              arith_dc(ar, ar.dc_stats[tdc[i]], tdc[i], last_dc[i],
                       dc_ctx[i]);
              if (ar.ct == -1) continue;
              blk[0] = (int16_t)(progressive ? (last_dc[i] << al)
                                             : last_dc[i]);
              if (!progressive && ar.ct != -1)
                arith_ac_first(ar, blk, ar.ac_stats[tac[i]], tac[i], 1, 63,
                               0);
            } else if (ss == 0) {  // DC refinement: the next bit, p = 0.5
              if (ar.decode(ar.fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << al));
            } else if (ar.ct == -1) {
              continue;
            } else if (ah == 0) {
              arith_ac_first(ar, blk, ar.ac_stats[tac[i]], tac[i], ss, se, al);
            } else {
              arith_ac_refine(ar, blk, ar.ac_stats[tac[i]], ss, se, al);
            }
          }
      }
    }
    pos = ar.at_marker ? ar.marker_pos : ar.pos;
    last_good_row = mcuy - 1;  // the arithmetic decoder never runs short
  }

  // Figures F.19 and F.21-F.24: one DC difference into last (mod 2^16),
  // its conditioning category into ctx (F.1.4.4.1.2)
  void arith_dc(Arith& ar, uint8_t* stats, int tbl, int& last, int& ctx) {
    uint8_t* st = stats + ctx;
    if (ar.decode(st) == 0) {
      ctx = 0;
      return;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = stats + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow: libjpeg warns, stops the scan
          return;
        }
        st += 1;
      }
    }
    if (m < (int)((1L << dac_l[tbl]) >> 1))
      ctx = 0;
    else if (m > (int)((1L << dac_u[tbl]) >> 1))
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last = (last + v) & 0xFFFF;
  }

  // Figures F.20-F.24 (G.1.3.2 in a progressive scan): the coefficients
  // ss..se of one block, each scaled by 2^al
  void arith_ac_first(Arith& ar, int16_t* blk, uint8_t* stats, int tbl,
                      int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      int sign = ar.decode(ar.fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= dac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;  // magnitude overflow
            return;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)((unsigned)v << al);
    }
  }

  // Figure G.10 as jdarith.c decodes it: a correction bit for each
  // coefficient already nonzero, a new one of magnitude 2^al elsewhere
  void arith_ac_refine(Arith& ar, int16_t* blk, uint8_t* stats, int ss,
                       int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ar.decode(st + 2))
            *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = (int16_t)(ar.decode(ar.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
    }
  }

  static void ac_first(BitReader& br, int16_t* blk, const Huffman& h, int ss,
                       int se, int al, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int s = br.decode(h);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  static void ac_refine(BitReader& br, int16_t* blk, const Huffman& h,
                        int ss, int se, int al, int& eobrun) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int s = br.decode(h);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn
      if (m == 0x01) continue;                // TEM
      int len = u16() - 2;
      if (len < 0 || (pos + len > n && !partial))
        fail("truncated data (a marker segment runs past the end)");
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC9:
        case 0xCA:
          arith = m == 0xC9 || m == 0xCA;
          parse_sof(m, len);
          break;
        case 0xC3:
          fail("lossless JPEG (SOF3) is not read");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("hierarchical (differential) JPEG is not read");
        case 0xCB:
          fail("lossless arithmetic-coded JPEG (SOF11) is not read");
        case 0xCC:
          parse_dac(len);
          break;
        case 0xC4:
          parse_dht(len);
          break;
        case 0xDB:
          parse_dqt(len);
          break;
        case 0xDD:
          if (len != 2) fail("bad DRI marker length");
          restart_interval = u16();
          break;
        case 0xDA:
          parse_sos(len);
          break;
        case 0xDC:
          fail("a DNL marker (height defined after the scan) is not read");
        case 0xDE:
        case 0xDF:
          fail("hierarchical JPEG (DHP / EXP) is not read");
        default:
          if (m >= 0xE0 && m <= 0xEF && pos + len <= n) parse_app(m, len);
          pos += len;
          break;
      }
    }
    if (!frame) fail("no frame (SOF) before EOI");
    if (!scans) fail("no scan (SOS) before EOI");
    smooth = smoothing_ok();
    for (int i = 0; i < ncomp; i++) {
      if (!comp[i].latched) {
        if (!(partial && pos >= n)) fail("a component has no scan");
        std::memset(comp[i].quant, 0, sizeof(comp[i].quant));  // gray
      }
    }
  }

  // ------------------------------------------------------ block smoothing
  // jdcoefct.c smoothing_ok: a progressive image whose every component
  // has its quantization table and some DC, and a low coefficient (the
  // first 10 in zigzag order) not known exactly; latches the states
  bool smoothing_ok() {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; k++)
        if (c.quant[kNatural[k]] == 0) return false;
      if (c.bits_known[0] < 0) return false;
      c.latch[0] = c.bits_known[0];
      for (int k = 1; k < 10; k++) {
        c.latch_prev[k] = scans > 1 ? c.prev_bits[k] : -1;
        c.latch[k] = c.bits_known[k];
        if (c.bits_known[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // one predicted coefficient: num / (q << 8) rounded, its magnitude
  // below 2^al when al > 0
  static int predict(int64_t num, int64_t q, int al) {
    int64_t p = num >= 0 ? ((q << 7) + num) / (q << 8)
                         : ((q << 7) - num) / (q << 8);
    if (al > 0 && p >= ((int64_t)1 << al)) p = ((int64_t)1 << al) - 1;
    return (int)(num >= 0 ? p : -p);
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo's 5x5 window): each
  // block's low coefficients still zero and not known exactly estimated
  // from the DC of its neighbours, the DC too when no AC is known; then
  // the IDCT
  void samples_smooth(Component& c, std::vector<uint8_t>& pl) {
    int sw = c.bw * 8;
    const uint16_t* q = c.quant;
    int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
            Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    int last_col = c.wblocks - 1;
    int rows_last = c.hblocks % c.v ? c.hblocks % c.v : c.v;
    auto dc = [&](int by, int bx) -> int {
      return c.coef[((size_t)by * c.bw + bx) * 64];
    };
    for (int by = 0; by < c.hblocks; by++) {
      int row = by / c.v;  // the iMCU row
      const int* bits = row > last_good_row ? c.latch_prev : c.latch;
      bool change_dc = true;
      for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
      // the block row's index as libjpeg counts it (block_rows of the last
      // iMCU row times the iMCU rows)
      int block_rows = row < mcuy - 1 ? c.v : rows_last;
      int ib = row * block_rows + by % c.v;
      int ibs = block_rows * mcuy;
      int p = ib > 0 ? by - 1 : by;
      int pp = ib > 1 ? by - 2 : p;
      int nx = ib < ibs - 1 ? by + 1 : by;
      int nn = ib < ibs - 2 ? by + 2 : nx;
      int r[5] = {pp, p, by, nx, nn};
      int D[5][5];  // D[row][col]: DC01..DC25
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) D[i][j] = dc(r[i], 0);
      for (int bx = 0; bx <= last_col; bx++) {
        if (bx == 0 && bx < last_col)
          for (int i = 0; i < 5; i++) D[i][3] = D[i][4] = dc(r[i], 1);
        if (bx + 1 < last_col)
          for (int i = 0; i < 5; i++) D[i][4] = dc(r[i], bx + 2);
        int16_t ws[64];
        std::memcpy(ws, &c.coef[((size_t)by * c.bw + bx) * 64], sizeof(ws));
        int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3],
            DC05 = D[0][4], DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2],
            DC09 = D[1][3], DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
            DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4], DC16 = D[3][0],
            DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
            DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
            DC25 = D[4][4];
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0)
          ws[1] = (int16_t)predict(
              Q00 * (change_dc
                         ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                            13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                            38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                            13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                            DC24 + DC25)
                         : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
              Q01, al);
        if ((al = bits[2]) != 0 && ws[8] == 0)
          ws[8] = (int16_t)predict(
              Q00 * (change_dc
                         ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                            DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                            DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                            DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                         : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
              Q10, al);
        if ((al = bits[3]) != 0 && ws[16] == 0)
          ws[16] = (int16_t)predict(
              Q00 * (change_dc
                         ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                            5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                            7 * DC18 + 2 * DC19 + DC23)
                         : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                            DC23)),
              Q20, al);
        if ((al = bits[4]) != 0 && ws[9] == 0)
          ws[9] = (int16_t)predict(
              Q00 * (change_dc
                         ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                            9 * DC19 + DC21 - DC25)
                         : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                            DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                            10 * DC09)),
              Q11, al);
        if ((al = bits[5]) != 0 && ws[2] == 0)
          ws[2] = (int16_t)predict(
              Q00 * (change_dc
                         ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                            7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                            2 * DC17 - 5 * DC18 + 2 * DC19)
                         : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                            DC15)),
              Q02, al);
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = (int16_t)predict(
                Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03,
                al);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = (int16_t)predict(
                Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12,
                al);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = (int16_t)predict(
                Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21,
                al);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = (int16_t)predict(
                Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30,
                al);
          ws[0] = (int16_t)predict(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                     6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                     8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                     8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25),
              Q00, 0);
        }
        idct_islow(ws, q, &pl[(size_t)by * 8 * sw + bx * 8], sw);
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 4; j++) D[i][j] = D[i][j + 1];
      }
    }
  }

  // -------------------------------------------------------------- IDCT
  // dequantize + islow IDCT of one block as libjpeg-turbo's SIMD paths
  // (jidctint-sse2 / -avx2) run it: 16-bit dequantized coefficients and
  // 16-bit sums where they add 16-bit lanes, 32-bit products and sums,
  // each pass's output saturated to 16 bits, the samples to 8; a block
  // whose AC terms are all zero takes the DC shortcut (a 16-bit shift).
  // On a valid stream nothing wraps and this is jidctint.c's arithmetic.
  static inline int16_t w16(int32_t v) { return (int16_t)(uint16_t)v; }
  static inline int16_t sat16(int32_t v) {
    return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
  }
  static inline int32_t add32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
  static inline int32_t mul32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  // one 1-D pass over v[0..7] (16-bit lanes) -> o[0..7] before descale
  static void simd_1d(const int16_t* v, int32_t* o) {
    constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    // even part: pmaddwd of (in2, in6), (in0 +- in4) << 13 from 16-bit sums
    int32_t tmp3 = add32(mul32(v[2], F0541 + F0765), mul32(v[6], F0541));
    int32_t tmp2 = add32(mul32(v[2], F0541), mul32(v[6], F0541 - F1847));
    int32_t tmp0 = mul32(w16((int32_t)v[0] + v[4]), 1 << 13);
    int32_t tmp1 = mul32(w16((int32_t)v[0] + w16(-(int32_t)v[4])), 1 << 13);
    int32_t t10 = add32(tmp0, tmp3), t13 = add32(tmp0, -tmp3);
    int32_t t11 = add32(tmp1, tmp2), t12 = add32(tmp1, -tmp2);
    // odd part: z3 = in7 + in3, z4 = in5 + in1 as 16-bit sums
    int32_t z3 = w16((int32_t)v[7] + v[3]), z4 = w16((int32_t)v[5] + v[1]);
    int32_t z3r = add32(mul32(z3, F1175 - F1961), mul32(z4, F1175));
    int32_t z4r = add32(mul32(z3, F1175), mul32(z4, F1175 - F0390));
    int32_t o0 = add32(add32(mul32(v[7], F0298 - F0899), mul32(v[1], -F0899)),
                       z3r);
    int32_t o3 = add32(add32(mul32(v[7], -F0899), mul32(v[1], F1501 - F0899)),
                       z4r);
    int32_t o1 = add32(add32(mul32(v[5], F2053 - F2562), mul32(v[3], -F2562)),
                       z4r);
    int32_t o2 = add32(add32(mul32(v[5], -F2562), mul32(v[3], F3072 - F2562)),
                       z3r);
    o[0] = add32(t10, o3);
    o[7] = add32(t10, -o3);
    o[1] = add32(t11, o2);
    o[6] = add32(t11, -o2);
    o[2] = add32(t12, o1);
    o[5] = add32(t12, -o1);
    o[3] = add32(t13, o0);
    o[4] = add32(t13, -o0);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    int16_t ws[64], v[8];
    int32_t o[8];
    bool ac_zero = true;
    for (int k = 8; k < 64; k++) ac_zero &= in[k] == 0;
    for (int c = 0; c < 8; c++) {
      if (ac_zero) {  // the whole block's DC shortcut: psllw
        int16_t dc = w16(w16((int32_t)in[c] * q[c]) * 4);
        for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
        continue;
      }
      bool col_zero = true;
      for (int r = 1; r < 8; r++) col_zero &= in[8 * r + c] == 0;
      if (col_zero) {  // what the 1-D pass gives a column of DC alone
        int16_t dc = sat16(4 * (int32_t)w16((int32_t)in[c] * q[c]));
        for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
        continue;
      }
      for (int r = 0; r < 8; r++) v[r] = w16((int32_t)in[8 * r + c] * q[8 * r + c]);
      simd_1d(v, o);
      for (int r = 0; r < 8; r++)
        ws[8 * r + c] = sat16(add32(o[r], 1 << 10) >> 11);
    }
    for (int r = 0; r < 8; r++) {
      const int16_t* w = ws + 8 * r;
      bool row_zero = true;
      for (int k = 1; k < 8; k++) row_zero &= w[k] == 0;
      if (row_zero) {  // likewise for a row of DC alone
        int32_t px = sat16(((int32_t)w[0] * 8192 + (1 << 17)) >> 18);
        px = px < -128 ? -128 : (px > 127 ? 127 : px);
        std::memset(out + (size_t)r * stride, px + 128, 8);
        continue;
      }
      simd_1d(w, o);
      for (int k = 0; k < 8; k++) {
        int32_t px = sat16(add32(o[k], 1 << 17) >> 18);
        px = px < -128 ? -128 : (px > 127 ? 127 : px);
        out[(size_t)r * stride + k] = (uint8_t)(px + 128);
      }
    }
  }

  // a component's samples: bw*8 x bh*8
  std::vector<uint8_t> samples(Component& c) {
    int sw = c.bw * 8;
    std::vector<uint8_t> pl((size_t)sw * c.bh * 8);
    if (smooth) {
      samples_smooth(c, pl);
      return pl;
    }
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                   &pl[(size_t)by * 8 * sw + bx * 8], sw);
    return pl;
  }

  // jdsample.c: a component to full size, width x height
  std::vector<uint8_t> upsample(const Component& c,
                                const std::vector<uint8_t>& pl) {
    int sw = c.bw * 8;
    int hx = hmax / c.h, vx = vmax / c.v;
    if (hmax % c.h || vmax % c.v)
      fail("fractional sampling factors are not supported");
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int { return pl[(size_t)y * sw + x]; };
    bool h2 = hx == 2 && c.dw > 2;  // libjpeg's fancy cases need width > 2
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < height; y++)
        std::memcpy(&out[(size_t)y * width], &pl[(size_t)y * sw], width);
    } else if (hx == 2 && vx == 1 && h2) {  // h2v1 fancy
      std::vector<uint8_t> row(2 * (size_t)c.dw);
      for (int y = 0; y < height; y++) {
        for (int i = 0; i < c.dw; i++) {
          int cur = at(y, i) * 3;
          int prev = at(y, std::max(i - 1, 0));
          int next = at(y, std::min(i + 1, c.dw - 1));
          row[2 * i] = (uint8_t)((cur + prev + 1) >> 2);
          row[2 * i + 1] = (uint8_t)((cur + next + 2) >> 2);
        }
        std::memcpy(&out[(size_t)y * width], row.data(), width);
      }
    } else if (hx == 1 && vx == 2) {  // h1v2 fancy (context rows)
      for (int y = 0; y < height; y++) {
        int iy = y >> 1;
        // the next nearest input row, the edge rows repeated
        int ny = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++)
          out[(size_t)y * width + x] =
              (uint8_t)((at(iy, x) * 3 + at(ny, x) + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && h2) {  // h2v2 fancy (context rows)
      std::vector<int> colsum(c.dw);
      std::vector<uint8_t> row(2 * (size_t)c.dw);
      for (int y = 0; y < height; y++) {
        int iy = y >> 1;
        // the next nearest input row, the edge rows repeated
        int ny = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
        for (int i = 0; i < c.dw; i++) colsum[i] = at(iy, i) * 3 + at(ny, i);
        for (int i = 0; i < c.dw; i++) {
          int cur = colsum[i] * 3;
          int prev = colsum[std::max(i - 1, 0)];
          int next = colsum[std::min(i + 1, c.dw - 1)];
          row[2 * i] = (uint8_t)((cur + prev + 8) >> 4);
          row[2 * i + 1] = (uint8_t)((cur + next + 7) >> 4);
        }
        std::memcpy(&out[(size_t)y * width], row.data(), width);
      }
    } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++)
          out[(size_t)y * width + x] = (uint8_t)at(y / vx, x / hx);
    }
    return out;
  }

  enum Space { GRAY, YCC, RGB, CMYK, YCCK };

  // jdapimin.c default_decompress_parms
  Space color_space() const {
    if (force_space >= 0) return (Space)force_space;
    if (ncomp == 1) return GRAY;
    if (ncomp == 3) {
      if (jfif) return YCC;
      if (adobe) return adobe_transform == 0 ? RGB : YCC;
      if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return YCC;
      if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
        return RGB;
      return YCC;
    }
    if (adobe) return adobe_transform == 0 ? CMYK : YCCK;
    return CMYK;
  }

  void to_rgb(int cmyk_mode, uint8_t* rgb) {
    std::vector<std::vector<uint8_t>> planes(ncomp);
    for (int i = 0; i < ncomp; i++)
      planes[i] = upsample(comp[i], samples(comp[i]));
    size_t np = (size_t)width * height;
    // jdcolor.c build_ycc_rgb_table
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) -> int64_t {
      return (int64_t)(x * (1L << SB) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto lim = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    Space sp = color_space();
    if (sp == GRAY) {
      for (size_t p = 0; p < np; p++)
        rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = planes[0][p];
      return;
    }
    if (sp == RGB || sp == YCC) {
      const uint8_t *a = planes[0].data(), *b = planes[1].data(),
                    *c = planes[2].data();
      for (size_t p = 0; p < np; p++) {
        if (sp == RGB) {
          rgb[3 * p] = a[p];
          rgb[3 * p + 1] = b[p];
          rgb[3 * p + 2] = c[p];
        } else {
          int y = a[p], cb = b[p], cr = c[p];
          rgb[3 * p] = lim(y + cr_r[cr]);
          rgb[3 * p + 1] = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
          rgb[3 * p + 2] = lim(y + cb_b[cb]);
        }
      }
      return;
    }
    for (size_t p = 0; p < np; p++) {
      int cmyk[4];
      if (sp == YCCK) {  // jdcolor.c ycck_cmyk_convert
        int y = planes[0][p], cb = planes[1][p], cr = planes[2][p];
        cmyk[0] = lim(255 - (y + cr_r[cr]));
        cmyk[1] = lim(255 - (y + (int)((cb_g[cb] + cr_g[cr]) >> SB)));
        cmyk[2] = lim(255 - (y + cb_b[cb]));
      } else {
        for (int i = 0; i < 3; i++) cmyk[i] = planes[i][p];
      }
      cmyk[3] = planes[3][p];
      int k = cmyk[3];
      for (int i = 0; i < 3; i++) {
        int v = cmyk[i];
        if (cmyk_mode == 0) {  // cv2 icvCvt_CMYK2BGR_8u_C4C3R
          rgb[3 * p + i] = (uint8_t)(k - ((255 - v) * k >> 8));
        } else {  // PIL: "CMYK;I" unpacking, then cmyk2rgb
          int inv = 255 - v, nk = k;
          int t = inv * nk + 128;
          rgb[3 * p + i] = lim(nk - (((t >> 8) + t) >> 8));
        }
      }
    }
  }
};

}  // namespace

extern "C" {

uint8_t* crdr_jpeg_decode(const uint8_t* data, int64_t n, int cmyk_mode,
                          int partial, int space, int* width, int* height,
                          int* orientation, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.partial = partial != 0;
    dec.parse();
    if (space >= 0) {
      int need[] = {1, 3, 3};  // GRAY, YCC, RGB
      if (space > 2 || need[space] != dec.ncomp)
        fail("JPEG of " + std::to_string(dec.ncomp) +
             " components where the container says " +
             (space == 0 ? "gray" : "three"));
      dec.force_space = space;
    }
    uint8_t* rgb = (uint8_t*)std::malloc((size_t)dec.width * dec.height * 3);
    if (!rgb) fail("out of memory");
    try {
      dec.to_rgb(cmyk_mode, rgb);
    } catch (...) {
      std::free(rgb);
      throw;
    }
    *width = dec.width;
    *height = dec.height;
    *orientation = dec.orientation;
    return rgb;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return nullptr;
  }
}

void crdr_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
