// Baseline and progressive JPEG decoding on the host, byte-equal to
// libjpeg-turbo's default decompression (islow IDCT, fancy upsampling,
// jdcolor.c's fixed-point YCbCr -> RGB), as cv2.imread and PIL run it.
//
// Plain C ABI, loaded with ctypes (utils/jpeg.py):
//
//   uint8_t* crdr_jpeg_decode(data, n, cmyk_mode, partial, &w, &h,
//                             &orientation, err, errlen)
//     -> a malloc'ed w*h*3 RGB buffer (free it with crdr_jpeg_free), or
//        NULL with the reason in err.
//
// cmyk_mode picks how a 4-component (CMYK / YCCK) image becomes RGB:
//   0: cv2's way (libjpeg's CMYK, then c = k - ((255 - c) * k >> 8));
//   1: PIL's way (Adobe-inverted CMYK, then nk - (c' * nk) / 255 rounded).
// orientation is the EXIF orientation tag of the first "Exif" APP1 (1 when
// there is none); the caller applies it or not.
//
// partial set (cv2.imread's file path): a file that ends inside a scan or
// without EOI decodes as libjpeg-turbo decodes it after "Premature end of
// JPEG file": the MCU the data ran out in is decoded with zero bits, the
// scan's later MCUs and every later scan are skipped (their coefficients
// stay as earlier scans left them, zero if none: gray 128), and a component
// that never had a scan is gray.  Unset (PIL's body path), such a file
// raises, as PIL raises "image file is truncated".
//
// Raises (returns NULL) on what libjpeg-turbo either refuses or decodes
// only partly: 12-bit precision, lossless, hierarchical and arithmetic
// frames, corrupt entropy data, a file that ends inside a marker segment,
// and progressive files whose scans leave a low coefficient unrefined
// (libjpeg smooths those blocks), truncated or not.

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

  void fill() {
    while (bits <= 56) {
      int b = 0;
      if (!stopped && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;  // a stuffed data byte 0xFF
          } else if (q >= n) {  // 0xFF bytes to the end: the data ends
            pos = n;
            stopped = true;
            b = 0;
            fake += 8;
          } else {
            pos = q - 1;  // the marker's 0xFF
            stopped = true;
            b = 0;
            fake += 8;
          }
        } else {
          pos++;
        }
      } else {
        stopped = true;
        fake += 8;
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

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated data (the file ends inside a header)");
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
    progressive = marker == 0xC2;
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
      if (tdc[i] > 3 || tac[i] > 3) fail("bad Huffman table number");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (pos != end) fail("bad SOS marker length");
    if (progressive) {
      if (ss > 63 || se > 63 || ss > se || ah > 13 || al > 13 ||
          (ss == 0 && se != 0) || (ss > 0 && ns != 1))
        fail("bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("bad sequential scan parameters");
    }
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {  // libjpeg latches a table at its first scan
        if (!qt_present[c.tq]) fail("a quantization table is missing");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      c.dc_pred = 0;
      bool need_dc = ss == 0 && ah == 0, need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[tdc[i]].present) || (need_ac && !ac[tac[i]].present))
        fail("a Huffman table is missing");
      if (progressive)
        for (int k = ss; k <= se; k++) c.bits_known[k] = al;
    }
    if (!progressive)
      for (int i = 0; i < ns; i++)
        for (int k = 0; k < 64; k++) sc[i]->bits_known[k] = 0;

    scans++;
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
    for (int64_t m = 0; m < total; m++) {
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
    if (br.ran_out) {
      pos = n;  // every later marker is the fake EOI
      return;
    }
    br.reset();
    pos = br.pos;
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
      if (len < 0 || pos + len > n)
        fail("truncated data (a marker segment runs past the end)");
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
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
        case 0xC9:
        case 0xCA:
        case 0xCB:
          fail("arithmetic-coded JPEG (SOF9-11) is not read");
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC) is not read");
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
          if (m >= 0xE0 && m <= 0xEF) parse_app(m, len);
          pos += len;
          break;
      }
    }
    if (!frame) fail("no frame (SOF) before EOI");
    if (!scans) fail("no scan (SOS) before EOI");
    // libjpeg smooths a progressive image (jdcoefct.c smoothing_ok) when
    // every component has some DC and a low coefficient is not fully
    // refined; complete files leave none
    bool smoothing = progressive;
    for (int i = 0; i < ncomp; i++) {
      if (!comp[i].latched) {
        if (!(partial && pos >= n)) fail("a component has no scan");
        std::memset(comp[i].quant, 0, sizeof(comp[i].quant));  // gray
      }
      if (comp[i].bits_known[0] < 0) smoothing = false;
    }
    for (int i = 0; i < ncomp && smoothing; i++)
      for (int k = 0; k < 10; k++)
        if (comp[i].bits_known[k] != 0)
          fail("progressive scans leave coefficient " + std::to_string(k) +
               " unrefined (libjpeg's block smoothing is not reproduced)");
  }

  // -------------------------------------------------------------- IDCT
  // jidctint.c jpeg_idct_islow: the same 1-D butterfly on the columns, then
  // on the rows; o[k] is output k before its descale
  static void islow_1d(const int64_t* v, int64_t* o) {
    constexpr int CB = 13;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299,
                      F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    int64_t z1 = (v[2] + v[6]) * F0541;
    int64_t tmp2 = z1 + v[6] * -F1847, tmp3 = z1 + v[2] * F0765;
    int64_t tmp0 = (v[0] + v[4]) * (1 << CB);
    int64_t tmp1 = (v[0] - v[4]) * (1 << CB);
    int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = v[7];
    tmp1 = v[5];
    tmp2 = v[3];
    tmp3 = v[1];
    z1 = tmp0 + tmp3;
    int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = t10 + tmp3;
    o[7] = t10 - tmp3;
    o[1] = t11 + tmp2;
    o[6] = t11 - tmp2;
    o[2] = t12 + tmp1;
    o[5] = t12 - tmp1;
    o[3] = t13 + tmp0;
    o[4] = t13 - tmp0;
  }

  // dequantize + islow IDCT of one block, with the SIMD paths' saturation
  // at the end (the C code's range-limit table wraps only on values no
  // valid stream gives)
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    constexpr int CB = 13, P1 = 2;
    auto descale = [](int64_t x, int nb) -> int64_t {
      return (x + ((int64_t)1 << (nb - 1))) >> nb;
    };
    int64_t ws[64], v[8], o[8];
    for (int c = 0; c < 8; c++) {
      bool ac_zero = true;
      for (int r = 1; r < 8; r++) ac_zero &= in[8 * r + c] == 0;
      if (ac_zero) {  // libjpeg's shortcut; the same values
        for (int r = 0; r < 8; r++)
          ws[8 * r + c] = ((int64_t)in[c] * q[c]) * (1 << P1);
        continue;
      }
      for (int r = 0; r < 8; r++)
        v[r] = (int64_t)in[8 * r + c] * q[8 * r + c];
      islow_1d(v, o);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = descale(o[r], CB - P1);
    }
    for (int r = 0; r < 8; r++) {
      islow_1d(ws + 8 * r, o);
      for (int k = 0; k < 8; k++) {
        int64_t px = descale(o[k], CB + P1 + 3) + 128;
        out[(size_t)r * stride + k] =
            (uint8_t)(px < 0 ? 0 : (px > 255 ? 255 : px));
      }
    }
  }

  // a component's samples: bw*8 x bh*8
  std::vector<uint8_t> samples(const Component& c) {
    int sw = c.bw * 8;
    std::vector<uint8_t> pl((size_t)sw * c.bh * 8);
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
                          int partial, int* width, int* height,
                          int* orientation, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.partial = partial != 0;
    dec.parse();
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
