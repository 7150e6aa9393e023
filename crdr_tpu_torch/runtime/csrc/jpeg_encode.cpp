// Baseline JPEG encoding on the host, byte-equal to what cv2.imencode('.jpg')
// writes for an RGB image at its defaults (libjpeg-turbo's compression with
// cv2's settings: JFIF 1.01 with a 1:1 aspect, the standard luminance and
// chrominance tables scaled to the quality, YCbCr 4:2:0, the islow forward
// DCT, the standard Huffman tables (no optimisation), one interleaved scan,
// no restart interval).
//
// Plain C ABI, loaded with ctypes (utils/jpeg.py), built with jpeg.cpp into
// one library:
//
//   uint8_t* crdr_jpeg_encode(rgb, w, h, quality, &n, err, errlen)
//     -> a malloc'ed JPEG of n bytes (free it with crdr_jpeg_free), or NULL
//        with the reason in err.
//
// Each step is libjpeg-turbo's, whose SIMD routines compute the same
// integers as its C code:
//   * jccolor.c's fixed-point RGB -> YCbCr (16 fraction bits; Cb and Cr
//     rounded with ONE_HALF - 1 and offset by 128);
//   * jcprepct.c / jcsample.c: the rows padded to a whole row group and the
//     columns to whole blocks by repeating the last one; h2v2_downsample
//     averages 2x2 with a bias alternating 1, 2 along a row; the downsampled
//     rows padded to a whole MCU row by repeating the last one;
//   * jfdctint.c's islow DCT (13 constant bits, 2 pass-1 bits) on samples
//     centred by 128;
//   * jcdctmgr.c's quantisation by reciprocal (compute_reciprocal with the
//     16-bit DCTELEM of the SIMD build, divisors q << 3): a rounded
//     division for every value the DCT gives;
//   * jccoefct.c's dummy blocks past the image's blocks in an edge MCU: AC
//     zero, DC the block before's;
//   * jchuff.c's Huffman coding with DC prediction per component, 0xFF
//     stuffed with 0x00, the last byte padded with 1-bits.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// natural index of zigzag position k
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU-T T.81 Annex K tables (natural order)
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jccolor.c
constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = 128 << kScaleBits;
constexpr int32_t fix(double x) {
  return static_cast<int32_t>(x * (1L << kScaleBits) + 0.5);
}

// jfdctint.c
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t kFix_0_298631336 = 2446;
constexpr int32_t kFix_0_390180644 = 3196;
constexpr int32_t kFix_0_541196100 = 4433;
constexpr int32_t kFix_0_765366865 = 6270;
constexpr int32_t kFix_0_899976223 = 7373;
constexpr int32_t kFix_1_175875602 = 9633;
constexpr int32_t kFix_1_501321110 = 12299;
constexpr int32_t kFix_1_847759065 = 15137;
constexpr int32_t kFix_1_961570560 = 16069;
constexpr int32_t kFix_2_053119869 = 16819;
constexpr int32_t kFix_2_562915447 = 20995;
constexpr int32_t kFix_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;  // arithmetic shift, as RIGHT_SHIFT
}

// jpeg_fdct_islow on one block, in place; out 8x the DCT's coefficients
void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0: rows (stride 1 between elements, 8 between rows); pass 1:
    // columns
    const int step = pass == 0 ? 1 : 8;
    const int next = pass == 0 ? 8 : 1;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* d = data + ctr * next;
      auto at = [&](int i) -> int32_t& { return d[i * step]; };
      int32_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
      int32_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
      int32_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
      int32_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int odd_shift =
          pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        at(0) = (tmp10 + tmp11) * (1 << kPass1Bits);
        at(4) = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        at(0) = descale(tmp10 + tmp11, kPass1Bits);
        at(4) = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * kFix_0_541196100;
      at(2) = descale(z1 + tmp13 * kFix_0_765366865, odd_shift);
      at(6) = descale(z1 + tmp12 * (-kFix_1_847759065), odd_shift);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6;
      int32_t z3 = tmp4 + tmp6;
      int32_t z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * kFix_1_175875602;
      tmp4 *= kFix_0_298631336;
      tmp5 *= kFix_2_053119869;
      tmp6 *= kFix_3_072711026;
      tmp7 *= kFix_1_501321110;
      z1 *= -kFix_0_899976223;
      z2 *= -kFix_2_562915447;
      z3 *= -kFix_1_961570560;
      z4 *= -kFix_0_390180644;
      z3 += z5;
      z4 += z5;
      at(7) = descale(tmp4 + z1 + z3, odd_shift);
      at(5) = descale(tmp5 + z2 + z4, odd_shift);
      at(3) = descale(tmp6 + z2 + z3, odd_shift);
      at(1) = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// jcdctmgr.c's compute_reciprocal with a 16-bit DCTELEM: a rounded
// division by `divisor` as ((x + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31;
  while (!(divisor >> b)) --b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor;
  const uint64_t fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two: fq one bit too large for 16 bits
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return {static_cast<uint32_t>(fq), c, r};
}

struct Huff {
  uint16_t code[256];
  uint8_t size[256];
};

// jcomapi / jchuff.c's jpeg_make_c_derived_tbl
Huff derive(const uint8_t* bits, const uint8_t* vals) {
  Huff h{};
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  const int n = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  for (int i = 0; i < n; ++i) {
    h.code[vals[i]] = static_cast<uint16_t>(huffcode[i]);
    h.size[vals[i]] = static_cast<uint8_t>(huffsize[i]);
  }
  return h;
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

  void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      nacc_ -= 8;
      byte(static_cast<uint8_t>(acc_ >> nacc_));
    }
    acc_ &= (1u << nacc_) - 1;
  }

  // the partial last byte filled with 1-bits
  void flush() {
    if (nacc_)
      byte(static_cast<uint8_t>((acc_ << (8 - nacc_)) | (0xFF >> nacc_)));
    nacc_ = 0;
    acc_ = 0;
  }

 private:
  void byte(uint8_t b) {
    out_.push_back(b);
    if (b == 0xFF) out_.push_back(0);
  }

  std::vector<uint8_t>& out_;
  uint32_t acc_ = 0;
  int nacc_ = 0;
};

int nbits(int v) {  // bits of |v|'s magnitude, v >= 0
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const Huff& dc, const Huff& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int n = nbits(temp);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(temp2), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    n = nbits(temp);
    const int sym = (run << 4) + n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(temp2), n);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

// A component plane padded to whole blocks, the padding repeating the last
// column and row.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[static_cast<size_t>(y) * w + x]; }
};

void fill_edges(Plane& p, int valid_w, int valid_h) {
  for (int y = 0; y < valid_h; ++y)
    for (int x = valid_w; x < p.w; ++x)
      p.px[static_cast<size_t>(y) * p.w + x] =
          p.px[static_cast<size_t>(y) * p.w + valid_w - 1];
  for (int y = valid_h; y < p.h; ++y)
    std::memcpy(&p.px[static_cast<size_t>(y) * p.w],
                &p.px[static_cast<size_t>(valid_h - 1) * p.w], p.w);
}

// DCT and quantisation of the 8x8 block at (bx, by) of plane p
void transform_block(const Plane& p, int bx, int by, const Divisor* div,
                     int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      ws[y * 8 + x] = static_cast<int32_t>(p.at(bx * 8 + x, by * 8 + y)) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    const bool neg = t < 0;
    if (neg) t = -t;
    const uint64_t prod =
        static_cast<uint64_t>(static_cast<uint32_t>(t) + div[i].corr) *
        div[i].recip;
    int32_t q = static_cast<int32_t>(prod >> div[i].shift);
    out[i] = static_cast<int16_t>(neg ? -q : q);
  }
}

void marker(std::vector<uint8_t>& out, uint8_t m, const std::vector<uint8_t>& body) {
  const size_t len = body.size() + 2;
  out.insert(out.end(), {0xFF, m, static_cast<uint8_t>(len >> 8),
                         static_cast<uint8_t>(len & 0xFF)});
  out.insert(out.end(), body.begin(), body.end());
}

std::vector<uint8_t> encode(const uint8_t* rgb, int w, int h, int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535)
    throw std::runtime_error("image size out of JPEG's range");
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int i = 0; i < 64; ++i) {
    const int base[2] = {kLumaQuant[i], kChromaQuant[i]};
    for (int t = 0; t < 2; ++t) {
      long v = (static_cast<long>(base[t]) * scale + 50L) / 100L;
      qt[t][i] = static_cast<int>(v <= 0 ? 1 : (v > 255 ? 255 : v));
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i)
      div[t][i] = reciprocal(static_cast<uint32_t>(qt[t][i]) << 3);

  // colour conversion into full-resolution planes padded to the MCU grid
  const int mx = (w + 15) / 16, my = (h + 15) / 16;
  const int wb = (w + 7) / 8, hb = (h + 7) / 8;  // Y's real blocks
  Plane y{mx * 16, my * 16, {}}, cb{mx * 16, my * 16, {}},
      cr{mx * 16, my * 16, {}};
  for (Plane* p : {&y, &cb, &cr}) p->px.assign(static_cast<size_t>(p->w) * p->h, 0);
  constexpr int32_t kRY = fix(0.29900), kGY = fix(0.58700), kBY = fix(0.11400);
  constexpr int32_t kRCb = -fix(0.16874), kGCb = -fix(0.33126),
                    kBCb = fix(0.50000);
  constexpr int32_t kGCr = -fix(0.41869), kBCr = -fix(0.08131);
  for (int r = 0; r < h; ++r) {
    const uint8_t* row = rgb + static_cast<size_t>(r) * w * 3;
    for (int c = 0; c < w; ++c) {
      const int32_t R = row[3 * c], G = row[3 * c + 1], B = row[3 * c + 2];
      const size_t o = static_cast<size_t>(r) * y.w + c;
      y.px[o] = static_cast<uint8_t>((kRY * R + kGY * G + kBY * B + kOneHalf) >>
                                     kScaleBits);
      cb.px[o] = static_cast<uint8_t>(
          (kRCb * R + kGCb * G + kBCb * B + kCbCrOffset + kOneHalf - 1) >>
          kScaleBits);
      cr.px[o] = static_cast<uint8_t>(
          (kBCb * R + kGCr * G + kBCr * B + kCbCrOffset + kOneHalf - 1) >>
          kScaleBits);
    }
  }
  fill_edges(y, w, h);
  fill_edges(cb, w, h);
  fill_edges(cr, w, h);
  // h2v2_downsample of the padded chroma (rows in pairs, bias 1, 2, ...)
  // for the image's (h + 1) / 2 row pairs; the MCU row's rest repeats the
  // last downsampled row (jcprepct.c pads after downsampling)
  Plane sub[2];
  const Plane* full[2] = {&cb, &cr};
  for (int k = 0; k < 2; ++k) {
    sub[k].w = mx * 8;
    sub[k].h = my * 8;
    sub[k].px.assign(static_cast<size_t>(sub[k].w) * sub[k].h, 0);
    for (int r = 0; r < (h + 1) / 2; ++r) {
      int bias = 1;
      for (int c = 0; c < sub[k].w; ++c) {
        const int s = full[k]->at(2 * c, 2 * r) + full[k]->at(2 * c + 1, 2 * r) +
                      full[k]->at(2 * c, 2 * r + 1) +
                      full[k]->at(2 * c + 1, 2 * r + 1);
        sub[k].px[static_cast<size_t>(r) * sub[k].w + c] =
            static_cast<uint8_t>((s + bias) >> 2);
        bias ^= 3;
      }
    }
    fill_edges(sub[k], sub[k].w, (h + 1) / 2);
  }

  std::vector<uint8_t> out = {0xFF, 0xD8};
  marker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {
    std::vector<uint8_t> body = {static_cast<uint8_t>(t)};
    for (int k = 0; k < 64; ++k)
      body.push_back(static_cast<uint8_t>(qt[t][kZigzag[k]]));
    marker(out, 0xDB, body);
  }
  marker(out, 0xC0,
         {8, static_cast<uint8_t>(h >> 8), static_cast<uint8_t>(h & 0xFF),
          static_cast<uint8_t>(w >> 8), static_cast<uint8_t>(w & 0xFF), 3, 1,
          0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  const struct {
    uint8_t cls;
    const uint8_t* bits;
    const uint8_t* vals;
  } tables[4] = {{0x00, kDcLumaBits, kDcVals},
                 {0x10, kAcLumaBits, kAcLumaVals},
                 {0x01, kDcChromaBits, kDcVals},
                 {0x11, kAcChromaBits, kAcChromaVals}};
  for (const auto& t : tables) {
    int n = 0;
    for (int l = 0; l < 16; ++l) n += t.bits[l];
    std::vector<uint8_t> body = {t.cls};
    body.insert(body.end(), t.bits, t.bits + 16);
    body.insert(body.end(), t.vals, t.vals + n);
    marker(out, 0xC4, body);
  }
  marker(out, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  const Huff dc_l = derive(kDcLumaBits, kDcVals);
  const Huff ac_l = derive(kAcLumaBits, kAcLumaVals);
  const Huff dc_c = derive(kDcChromaBits, kDcVals);
  const Huff ac_c = derive(kAcChromaBits, kAcChromaVals);
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[6][64];
  for (int r = 0; r < my; ++r) {
    for (int c = 0; c < mx; ++c) {
      // Y: 2x2 blocks in raster order; past the image's blocks, dummy blocks
      // (jccoefct.c): a right one takes its left neighbour's DC, a bottom
      // row the DC of the block before it in the MCU
      for (int yi = 0; yi < 2; ++yi) {
        const int by = 2 * r + yi;
        for (int xi = 0; xi < 2; ++xi) {
          const int bx = 2 * c + xi;
          int16_t* b = blk[2 * yi + xi];
          if (by < hb && bx < wb) {
            transform_block(y, bx, by, div[0], b);
          } else {
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = by < hb ? blk[2 * yi + xi - 1][0] : blk[2 * yi - 1][0];
          }
        }
      }
      transform_block(sub[0], c, r, div[1], blk[4]);
      transform_block(sub[1], c, r, div[1], blk[5]);
      for (int i = 0; i < 4; ++i) encode_block(bw, blk[i], last_dc[0], dc_l, ac_l);
      encode_block(bw, blk[4], last_dc[1], dc_c, ac_c);
      encode_block(bw, blk[5], last_dc[2], dc_c, ac_c);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

}  // namespace

extern "C" {

// RGB uint8 [h, w, 3] (row-major, contiguous) -> a malloc'ed baseline JPEG
// of *n bytes at `quality` (1-100, cv2's default 95), or NULL with the
// reason in err.
uint8_t* crdr_jpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                          int64_t* n, char* err, int errlen) {
  try {
    const std::vector<uint8_t> out = encode(rgb, w, h, quality);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
    if (!buf) throw std::runtime_error("out of memory");
    std::memcpy(buf, out.data(), out.size());
    *n = static_cast<int64_t>(out.size());
    return buf;
  } catch (const std::exception& e) {
    if (errlen > 0) {
      std::strncpy(err, e.what(), errlen - 1);
      err[errlen - 1] = 0;
    }
    return nullptr;
  }
}

}  // extern "C"
