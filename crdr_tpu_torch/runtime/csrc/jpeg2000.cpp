// JPEG 2000 codestream decoding on the host (ITU-T T.800, Part 1) for the
// JPEG 2000 reader (utils/jpeg2000.py), as OpenJPEG 2.5 decodes it for
// cv2.imread and PIL: the same integers out of every component.
//
// Plain C ABI, loaded with ctypes:
//
//   int crdr_j2k_header(data, n, info, info_n, err, errlen)
//     data / n: a codestream from its SOC marker.  info (info_n int32s):
//     x0, y0, x1, y1 of the image, the component count, then each
//     component's precision, signedness, dx and dy.  -> 0, or -1 with
//     the reason in err.
//   int crdr_j2k_decode(data, n, eoc, out, err, errlen)
//     out: each component's samples in turn, ceil(x1 / dx) - ceil(x0 /
//     dx) wide and as high by dy, int32, after the inverse transforms, the
//     DC level shift and the clamp to the component's precision (0 in a
//     tile the codestream does not hold, as OpenJPEG leaves it).  eoc: the
//     two bytes past the last tile-part must be EOC (OpenJPEG's tile by
//     tile decode, PIL's), else any two bytes end the codestream
//     (opj_decode, cv2's).  -> 0, or -1 with the reason in err.
//
// Read: SIZ, COD / COC, QCD / QCC (none, scalar derived, scalar
// expounded), RGN, POC, COM, TLM / PLM / PLT / CRG / CAP (skipped);
// tile-parts (SOT / SOD; each tile's parts in order, as OpenJPEG checks;
// Psot 0 runs to the last two bytes; past the last tile-part, two bytes
// that are not EOC end the codestream, as opj_decode reads on, unless
// ``eoc`` asks for EOC); SOP / EPH;
// the five progression orders and POC's progressions, each packet once;
// tag trees and packet headers; the MQ decoder and the three coding passes
// with every code-block style of Part 1 (the bypass's raw passes, reset,
// termination on each pass, vertically causal, predictable termination,
// segmentation symbols); dequantisation; the inverse 5/3 (integer) and
// 9/7 (float32, OpenJPEG's order of operations: the lows times K and the
// highs times 2/K, then the four lifting steps, each (left + right) * c
// added, rows before columns); RCT / ICT; the DC level shift, rounding
// half to even (lrintf) on the 9/7 path.  Refused by name: PPM / PPT,
// high-throughput code-blocks (Part 15), Part 2's wavelets and component
// transforms; and, as OpenJPEG's strict mode does, data that ends before
// a tile-part or a code-block segment does.
//
// Build with -ffp-contract=off: OpenJPEG multiplies, then adds.

#include <algorithm>
#include <cmath>
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

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }  // a >= 0
int64_t ceildivpow2(int64_t a, int b) {  // any sign of a
  return (a + ((int64_t)1 << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------------------
// codestream parameters
// ---------------------------------------------------------------------------

constexpr int kMaxBands = 97;  // 3 * 32 + 1

struct Comp {
  int prec, sgnd, dx, dy;
};

struct TCCP {  // one tile-component's coding style and quantisation
  int csty = 0, nres = 6, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 1;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 2;
  int expn[kMaxBands] = {}, mant[kMaxBands] = {};
  int roishift = 0;
  TCCP() {
    for (int i = 0; i < 33; i++) prcw[i] = prch[i] = 15;
  }
};

struct Poc {  // one progression: resolutions, components, layers, order
  int r0, c0, l1, r1, c1, prg;
};

struct TCP {  // one tile's coding parameters and data
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  std::vector<TCCP> tccps;
  std::vector<Poc> pocs;  // the main header's, then the tile's
  std::vector<uint8_t> data;
  bool seen = false;
  int parts = 0, nparts = 0;  // tile-parts read; their number, once given
};

struct Image {
  int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
  int ntx = 0, nty = 0;
  std::vector<Comp> comps;
  TCP def;
  std::vector<TCP> tiles;
};

struct Seg {  // a big-endian marker segment
  const uint8_t* p;
  size_t n, pos = 0;
  std::string what;
  uint32_t get(int bytes) {
    if (pos + bytes > n) fail("truncated JPEG 2000 " + what + " marker");
    uint32_t v = 0;
    for (int i = 0; i < bytes; i++) v = (v << 8) | p[pos++];
    return v;
  }
  size_t left() const { return n - pos; }
};

void read_siz(Seg& s, Image& im) {
  s.get(2);  // Rsiz
  int64_t v[8];
  for (auto& x : v) x = s.get(4);
  im.x1 = v[0]; im.y1 = v[1]; im.x0 = v[2]; im.y0 = v[3];
  im.tdx = v[4]; im.tdy = v[5]; im.tx0 = v[6]; im.ty0 = v[7];
  int nc = (int)s.get(2);
  if (im.x0 >= im.x1 || im.y0 >= im.y1)
    fail("JPEG 2000 image of no pixels (SIZ " + std::to_string(im.x0) + "-" +
         std::to_string(im.x1) + " x " + std::to_string(im.y0) + "-" +
         std::to_string(im.y1) + ")");
  if (im.tdx == 0 || im.tdy == 0) fail("JPEG 2000 tiles of no size");
  if (im.tx0 > im.x0 || im.ty0 > im.y0 || im.tx0 + im.tdx <= im.x0 ||
      im.ty0 + im.tdy <= im.y0)
    fail("JPEG 2000 tile grid that misses the image");
  if (nc == 0 || nc > 16384) fail("JPEG 2000 with " + std::to_string(nc) +
                                  " components");
  if (s.left() != (size_t)nc * 3)
    fail("JPEG 2000 SIZ marker of another length than its components");
  for (int c = 0; c < nc; c++) {
    int ssiz = (int)s.get(1), dx = (int)s.get(1), dy = (int)s.get(1);
    int prec = (ssiz & 0x7f) + 1;
    if (prec > 31)  // OpenJPEG decodes up to 31 bits
      fail("JPEG 2000 component of " + std::to_string(prec) + " bits");
    if (dx == 0 || dy == 0) fail("JPEG 2000 component subsampled by 0");
    im.comps.push_back({prec, ssiz >> 7, dx, dy});
  }
  im.ntx = (int)ceildiv(im.x1 - im.tx0, im.tdx);
  im.nty = (int)ceildiv(im.y1 - im.ty0, im.tdy);
  if ((int64_t)im.ntx * im.nty > 65535)
    fail("JPEG 2000 of " + std::to_string((int64_t)im.ntx * im.nty) +
         " tiles");
  im.def.tccps.assign(nc, TCCP());
}

int comp_index(Seg& s, const Image& im) {
  int c = (int)s.get(im.comps.size() < 257 ? 1 : 2);
  if (c >= (int)im.comps.size())
    fail("JPEG 2000 " + s.what + " marker for component " +
         std::to_string(c) + " of " + std::to_string(im.comps.size()));
  return c;
}

void read_spcod(Seg& s, TCCP& t) {  // SPcod / SPcoc
  int levels = (int)s.get(1);
  if (levels > 32)
    fail("JPEG 2000 with " + std::to_string(levels) + " decomposition levels");
  t.nres = levels + 1;
  t.cblkw = (int)s.get(1) + 2;
  t.cblkh = (int)s.get(1) + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    fail("JPEG 2000 code-blocks of 2^" + std::to_string(t.cblkw) + " x 2^" +
         std::to_string(t.cblkh));
  t.cblksty = (int)s.get(1);
  if (t.cblksty & 0x40)
    fail("JPEG 2000 high-throughput code-blocks (Part 15) are not read");
  if (t.cblksty & 0x80)
    fail("JPEG 2000 code-block style 0x80 is not read");
  t.qmfbid = (int)s.get(1);
  if (t.qmfbid > 1)
    fail("JPEG 2000 wavelet transform " + std::to_string(t.qmfbid) +
         " (Part 2) is not read");
  for (int r = 0; r < t.nres; r++) {
    if (t.csty & 1) {
      int b = (int)s.get(1);
      t.prcw[r] = b & 15;
      t.prch[r] = b >> 4;
      if (r > 0 && (t.prcw[r] == 0 || t.prch[r] == 0))
        fail("JPEG 2000 precinct of size 2^0 above resolution 0");
    } else {
      t.prcw[r] = t.prch[r] = 15;
    }
  }
}

void read_cod(Seg& s, Image& im, TCP& tcp) {
  tcp.csty = (int)s.get(1);
  if (tcp.csty > 7) fail("JPEG 2000 COD coding style " +
                         std::to_string(tcp.csty));
  tcp.prg = (int)s.get(1);
  if (tcp.prg > 4)
    fail("JPEG 2000 progression order " + std::to_string(tcp.prg));
  tcp.numlayers = (int)s.get(2);
  if (tcp.numlayers == 0) fail("JPEG 2000 with 0 quality layers");
  tcp.mct = (int)s.get(1);
  if (tcp.mct > 1)
    fail("JPEG 2000 multiple component transform " + std::to_string(tcp.mct) +
         " (Part 2) is not read");
  if (tcp.mct && im.comps.size() < 3) tcp.mct = 0;
  TCCP t;
  t.csty = tcp.csty & 1;
  read_spcod(s, t);
  for (auto& c : tcp.tccps) {
    int q = c.qntsty, g = c.numgbits, rs = c.roishift;
    int e[kMaxBands], m[kMaxBands];
    std::memcpy(e, c.expn, sizeof e);
    std::memcpy(m, c.mant, sizeof m);
    c = t;
    c.qntsty = q; c.numgbits = g; c.roishift = rs;
    std::memcpy(c.expn, e, sizeof e);
    std::memcpy(c.mant, m, sizeof m);
  }
}

void read_coc(Seg& s, Image& im, TCP& tcp) {
  TCCP& t = tcp.tccps[comp_index(s, im)];
  t.csty = (int)s.get(1);
  if (t.csty > 1) fail("JPEG 2000 COC coding style " +
                       std::to_string(t.csty));
  read_spcod(s, t);
}

void read_sqcd(Seg& s, TCCP& t) {
  int b = (int)s.get(1);
  t.qntsty = b & 0x1f;  // OpenJPEG: any style but 0 and 1 as expounded
  t.numgbits = b >> 5;
  int nbands = t.qntsty == 1 ? 1
               : t.qntsty == 0 ? (int)s.left() : (int)s.left() / 2;
  for (int i = 0; i < nbands; i++) {
    if (t.qntsty == 0) {
      int v = (int)s.get(1);
      if (i < kMaxBands) { t.expn[i] = v >> 3; t.mant[i] = 0; }
    } else {
      int v = (int)s.get(2);
      if (i < kMaxBands) { t.expn[i] = v >> 11; t.mant[i] = v & 0x7ff; }
    }
  }
  if (t.qntsty == 1)  // scalar derived: the others from the first
    for (int b = 1; b < kMaxBands; b++) {
      int e = t.expn[0] - (b - 1) / 3;
      t.expn[b] = e > 0 ? e : 0;
      t.mant[b] = t.mant[0];
    }
}

void read_qcd(Seg& s, TCP& tcp) {
  TCCP q;
  read_sqcd(s, q);
  for (auto& c : tcp.tccps) {
    c.qntsty = q.qntsty; c.numgbits = q.numgbits;
    std::memcpy(c.expn, q.expn, sizeof q.expn);
    std::memcpy(c.mant, q.mant, sizeof q.mant);
  }
}

void read_poc(Seg& s, Image& im, TCP& tcp) {
  const int room = im.comps.size() <= 256 ? 1 : 2, chunk = 5 + 2 * room;
  if (s.n == 0 || s.n % chunk)
    fail("JPEG 2000 POC marker of " + std::to_string(s.n) + " bytes");
  if (tcp.pocs.size() + s.n / chunk >= 32)
    fail("JPEG 2000 with more than 31 progression order changes");
  while (s.left()) {
    Poc p;
    p.r0 = (int)s.get(1);
    p.c0 = (int)s.get(room);
    p.l1 = (int)s.get(2);
    p.r1 = (int)s.get(1);
    p.c1 = std::min((int)s.get(room), (int)im.comps.size());
    p.prg = (int)s.get(1);
    tcp.pocs.push_back(p);
  }
}

void read_rgn(Seg& s, Image& im, TCP& tcp) {
  TCCP& t = tcp.tccps[comp_index(s, im)];
  s.get(1);  // Srgn: OpenJPEG reads any style as the implicit one
  t.roishift = (int)s.get(1);
}

// A marker segment of a header (main or tile-part); COM, TLM, PLM, PLT,
// CRG, CAP, CPF, CBD and those of no known place are skipped.
void read_marker(int marker, Seg& s, Image& im, TCP& tcp, bool& cod,
                 bool& qcd) {
  switch (marker) {
    case 0xFF52: s.what = "COD"; read_cod(s, im, tcp); cod = true; return;
    case 0xFF53: s.what = "COC"; read_coc(s, im, tcp); return;
    case 0xFF5C: s.what = "QCD"; read_qcd(s, tcp); qcd = true; return;
    case 0xFF5D: s.what = "QCC"; read_sqcd(s, tcp.tccps[comp_index(s, im)]);
      return;
    case 0xFF5E: s.what = "RGN"; read_rgn(s, im, tcp); return;
    case 0xFF5F: s.what = "POC"; read_poc(s, im, tcp); return;
    case 0xFF60: fail("JPEG 2000 packed packet headers (PPM marker) are not "
                      "read");
    case 0xFF61: fail("JPEG 2000 packed packet headers (PPT marker) are not "
                      "read");
    case 0xFF74: case 0xFF75: case 0xFF77:
      fail("JPEG 2000 Part 2 component transform markers are not read");
  }
}

// Where OpenJPEG's marker table allows a marker: 1 the main header, 2 a
// tile-part header; 0 nowhere (SIZ past the first, SOP); -1 a marker it
// does not know.
int marker_places(int m) {
  switch (m) {
    case 0xFF90: return 1;  // SOT ends the main header
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D:
    case 0xFF5F: case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77:
      return 3;  // COD COC RGN QCD QCC POC COM MCT MCC MCO
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78:
    case 0xFF50: case 0xFF59:
      return 1;  // TLM PLM PPM CRG CBD CAP CPF
    case 0xFF58: case 0xFF61: return 2;  // PLT PPT
    case 0xFF51: case 0xFF91: return 0;  // SIZ, SOP
    default: return -1;
  }
}

Image parse(const uint8_t* d, size_t n, bool header_only, bool eoc = true) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0x4F)
    fail("not a JPEG 2000 codestream (no SOC marker)");
  Image im;
  size_t pos = 2;
  auto marker_at = [&](size_t p) -> int {
    if (p + 2 > n) fail("truncated JPEG 2000 codestream");
    return (d[p] << 8) | d[p + 1];
  };
  auto segment = [&](size_t p) -> Seg {
    if (p + 4 > n) fail("truncated JPEG 2000 codestream");
    size_t len = (d[p + 2] << 8) | d[p + 3];
    if (len < 2 || p + 2 + len > n) fail("truncated JPEG 2000 codestream");
    return Seg{d + p + 4, len - 2, 0, ""};
  };
  if (marker_at(pos) != 0xFF51)
    fail("JPEG 2000 codestream without a SIZ marker after SOC");
  {
    Seg s = segment(pos);
    s.what = "SIZ";
    read_siz(s, im);
    pos += 2 + 2 + s.n;
  }
  bool cod = false, qcd = false;
  for (;;) {  // the main header, up to the first SOT
    int m = marker_at(pos);
    if (m < 0xFF00)
      fail("JPEG 2000 main header with a byte that is not a marker");
    if (marker_places(m) < 0) {
      // OpenJPEG: a marker it does not know is skipped by looking at every
      // second byte for one it knows
      size_t q = pos + 2;
      for (;; q += 2) {
        if (q + 2 > n)
          fail("JPEG 2000 main header with an unknown marker and no known "
               "one after it");
        int v = (d[q] << 8) | d[q + 1];
        if (v >= 0xFF00 && marker_places(v) >= 0) break;
      }
      pos = q;
      m = marker_at(pos);
    }
    if (!(marker_places(m) & 1))
      fail("JPEG 2000 marker " + std::to_string(m) +
           " out of place in the main header");
    if (m == 0xFF90) break;
    Seg s = segment(pos);
    read_marker(m, s, im, im.def, cod, qcd);
    pos += 4 + s.n;
  }
  if (!cod) fail("JPEG 2000 main header without a COD marker");
  if (!qcd) fail("JPEG 2000 main header without a QCD marker");
  if (header_only) return im;
  im.tiles.assign((size_t)im.ntx * im.nty, im.def);
  for (;;) {
    if (pos + 2 > n) fail("JPEG 2000 codestream without EOC");
    int m = marker_at(pos);
    if (m == 0xFFD9) break;
    if (m != 0xFF90 && pos + 2 == n && !eoc) break;  // opj_decode reads on
    if (m != 0xFF90)
      fail("JPEG 2000 tile-part that does not start with SOT");
    size_t sot = pos;
    Seg s = segment(pos);
    s.what = "SOT";
    int isot = (int)s.get(2);
    uint32_t psot = s.get(4);
    int tpsot = (int)s.get(1), tnsot = (int)s.get(1);
    if (isot >= (int)im.tiles.size())
      fail("JPEG 2000 tile-part of tile " + std::to_string(isot) + " of " +
           std::to_string(im.tiles.size()));
    TCP& tcp = im.tiles[isot];
    // OpenJPEG: the tile's parts in order, within their number where given
    if (tpsot != tcp.parts)
      fail("JPEG 2000 tile-part " + std::to_string(tpsot) + " of tile " +
           std::to_string(isot) + " where part " + std::to_string(tcp.parts) +
           " is next");
    if (psot != 0 && psot < 14)
      fail("JPEG 2000 tile-part of Psot " + std::to_string(psot));
    if ((tcp.nparts && tpsot >= tcp.nparts) || (tnsot && tpsot >= tnsot))
      fail("JPEG 2000 tile-part " + std::to_string(tpsot) + " of " +
           std::to_string(tnsot ? tnsot : tcp.nparts));
    if (tnsot) tcp.nparts = tnsot;
    tcp.parts++;
    tcp.seen = true;
    pos += 4 + s.n;
    bool c2 = false, q2 = false;
    for (;;) {  // the tile-part header, up to SOD
      int mk = marker_at(pos);
      if (mk == 0xFF93) { pos += 2; break; }
      if (mk < 0xFF00)
        fail("JPEG 2000 tile-part header with a byte that is not a marker");
      if (marker_places(mk) >= 0 && !(marker_places(mk) & 2))
        fail("JPEG 2000 marker " + std::to_string(mk) +
             " out of place in a tile-part header");
      Seg t = segment(pos);
      read_marker(mk, t, im, tcp, c2, q2);
      pos += 4 + t.n;
    }
    size_t end;
    if (psot == 0) {  // the last tile-part: up to the last two bytes (EOC)
      if (n - pos < 2) fail("JPEG 2000 codestream without EOC");
      end = n - 2;
    } else {
      end = sot + psot;
      if (end > n) fail("truncated JPEG 2000 tile-part (Psot past the data)");
      if (end < pos) fail("JPEG 2000 tile-part shorter than its header");
    }
    tcp.data.insert(tcp.data.end(), d + pos, d + end);
    pos = end;
  }
  return im;
}

// ---------------------------------------------------------------------------
// tier-2: geometry, tag trees, packet headers
// ---------------------------------------------------------------------------

struct Bio {  // packet header bits, a 0 bit stuffed after each 0xFF
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = nbits - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
};

struct TagTree {
  struct Node { int parent, value, low; };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    std::vector<int> ws{w}, hs{h};
    int n = w * h;
    while (n > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
      n = ws.back() * hs.back();
    }
    int off = 0;
    for (size_t l = 0; l < ws.size(); l++) {
      int next = off + ws[l] * hs[l];
      for (int y = 0; y < hs[l]; y++)
        for (int x = 0; x < ws[l]; x++)
          nodes.push_back({l + 1 < ws.size()
                               ? next + (y / 2) * ws[l + 1] + x / 2 : -1,
                           999, 0});
      off = next;
    }
  }
  void reset() {
    for (auto& nd : nodes) { nd.value = 999; nd.low = 0; }
  }
  bool decode(Bio& bio, int leaf, int threshold) {
    int stack[40], sp = 0, node = leaf;
    while (nodes[node].parent >= 0) {
      stack[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) nd.low = low; else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.bit()) nd.value = low; else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stack[--sp];
    }
    return nodes[node].value < threshold;
  }
};

struct CodeSeg { int len = 0, numpasses = 0, maxpasses = 0, newpasses = 0,
                 newlen = 0; };

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numsegs = 0, newpasses = 0;
  std::vector<CodeSeg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int64_t x0, y0, x1, y1;
  int bandno, numbps;
  float stepsize;
  std::vector<Precinct> precs;
  bool empty() const { return x1 == x0 || y1 == y0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph, nbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<int32_t> idata;  // 5/3
  std::vector<float> fdata;    // 9/7
};

void init_tilecomp(TileComp& tc, const TCCP& t, const Comp& comp,
                   int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
  tc.x0 = ceildiv(tx0, comp.dx); tc.y0 = ceildiv(ty0, comp.dy);
  tc.x1 = ceildiv(tx1, comp.dx); tc.y1 = ceildiv(ty1, comp.dy);
  tc.res.assign(t.nres, Res());
  for (int r = 0; r < t.nres; r++) {
    Res& res = tc.res[r];
    int level = t.nres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, level); res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level); res.y1 = ceildivpow2(tc.y1, level);
    res.pdx = t.prcw[r]; res.pdy = t.prch[r];
    int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (int)((px1 - px0) >> res.pdx);
    res.ph = res.y0 == res.y1 ? 0 : (int)((py1 - py0) >> res.pdy);
    if ((int64_t)res.pw * res.ph > (1 << 22))
      fail("JPEG 2000 resolution of " +
           std::to_string((int64_t)res.pw * res.ph) + " precincts");
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0; cbgy0 = py0; cbgw = res.pdx; cbgh = res.pdy;
      res.nbands = 1;
    } else {
      cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
      cbgw = res.pdx - 1; cbgh = res.pdy - 1;
      res.nbands = 3;
    }
    int cbw = std::min(t.cblkw, cbgw), cbh = std::min(t.cblkh, cbgh);
    for (int b = 0; b < res.nbands; b++) {
      Band& band = res.bands[b];
      int si;
      if (r == 0) {
        band.bandno = 0;
        band.x0 = ceildivpow2(tc.x0, level); band.y0 = ceildivpow2(tc.y0, level);
        band.x1 = ceildivpow2(tc.x1, level); band.y1 = ceildivpow2(tc.y1, level);
        si = 0;
      } else {
        band.bandno = b + 1;
        int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (xb << level), level + 1);
        band.y0 = ceildivpow2(tc.y0 - (yb << level), level + 1);
        band.x1 = ceildivpow2(tc.x1 - (xb << level), level + 1);
        band.y1 = ceildivpow2(tc.y1 - (yb << level), level + 1);
        si = 3 * (r - 1) + 1 + b;
      }
      int gain = t.qmfbid == 0 ? 0
                 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
      int rb = comp.prec + gain;
      band.stepsize = (float)((1.0 + t.mant[si] / 2048.0) *
                              std::pow(2.0, (double)(rb - t.expn[si])));
      band.numbps = t.expn[si] + t.numgbits - 1;
      band.precs.assign((size_t)res.pw * res.ph, Precinct());
      for (int p = 0; p < res.pw * res.ph; p++) {
        Precinct& pr = band.precs[p];
        int64_t sx = cbgx0 + (int64_t)(p % res.pw) * (1 << cbgw);
        int64_t sy = cbgy0 + (int64_t)(p / res.pw) * (1 << cbgh);
        pr.x0 = (int)std::max(sx, band.x0);
        pr.y0 = (int)std::max(sy, band.y0);
        pr.x1 = (int)std::min(sx + (1 << cbgw), band.x1);
        pr.y1 = (int)std::min(sy + (1 << cbgh), band.y1);
        if (band.empty()) continue;
        int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
        int64_t by0 = floordivpow2(pr.y0, cbh) << cbh;
        int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
        int64_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
        pr.cw = (int)std::max<int64_t>(0, (bx1 - bx0) >> cbw);
        pr.ch = (int)std::max<int64_t>(0, (by1 - by0) >> cbh);
        pr.cblks.assign((size_t)pr.cw * pr.ch, Cblk());
        for (int i = 0; i < pr.cw * pr.ch; i++) {
          Cblk& cb = pr.cblks[i];
          int64_t cx = bx0 + (int64_t)(i % pr.cw) * (1 << cbw);
          int64_t cy = by0 + (int64_t)(i / pr.cw) * (1 << cbh);
          cb.x0 = (int)std::max<int64_t>(cx, pr.x0);
          cb.y0 = (int)std::max<int64_t>(cy, pr.y0);
          cb.x1 = (int)std::min<int64_t>(cx + (1 << cbw), pr.x1);
          cb.y1 = (int)std::min<int64_t>(cy + (1 << cbh), pr.y1);
        }
        pr.incl.init(pr.cw, pr.ch);
        pr.imsb.init(pr.cw, pr.ch);
      }
    }
  }
}

struct Packet { int layer, res, comp, prec; };

// The packets of a tile in its progression order, or in each of its
// progression order changes in turn (OpenJPEG's pi.c: each packet once, the
// position orders stepping over the tile's reference grid by the smallest
// precinct).
std::vector<Packet> progression(const Image& im, const TCP& tcp,
                                const std::vector<TileComp>& tcs,
                                int64_t tx0, int64_t ty0, int64_t tx1,
                                int64_t ty1) {
  const int nc = (int)tcs.size();
  int maxres = 0, maxprec = 0;
  for (int c = 0; c < nc; c++) {
    maxres = std::max(maxres, (int)tcs[c].res.size());
    for (auto& r : tcs[c].res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<Poc> pocs = tcp.pocs;
  if (pocs.empty()) pocs.push_back({0, 0, tcp.numlayers, maxres, nc, tcp.prg});
  const double packets = (double)tcp.numlayers * maxres * nc *
                         std::max(maxprec, 1);
  if (packets > (1 << 28))
    fail("JPEG 2000 tile of " + std::to_string((int64_t)packets) +
         " packets");
  std::vector<uint8_t> seen((size_t)packets);
  std::vector<Packet> out;
  auto emit = [&](int l, int r, int c, int p) {
    size_t i = (((size_t)l * maxres + r) * nc + c) * std::max(maxprec, 1) + p;
    if (!seen[i]) { seen[i] = 1; out.push_back({l, r, c, p}); }
  };
  // the precinct at (x, y) of component c, resolution r, or -1
  auto at = [&](int c, int r, int64_t x, int64_t y) -> int {
    const Comp& comp = im.comps[c];
    const Res& res = tcs[c].res[r];
    int level = (int)tcs[c].res.size() - 1 - r;
    int64_t cdx = (int64_t)comp.dx << level, cdy = (int64_t)comp.dy << level;
    int64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
    int64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(y % ((int64_t)comp.dy << rpy) == 0 ||
          (y == ty0 && ((try0 << level) % ((int64_t)1 << rpy)))))
      return -1;
    if (!(x % ((int64_t)comp.dx << rpx) == 0 ||
          (x == tx0 && ((trx0 << level) % ((int64_t)1 << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    int64_t pi = floordivpow2(ceildiv(x, cdx), res.pdx) -
                 floordivpow2(trx0, res.pdx);
    int64_t pj = floordivpow2(ceildiv(y, cdy), res.pdy) -
                 floordivpow2(try0, res.pdy);
    return (int)(pi + pj * res.pw);
  };
  auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; c++)
      for (int r = 0; r < (int)tcs[c].res.size(); r++) {
        int level = (int)tcs[c].res.size() - 1 - r;
        const Res& res = tcs[c].res[r];
        if (res.pdx + level < 31) {
          int64_t v = (int64_t)im.comps[c].dx << (res.pdx + level);
          dx = dx ? std::min(dx, v) : v;
        }
        if (res.pdy + level < 31) {
          int64_t v = (int64_t)im.comps[c].dy << (res.pdy + level);
          dy = dy ? std::min(dy, v) : v;
        }
      }
    if (dx == 0 || dy == 0) fail("JPEG 2000 precincts too large to step over");
  };
  for (const Poc& pc : pocs) {
    const int l1 = std::min(pc.l1, tcp.numlayers), r0 = pc.r0, r1 = pc.r1;
    const int c0 = pc.c0, c1 = pc.c1;
    auto nres = [&](int c) { return (int)tcs[c].res.size(); };
    auto layers = [&](int r, int c, int p) {
      for (int l = 0; l < l1; l++) emit(l, r, c, p);
    };
    auto precincts = [&](int l, int r, int c) {
      if (r >= nres(c)) return;
      const Res& res = tcs[c].res[r];
      for (int p = 0; p < res.pw * res.ph; p++) emit(l, r, c, p);
    };
    int64_t dx, dy;
    switch (pc.prg) {
      case 0:  // LRCP
        for (int l = 0; l < l1; l++)
          for (int r = r0; r < r1; r++)
            for (int c = c0; c < c1; c++) precincts(l, r, c);
        break;
      case 1:  // RLCP
        for (int r = r0; r < r1; r++)
          for (int l = 0; l < l1; l++)
            for (int c = c0; c < c1; c++) precincts(l, r, c);
        break;
      case 2:  // RPCL
        steps(0, nc, dx, dy);
        for (int r = r0; r < r1; r++)
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = c0; c < c1; c++) {
                if (r >= nres(c)) continue;
                int p = at(c, r, x, y);
                if (p >= 0) layers(r, c, p);
              }
        break;
      case 3:  // PCRL
        steps(0, nc, dx, dy);
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = c0; c < c1; c++)
              for (int r = r0; r < std::min(r1, nres(c)); r++) {
                int p = at(c, r, x, y);
                if (p >= 0) layers(r, c, p);
              }
        break;
      case 4:  // CPRL
        for (int c = c0; c < c1; c++) {
          steps(c, c + 1, dx, dy);
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int r = r0; r < std::min(r1, nres(c)); r++) {
                int p = at(c, r, x, y);
                if (p >= 0) layers(r, c, p);
              }
        }
        break;
      default:
        fail("JPEG 2000 progression order " + std::to_string(pc.prg));
    }
  }
  return out;
}

int numpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  int n = (int)bio.read(2);
  if (n != 3) return 3 + n;
  n = (int)bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + (int)bio.read(7);
}

// A new code-block segment's passes: 1 terminating each pass; with the
// bypass 10, then 2 and 1 by turns; 109 otherwise.
CodeSeg new_seg(const std::vector<CodeSeg>& segs, int segno, int cblksty) {
  CodeSeg sg;
  if (cblksty & 0x04) sg.maxpasses = 1;
  else if (cblksty & 0x01)
    sg.maxpasses = segno == 0 ? 10
                   : (segs[segno - 1].maxpasses == 1 ||
                      segs[segno - 1].maxpasses == 10) ? 2 : 1;
  else sg.maxpasses = 109;
  return sg;
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) { v >>= 1; l++; }
  return l;
}

// One packet from data[pos]: its header, then its code-block data.
size_t read_packet(const TCP& tcp, TileComp& tc, const Packet& pk,
                   const uint8_t* data, size_t pos, size_t n) {
  const int sty = tcp.tccps[pk.comp].cblksty;
  Res& res = tc.res[pk.res];
  if (pk.prec >= res.pw * res.ph)
    fail("JPEG 2000 packet of precinct " + std::to_string(pk.prec) + " of " +
         std::to_string(res.pw * res.ph));
  if (pk.layer == 0)
    for (int b = 0; b < res.nbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precs[pk.prec];
      pr.incl.reset();
      pr.imsb.reset();
      for (auto& cb : pr.cblks) cb.numsegs = 0;
    }
  if ((tcp.csty & 2) && n - pos >= 6 && data[pos] == 0xFF &&
      data[pos + 1] == 0x91)
    pos += 6;  // SOP
  Bio bio{data + pos, data + pos, data + n};
  bool present = bio.read(1);
  if (present) {
    for (int b = 0; b < res.nbands; b++) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precs[pk.prec];
      for (int i = 0; i < (int)pr.cblks.size(); i++) {
        Cblk& cb = pr.cblks[i];
        bool included = cb.numsegs == 0
                            ? pr.incl.decode(bio, i, pk.layer + 1)
                            : bio.read(1);
        if (!included) { cb.newpasses = 0; continue; }
        int segno;
        if (cb.numsegs == 0) {
          int z = 0;
          while (!pr.imsb.decode(bio, i, z)) ++z;
          cb.numbps = band.numbps + 1 - z;
          cb.numlenbits = 3;
          cb.segs.assign(1, new_seg(cb.segs, 0, sty));
          segno = 0;
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            if ((int)cb.segs.size() <= segno) cb.segs.resize(segno + 1);
            cb.segs[segno] = new_seg(cb.segs, segno, sty);
          }
        }
        cb.newpasses = numpasses(bio);
        while (bio.read(1)) cb.numlenbits++;
        int left = cb.newpasses;
        for (;;) {
          CodeSeg& sg = cb.segs[segno];
          sg.newpasses = std::min(sg.maxpasses - sg.numpasses, left);
          int bits = cb.numlenbits + floorlog2(sg.newpasses);
          if (bits > 32) fail("JPEG 2000 code-block length of " +
                              std::to_string(bits) + " bits");
          sg.newlen = (int)bio.read(bits);
          left -= sg.newpasses;
          if (left <= 0) break;
          ++segno;
          if ((int)cb.segs.size() <= segno) cb.segs.resize(segno + 1);
          cb.segs[segno] = new_seg(cb.segs, segno, sty);
        }
      }
    }
  }
  bio.inalign();
  pos = bio.bp - data;
  if ((tcp.csty & 4) && n - pos >= 2 && data[pos] == 0xFF &&
      data[pos + 1] == 0x92)
    pos += 2;  // EPH
  if (!present) return pos;
  for (int b = 0; b < res.nbands; b++) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    for (auto& cb : band.precs[pk.prec].cblks) {
      if (cb.newpasses == 0) continue;
      int segno;
      if (cb.numsegs == 0) {
        segno = 0;
        cb.numsegs = 1;
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          ++cb.numsegs;
        }
      }
      for (;;) {
        CodeSeg& sg = cb.segs[segno];
        if ((size_t)sg.newlen > n - pos)
          fail("truncated JPEG 2000 code-block data");
        cb.data.insert(cb.data.end(), data + pos, data + pos + sg.newlen);
        pos += sg.newlen;
        sg.numpasses += sg.newpasses;
        sg.len += sg.newlen;
        cb.newpasses -= sg.newpasses;
        if (cb.newpasses <= 0) break;
        ++segno;
        ++cb.numsegs;
      }
    }
  }
  return pos;
}

// ---------------------------------------------------------------------------
// tier-1: the MQ decoder and the coding passes
// ---------------------------------------------------------------------------

struct QeState { uint16_t qe; uint8_t nmps, nlps, sw; };
const QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

struct MQ {
  const uint8_t* bp;  // followed by 0xFF 0xFF
  uint32_t a, c;
  int ct;
  uint8_t st[kNumCtx], mps[kNumCtx];
  void reset() {
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[kCtxUni] = 46;
    st[kCtxAgg] = 3;
    st[0] = 4;
  }
  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)*bp << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)*bp << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data) {
    bp = data;
    c = (uint32_t)*bp << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* data) {  // the bypass: raw bits
    bp = data;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const QeState& s = kQe[st[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        st[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= (uint32_t)s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// neighbour significance bits, then the sample's own state
enum : uint16_t {
  kNW = 1, kN = 2, kNE = 4, kW = 8, kE = 16, kSW = 32, kS = 64, kSE = 128,
  kSig = 256, kVisit = 512, kRefined = 1024, kNeg = 2048
};

struct ZcLut {
  uint8_t t[4][256];
  ZcLut() {
    for (int o = 0; o < 4; o++)
      for (int f = 0; f < 256; f++) {
        int h = !!(f & kW) + !!(f & kE), v = !!(f & kN) + !!(f & kS);
        int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
        int n;
        if (o == 1) std::swap(h, v);  // HL: vertical neighbours first
        if (o == 3) {
          int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        } else {
          if (h == 0) {
            if (v == 0) n = d == 0 ? 0 : d == 1 ? 1 : 2;
            else n = v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v ? 7 : d ? 6 : 5;
          } else {
            n = 8;
          }
        }
        t[o][f] = (uint8_t)n;
      }
  }
};
const ZcLut kZc;

struct T1 {
  int w, h, stride;
  bool vsc;
  const uint8_t* zc;
  std::vector<uint16_t> f;
  std::vector<int32_t> d;
  MQ mq;

  void init(int w_, int h_, int orient, bool vsc_) {
    w = w_; h = h_; stride = w + 2; vsc = vsc_;
    zc = kZc.t[orient];
    f.assign((size_t)stride * (h + 2), 0);
    d.assign((size_t)w * h, 0);
  }
  uint16_t& flag(int x, int y) { return f[(size_t)(y + 1) * stride + x + 1]; }

  static int contrib(uint16_t g) {
    return (g & kSig) ? ((g & kNeg) ? -1 : 1) : 0;
  }
  void decode_sign(int x, int y, int one_half, bool raw = false) {
    uint16_t* p = &flag(x, y);
    int neg = raw ? mq.raw() : sign(p, y);
    d[(size_t)y * w + x] = neg ? -one_half : one_half;
    *p |= kSig | (neg ? kNeg : 0);
    p[-1] |= kE;
    p[1] |= kW;
    if (!(vsc && (y & 3) == 0)) {
      p[-stride - 1] |= kSE;
      p[-stride] |= kS;
      p[-stride + 1] |= kSW;
    }
    p[stride - 1] |= kNE;
    p[stride] |= kN;
    p[stride + 1] |= kNW;
  }
  int sign(const uint16_t* p, int y) {
    int hc = contrib(p[-1]) + contrib(p[1]);
    int vc = contrib(p[-stride]) +
             ((vsc && (y & 3) == 3) ? 0 : contrib(p[stride]));
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    int xr = 0, ctx;
    if (hc == 0) {
      ctx = vc == 0 ? 9 : 10;
      xr = vc < 0;
    } else {
      xr = hc < 0;
      int v = hc < 0 ? -vc : vc;
      ctx = v < 0 ? 11 : v == 0 ? 12 : 13;
    }
    return mq.decode(ctx) ^ xr;
  }

  void sigpass(int bp, bool raw) {
    int one = 1 << bp, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) {
          uint16_t& g = flag(x, y);
          if ((g & (kSig | kVisit)) || !(g & 0xff)) continue;
          if (raw ? mq.raw() : mq.decode(zc[g & 0xff]))
            decode_sign(x, y, oph, raw);
          g |= kVisit;
        }
  }

  void refpass(int bp, bool raw) {
    int poshalf = (1 << bp) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++)
        for (int y = k; y < std::min(k + 4, h); y++) {
          uint16_t& g = flag(x, y);
          if ((g & (kSig | kVisit)) != kSig) continue;
          int ctx = (g & kRefined) ? 16 : (g & 0xff) ? 15 : 14;
          int v = raw ? mq.raw() : mq.decode(ctx);
          int32_t& c = d[(size_t)y * w + x];
          c += (v ^ (c < 0)) ? poshalf : -poshalf;
          g |= kRefined;
        }
  }

  void clnpass(int bp, bool segsym) {
    int one = 1 << bp, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; x++) {
        int y = k;
        if (k + 3 < h) {
          bool run = true;
          for (int j = k; j < k + 4 && run; j++)
            run = (flag(x, j) & (kSig | kVisit | 0xff)) == 0;
          if (run) {
            if (!mq.decode(kCtxAgg)) continue;
            int r = mq.decode(kCtxUni) << 1;
            r |= mq.decode(kCtxUni);
            y = k + r;
            decode_sign(x, y, oph);
            y++;
          }
        }
        for (; y < std::min(k + 4, h); y++) {
          uint16_t& g = flag(x, y);
          if (g & (kSig | kVisit)) continue;
          if (mq.decode(zc[g & 0xff])) decode_sign(x, y, oph);
        }
      }
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) flag(x, y) &= ~kVisit;
    if (segsym)
      for (int i = 0; i < 4; i++) mq.decode(kCtxUni);
  }

  void decode(const Cblk& cb, int orient, int roishift, int cblksty) {
    init(cb.x1 - cb.x0, cb.y1 - cb.y0, orient, cblksty & 0x08);
    if (cb.numsegs == 0) return;
    int bp = roishift + cb.numbps;
    if (bp >= 31)
      fail("JPEG 2000 code-block of " + std::to_string(bp) + " bit-planes");
    int passtype = 2;
    mq.reset();
    size_t at = 0;
    std::vector<uint8_t> buf;
    for (int s = 0; s < cb.numsegs; s++) {
      const CodeSeg& sg = cb.segs[s];
      buf.assign(cb.data.begin() + at, cb.data.begin() + at + sg.len);
      buf.push_back(0xFF);
      buf.push_back(0xFF);
      at += sg.len;
      // the bypass: significance and refinement passes past the fourth
      // bit-plane are raw
      const bool raw = (cblksty & 0x01) && passtype < 2 &&
                       bp <= cb.numbps - 4;
      if (raw) mq.raw_init(buf.data());
      else mq.init(buf.data());
      for (int p = 0; p < sg.numpasses && bp >= 1; p++) {
        if (passtype == 0) sigpass(bp, raw);
        else if (passtype == 1) refpass(bp, raw);
        else clnpass(bp, cblksty & 0x20);
        if ((cblksty & 0x02) && !raw) mq.reset();
        if (++passtype == 3) { passtype = 0; bp--; }
      }
    }
    if (roishift) {
      if (roishift >= 31) {
        std::fill(d.begin(), d.end(), 0);
      } else {
        int32_t thresh = 1 << roishift;
        for (auto& v : d) {
          int32_t mag = std::abs(v);
          if (mag >= thresh) {
            mag >>= roishift;
            v = v < 0 ? -mag : mag;
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// inverse wavelet transforms
// ---------------------------------------------------------------------------

// One line of n samples, lows first (sn of them), in place; cas: the
// parity of the line's first coordinate.
void idwt53(int32_t* line, int sn, int n, int cas, std::vector<int32_t>& tmp) {
  if (n == 1) {
    if (cas) line[0] /= 2;
    return;
  }
  tmp.resize(n);
  int32_t* X = tmp.data();
  for (int i = 0; i < n; i++) {  // interleave
    int low = ((i + cas) & 1) == 0;
    X[i] = low ? line[(i - cas) / 2] : line[sn + (i - (1 - cas)) / 2];
  }
  auto at = [&](int i) { return X[i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i]; };
  for (int i = cas; i < n; i += 2)  // lows: even coordinates
    X[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2)
    X[i] += (at(i - 1) + at(i + 1)) >> 1;
  std::memcpy(line, X, sizeof(int32_t) * n);
}

const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f;

void idwt97(float* line, int sn, int n, int cas, std::vector<float>& tmp) {
  int dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  tmp.resize(n);
  float* X = tmp.data();
  for (int i = 0; i < n; i++) {
    int low = ((i + cas) & 1) == 0;
    X[i] = low ? line[(i - cas) / 2] : line[sn + (i - (1 - cas)) / 2];
  }
  for (int i = cas; i < n; i += 2) X[i] = X[i] * kK;
  for (int i = 1 - cas; i < n; i += 2) X[i] = X[i] * kTwoInvK;
  auto lift = [&](int first, float c) {
    for (int i = first; i < n; i += 2) {
      float l = X[i - 1 < 0 ? 1 : i - 1];
      float r = X[i + 1 >= n ? i - 1 : i + 1];
      X[i] = X[i] + (l + r) * c;
    }
  };
  lift(cas, -kDelta);
  lift(1 - cas, -kGamma);
  lift(cas, -kBeta);
  lift(1 - cas, -kAlpha);
  std::memcpy(line, X, sizeof(float) * n);
}

template <typename T, typename F>
void idwt(std::vector<T>& data, const TileComp& tc, F line_fn) {
  const int64_t w = tc.x1 - tc.x0;
  std::vector<T> tmp, col;
  for (size_t r = 1; r < tc.res.size(); r++) {
    const Res& lo = tc.res[r - 1];
    const Res& res = tc.res[r];
    int rw = (int)(res.x1 - res.x0), rh = (int)(res.y1 - res.y0);
    int sw = (int)(lo.x1 - lo.x0), sh = (int)(lo.y1 - lo.y0);
    if (rw == 0 || rh == 0) continue;
    for (int y = 0; y < rh; y++)
      line_fn(&data[(size_t)y * w], sw, rw, (int)(res.x0 & 1), tmp);
    col.resize(rh);
    for (int x = 0; x < rw; x++) {
      for (int y = 0; y < rh; y++) col[y] = data[(size_t)y * w + x];
      line_fn(col.data(), sh, rh, (int)(res.y0 & 1), tmp);
      for (int y = 0; y < rh; y++) data[(size_t)y * w + x] = col[y];
    }
  }
}

// ---------------------------------------------------------------------------
// a tile
// ---------------------------------------------------------------------------

void decode_tile(const Image& im, TCP& tcp, int tileno,
                 std::vector<int32_t*>& planes) {
  const int nc = (int)im.comps.size();
  int p = tileno % im.ntx, q = tileno / im.ntx;
  int64_t tx0 = std::max(im.tx0 + p * im.tdx, im.x0);
  int64_t ty0 = std::max(im.ty0 + q * im.tdy, im.y0);
  int64_t tx1 = std::min(im.tx0 + (p + 1) * im.tdx, im.x1);
  int64_t ty1 = std::min(im.ty0 + (q + 1) * im.tdy, im.y1);
  std::vector<TileComp> tcs(nc);
  for (int c = 0; c < nc; c++)
    init_tilecomp(tcs[c], tcp.tccps[c], im.comps[c], tx0, ty0, tx1, ty1);
  const std::vector<Packet> packets =
      progression(im, tcp, tcs, tx0, ty0, tx1, ty1);
  size_t pos = 0;
  for (const Packet& pk : packets)
    pos = read_packet(tcp, tcs[pk.comp], pk, tcp.data.data(), pos,
                      tcp.data.size());
  T1 t1;
  for (int c = 0; c < nc; c++) {
    TileComp& tc = tcs[c];
    const TCCP& t = tcp.tccps[c];
    const int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    if (t.qmfbid == 1) tc.idata.assign((size_t)(w * h), 0);
    else tc.fdata.assign((size_t)(w * h), 0.0f);
    for (size_t r = 0; r < tc.res.size(); r++) {
      Res& res = tc.res[r];
      for (int b = 0; b < res.nbands; b++) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        int64_t xo = 0, yo = 0;
        if (band.bandno & 1) xo = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) yo = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float step = 0.5f * band.stepsize;
        for (auto& pr : band.precs)
          for (auto& cb : pr.cblks) {
            t1.decode(cb, band.bandno, t.roishift, t.cblksty);
            for (int y = 0; y < t1.h; y++) {
              size_t row = (size_t)(cb.y0 - band.y0 + yo + y) * w +
                           (cb.x0 - band.x0 + xo);
              const int32_t* src = &t1.d[(size_t)y * t1.w];
              if (t.qmfbid == 1)
                for (int x = 0; x < t1.w; x++) tc.idata[row + x] = src[x] / 2;
              else
                for (int x = 0; x < t1.w; x++)
                  tc.fdata[row + x] = (float)src[x] * step;
            }
          }
      }
    }
    if (t.qmfbid == 1) idwt(tc.idata, tc, idwt53);
    else idwt(tc.fdata, tc, idwt97);
  }
  if (tcp.mct == 1 && nc >= 3) {
    size_t n = tcs[0].idata.size() + tcs[0].fdata.size();
    bool same = true;
    for (int c = 1; c < 3; c++)
      same = same && tcs[c].x1 - tcs[c].x0 == tcs[0].x1 - tcs[0].x0 &&
             tcs[c].y1 - tcs[c].y0 == tcs[0].y1 - tcs[0].y0;
    if (same && tcp.tccps[0].qmfbid == 0) {
      if (tcs[1].fdata.size() != n || tcs[2].fdata.size() != n)
        fail("JPEG 2000 colour transform over components of both wavelets");
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(),
            *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < n; i++) {
        float y = c0[i], u = c1[i], v = c2[i];
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * 0.71414f);
        float b = y + (u * 1.772f);
        c0[i] = r; c1[i] = g; c2[i] = b;
      }
    } else if (same) {
      if (tcs[1].idata.size() != n || tcs[2].idata.size() != n)
        fail("JPEG 2000 colour transform over components of both wavelets");
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(),
              *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < n; i++) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g; c1[i] = g; c2[i] = u + g;
      }
    }
  }
  for (int c = 0; c < nc; c++) {
    const Comp& comp = im.comps[c];
    const TileComp& tc = tcs[c];
    int64_t lo = comp.sgnd ? -((int64_t)1 << (comp.prec - 1)) : 0;
    int64_t hi = comp.sgnd ? ((int64_t)1 << (comp.prec - 1)) - 1
                           : ((int64_t)1 << comp.prec) - 1;
    int64_t shift = comp.sgnd ? 0 : (int64_t)1 << (comp.prec - 1);
    int64_t cx0 = ceildiv(im.x0, comp.dx), cy0 = ceildiv(im.y0, comp.dy);
    int64_t cw = ceildiv(im.x1, comp.dx) - cx0;
    int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    for (int64_t y = 0; y < h; y++) {
      int32_t* dst = planes[c] + (tc.y0 - cy0 + y) * cw + (tc.x0 - cx0);
      for (int64_t x = 0; x < w; x++) {
        int64_t v;
        if (tcp.tccps[c].qmfbid == 1) {
          v = (int64_t)tc.idata[y * w + x] + shift;
        } else {
          float f = tc.fdata[y * w + x];
          if (f > (float)INT32_MAX) { dst[x] = (int32_t)hi; continue; }
          if (f < (float)INT32_MIN) { dst[x] = (int32_t)lo; continue; }
          v = (int64_t)std::nearbyintf(f) + shift;
        }
        dst[x] = (int32_t)std::max(lo, std::min(hi, v));
      }
    }
  }
}

void decode(const uint8_t* data, size_t n, bool eoc, int32_t* out) {
  Image im = parse(data, n, false, eoc);
  std::vector<int32_t*> planes;
  int32_t* at = out;
  for (const Comp& c : im.comps) {
    planes.push_back(at);
    int64_t w = ceildiv(im.x1, c.dx) - ceildiv(im.x0, c.dx);
    int64_t h = ceildiv(im.y1, c.dy) - ceildiv(im.y0, c.dy);
    std::memset(at, 0, sizeof(int32_t) * w * h);
    at += w * h;
  }
  for (size_t t = 0; t < im.tiles.size(); t++)
    if (im.tiles[t].seen) decode_tile(im, im.tiles[t], (int)t, planes);
}

}  // namespace

extern "C" {

int crdr_j2k_header(const uint8_t* data, int64_t n, int32_t* info,
                    int info_n, char* err, int errlen) {
  try {
    Image im = parse(data, (size_t)n, true);
    int need = 5 + 4 * (int)im.comps.size();
    if (info_n < need) fail("JPEG 2000 with " +
                            std::to_string(im.comps.size()) + " components");
    if (im.x1 > INT32_MAX || im.y1 > INT32_MAX)
      fail("JPEG 2000 image past 2^31 on the reference grid");
    info[0] = (int32_t)im.x0; info[1] = (int32_t)im.y0;
    info[2] = (int32_t)im.x1; info[3] = (int32_t)im.y1;
    info[4] = (int32_t)im.comps.size();
    for (size_t c = 0; c < im.comps.size(); c++) {
      info[5 + 4 * c] = im.comps[c].prec;
      info[6 + 4 * c] = im.comps[c].sgnd;
      info[7 + 4 * c] = im.comps[c].dx;
      info[8 + 4 * c] = im.comps[c].dy;
    }
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

int crdr_j2k_decode(const uint8_t* data, int64_t n, int eoc, int32_t* out,
                    char* err, int errlen) {
  try {
    decode(data, (size_t)n, eoc != 0, out);
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
