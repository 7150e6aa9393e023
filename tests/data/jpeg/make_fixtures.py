"""Make the JPEG fixtures of this folder and their ``digests.json``.

    python tests/data/jpeg/make_fixtures.py

Seeded synthetic images, written with cv2 and PIL (the JAX package's JPEG
readers), one file per variant the port's decoder (``utils/jpeg.py``) is
held to: baseline at every sampling cv2 writes, grayscale, progressive,
restart intervals, optimized Huffman tables, odd sizes, EXIF orientations
2-8, Adobe CMYK (and YCCK, its Adobe transform byte set to 2), and one
photo-like 768x512 image for timing.  The variants neither writes are made
from a baseline file: its SOF0 marker rewritten to SOF9 (arithmetic) and to
SOF3 (lossless), its precision byte set to 12.  Four files are cut short,
as a scraped training set holds them: mid-scan (a baseline file), inside
the last scan of a progressive one, where a restart marker was due, and
just before EOI; ``cv2.imread`` reads each (libjpeg's "Premature end of
JPEG file": the rest of the image gray, or as the scans read so far left
it) and PIL refuses each ("image file is truncated").
Two files hold what ``cv2.imencode('.jpg')`` writes at its defaults (quality
95, 4:2:0), for the port's encoder (``utils/jpeg.py::encode_jpeg``): of the
768x512 photo's decoded pixels, and of that JPEG's decoded pixels (a
reconstruction); ``bytes`` in their entries is the sha256 of the file.

``digests.json`` holds, for each decodable file, the sha256 of the pixels
(uint8 RGB, row-major) that ``cv2.imread`` gives (``file``: EXIF orientation
applied) and that ``PIL.Image.open(...).convert("RGB")`` gives (``body``),
with their shapes; for each refused file, the reason the port gives; for
each truncated file, cv2's digests, the port's reason for refusing it on
the body path (``body_raises``) and PIL's message (``pil``).
``tests/test_torch_jpeg.py`` recomputes both from the committed files.

Arithmetic coding (SOF9 sequential, SOF10 progressive, DAC conditioning,
restart intervals): neither cv2 nor PIL writes it, so this script has its
own QM coder (T.81 Annex D, Table D.2's Qe values) and the encoding
procedures of F.1.4 and G.1.3 (``QMEncoder``, ``ScanCoder``,
``arith_jpeg``), fed the quantized coefficients of a baseline file PIL
wrote (``huffman_coefficients``, a plain Huffman decoder).  That file is
the arithmetic file's Huffman twin (``arith_twin_*.jpg``): before any
digest is written, ``cv2.imread`` of each arithmetic file must equal
``cv2.imread`` of its twin byte for byte (``TWINS``).  Block smoothing
(libjpeg's ``decompress_smooth_data``): progressive files with scans cut
out of the scan list (``smooth_*``: each last refinement in turn, all of
them, an AC first scan with the scans that refine it) and progressive
files cut inside each of their scans (``truncated_*_scan*``), of a 4:2:0
and a 4:4:4 file, Huffman and arithmetic.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

REFUSED = {
    "refused_sof3.jpg": "lossless JPEG",
    "refused_12bit.jpg": "12-bit samples",
}
# read on the file path as cv2 reads them, refused on the body path (and
# every "truncated_*" file made below)
TRUNCATED = ("truncated_baseline.jpg", "truncated_progressive.jpg",
             "truncated_restart.jpg", "truncated_no_eoi.jpg")


NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1),
    (0x5a1d, 113, 113, 0)]  # 113: the fixed probability 0.5


class QMEncoder:
    """T.81 Annex D's encoder (D.1), with its byte output and termination
    as libjpeg's jcarith.c runs them; a bin is a one-element list holding
    the state index and, in bit 7, the more probable symbol."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit_zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _flush_stack(self, carry: bool):
        """The buffered byte and the stacked 0xFF bytes, with a carry or
        without."""
        if carry:
            if self.buffer >= 0:
                self._emit_zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc  # the carry turns the stacked 0xFF to 0x00
            self.sc = 0
            return
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._emit_zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._emit_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: list, val: int):
        sv = st[0]
        qe, nl, nm, sw = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ (nl | sw << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[0] = (sv & 0x80) ^ nm
        while True:  # renormalization, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._flush_stack(True)
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack(False)
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """D.1.8's termination -> the segment's bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._flush_stack(True)
        else:
            self._flush_stack(False)
        if self.c & 0x7FFF800:
            self._emit_zeros()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _bins(n: int) -> list:
    return [[0] for _ in range(n)]


class ScanCoder:
    """The F.1.4 / G.1.3 encoding procedures of one scan (jcarith.c)."""

    def __init__(self, dac):
        self.dac_l, self.dac_u, self.dac_k = dac
        self.qm = QMEncoder()
        self.fixed = [113]

    def dc(self, stats, tbl, diff, ctx):
        """Figures F.4, F.6-F.9: one DC difference -> the next context."""
        enc = self.qm.encode
        if diff == 0:
            enc(stats[ctx], 0)
            return 0
        enc(stats[ctx], 1)
        sign = diff < 0
        v = -diff if sign else diff
        enc(stats[ctx + 1], int(sign))
        s = ctx + 2 + sign
        m = 0
        v -= 1
        if v:
            enc(stats[s], 1)
            m = 1
            v2 = v
            s = 20
            while True:
                v2 >>= 1
                if not v2:
                    break
                enc(stats[s], 1)
                m <<= 1
                s += 1
        enc(stats[s], 0)
        if m < (1 << self.dac_l[tbl]) >> 1:
            new = 0
        elif m > (1 << self.dac_u[tbl]) >> 1:
            new = 12 + sign * 4
        else:
            new = 4 + sign * 4
        s += 14
        while True:
            m >>= 1
            if not m:
                break
            enc(stats[s], 1 if m & v else 0)
        return new

    def ac(self, stats, tbl, vals, ss, se):
        """Figure F.5 / G.3: the (point-transformed) coefficients ss..se of
        one block, in zigzag order."""
        enc = self.qm.encode
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc(stats[st], 0)  # not EOB
            while vals[k] == 0:
                enc(stats[st + 1], 0)
                st += 3
                k += 1
            v = vals[k]
            enc(stats[st + 1], 1)
            enc(self.fixed, 1 if v < 0 else 0)
            v = abs(v)
            st += 2
            m = 0
            v -= 1
            bins, i = stats, st
            if v:
                enc(stats[st], 1)
                m = 1
                v2 = v >> 1
                if v2:
                    enc(stats[st], 1)
                    m <<= 1
                    i = 189 if k <= self.dac_k[tbl] else 217
                    while True:
                        v2 >>= 1
                        if not v2:
                            break
                        enc(stats[i], 1)
                        m <<= 1
                        i += 1
            enc(bins[i], 0)
            i += 14
            while True:
                m >>= 1
                if not m:
                    break
                enc(bins[i], 1 if m & v else 0)
            k += 1
        if k <= se:
            enc(stats[3 * (k - 1)], 1)  # EOB

    def ac_refine(self, stats, vals, prev, ss, se):
        """Figure G.10: the next bit of coefficients ss..se (vals: |coef|
        >> al with signs; prev: |coef| >> ah)."""
        enc = self.qm.encode
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        kex = ke
        while kex > 0 and prev[kex] == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc(stats[st], 0)
            while True:
                v = vals[k]
                if v:
                    if prev[k]:  # previously nonzero: its correction bit
                        enc(stats[st + 2], abs(v) & 1)
                    else:
                        enc(stats[st + 1], 1)
                        enc(self.fixed, 1 if v < 0 else 0)
                    break
                enc(stats[st + 1], 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc(stats[3 * (k - 1)], 1)


def _segments(data: bytes):
    """(marker, payload) of each marker segment before the first SOS, then
    (0xDA, SOS payload, entropy data)."""
    pos = 2
    while True:
        m = data[pos + 1]
        n = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if m == 0xDA:
            end = pos
            while not (data[end] == 0xFF and data[end + 1] not in
                       (0, *range(0xD0, 0xD8))):
                end += 1
            yield m, body, data[pos:end]
            return
        yield m, body, None


def huffman_coefficients(data: bytes) -> dict:
    """A baseline (SOF0) Huffman JPEG's quantized coefficients, per
    component [bh, bw, 64] in zigzag order over whole MCUs, with its frame
    and its DQT / APP0 segments (a plain decoder, independent of the
    port's)."""
    tables, frame, keep = {}, None, []
    for m, body, ecs in _segments(data):
        if m in (0xDB, 0xE0):
            keep.append((m, body))
        elif m == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                vals = body[i + 17:i + 17 + sum(counts)]
                codes, code, k = {}, 0, 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        codes[(length, code)] = vals[k]
                        code += 1
                        k += 1
                    code <<= 1
                tables[(tc, th)] = codes
                i += 17 + sum(counts)
        elif m == 0xC0:
            h, w, nc = struct.unpack_from(">HHB", body, 1)
            comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(nc)]
            frame = (w, h, [(c, hv >> 4, hv & 15, tq) for c, hv, tq in comps])
        elif m == 0xDA:
            sos, data_ = body, ecs
        elif m == 0xDD:
            raise ValueError("restart intervals are not read here")
    w, h, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    ns = sos[0]
    sel = {sos[1 + 2 * i]: sos[2 + 2 * i] for i in range(ns)}
    raw = data_.replace(b"\xff\x00", b"\xff")
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    pos = 0

    def read(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = v << 1 | int(bits[pos])
            pos += 1
        return v

    def huff(codes):
        code = 0
        for length in range(1, 17):
            code = code << 1 | read(1)
            if (length, code) in codes:
                return codes[(length, code)]
        raise ValueError("bad Huffman code")

    def extend(v, s):
        return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v

    coefs, preds = [], []
    for cid, hs, vs, tq in comps:
        if nc == 1:
            bw, bh = -(-w * hs // hmax // 8), -(-h * vs // vmax // 8)
        else:
            bw, bh = mcux * hs, mcuy * vs
        coefs.append(np.zeros((bh, bw, 64), np.int64))
        preds.append(0)
    units = ([(0, y, x) for y in range(coefs[0].shape[0])
              for x in range(coefs[0].shape[1])] if nc == 1 else
             [(ci, my * c[2] + yy, mx * c[1] + xx)
              for my in range(mcuy) for mx in range(mcux)
              for ci, c in enumerate(comps)
              for yy in range(c[2]) for xx in range(c[1])])
    for ci, by, bx in units:
        t = sel[comps[ci][0]]
        s = huff(tables[(0, t >> 4)])
        preds[ci] += extend(read(s), s)
        blk = coefs[ci][by, bx]
        blk[0] = preds[ci]
        k = 1
        while k < 64:
            rs = huff(tables[(1, t & 15)])
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[k] = extend(read(s), s)
                k += 1
            elif r == 15:
                k += 16
            else:
                break
    return {"width": w, "height": h, "comps": comps, "coefs": coefs,
            "segments": keep}


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


# libjpeg's default progressive script (jcparam.c jpeg_simple_progression)
# for three components, and for one
SCRIPT3 = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
           ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
           ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
           ((0,), 1, 63, 1, 0)]
SCRIPT1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
           ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def arith_jpeg(src: dict, script=None, restart: int = 0, dac=None) -> bytes:
    """The coefficients of ``huffman_coefficients`` written as an
    arithmetic-coded JPEG: sequential (SOF9) or, with a scan ``script`` of
    (components, Ss, Se, Ah, Al), progressive (SOF10); ``restart``: MCUs a
    restart interval; ``dac``: {(Tc, Tb): value} conditioning (DAC)."""
    w, h, comps, coefs = src["width"], src["height"], src["comps"], \
        src["coefs"]
    dl, du, dk = [0] * 16, [1] * 16, [5] * 16
    dac = dac or {}
    for (tc, tb), v in dac.items():
        if tc == 0:
            dl[tb], du[tb] = v & 15, v >> 4
        else:
            dk[tb] = v
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    nc = len(comps)
    out = bytearray(b"\xff\xd8")
    for m, body in src["segments"]:
        out += _segment(m, body)
    if dac:
        out += _segment(0xCC, b"".join(bytes([tc << 4 | tb, v])
                                       for (tc, tb), v in sorted(dac.items())))
    sof = 0xCA if script else 0xC9
    out += _segment(sof, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c, hs << 4 | vs, tq]) for c, hs, vs, tq in comps))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    # table numbers: component i uses DC and AC table min(i, 1)
    tbl = [min(i, 1) for i in range(nc)]
    for cis, ss, se, ah, al in script or [(tuple(range(nc)), 0, 63, 0, 0)]:
        out += _segment(0xDA, bytes([len(cis)]) + b"".join(
            bytes([comps[i][0], tbl[i] << 4 | tbl[i]]) for i in cis)
            + bytes([ss, se, ah << 4 | al]))
        out += _scan(coefs, comps, cis, ss, se, ah, al, bool(script), w, h,
                     mcux, mcuy, restart, tbl, (dl, du, dk))
    return bytes(out + b"\xff\xd9")


def _pt(v: int, al: int) -> int:
    """The point transform of an AC coefficient: |v| >> al, signed."""
    return -((-v) >> al) if v < 0 else v >> al


def _scan(coefs, comps, cis, ss, se, ah, al, progressive, w, h, mcux, mcuy,
          restart, tbl, dac) -> bytes:
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(cis) > 1:
        units = [[(ci, my * comps[ci][2] + yy, mx * comps[ci][1] + xx)
                  for ci in cis for yy in range(comps[ci][2])
                  for xx in range(comps[ci][1])]
                 for my in range(mcuy) for mx in range(mcux)]
    else:
        ci = cis[0]
        bw = -(-(-(-w * comps[ci][1] // hmax)) // 8)
        bh = -(-(-(-h * comps[ci][2] // vmax)) // 8)
        units = [[(ci, y, x)] for y in range(bh) for x in range(bw)]
    segs, coder = [], None
    for n, mcu in enumerate(units):
        if coder is None or (restart and n % restart == 0 and n):
            if coder is not None:
                segs.append(coder.qm.finish())
            coder = ScanCoder(dac)
            dc_stats = {t: _bins(64) for t in set(tbl)}
            ac_stats = {t: _bins(256) for t in set(tbl)}
            last = {i: 0 for i in cis}
            ctx = {i: 0 for i in cis}
        for ci, by, bx in mcu:
            blk = coefs[ci][by, bx]
            t = tbl[ci]
            if ss == 0 and ah == 0:
                v = int(blk[0]) >> al
                ctx[ci] = coder.dc(dc_stats[t], t, v - last[ci], ctx[ci])
                last[ci] = v
                if not progressive:
                    coder.ac(ac_stats[t], t, [int(x) for x in blk], 1, 63)
            elif ss == 0:
                coder.qm.encode(coder.fixed, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                coder.ac(ac_stats[t], t, [_pt(int(x), al) for x in blk],
                         ss, se)
            else:
                coder.ac_refine(ac_stats[t], [_pt(int(x), al) for x in blk],
                                [abs(int(x)) >> ah for x in blk], ss, se)
    segs.append(coder.qm.finish())
    return b"".join(seg + (bytes([0xFF, 0xD0 + i % 8]) if i < len(segs) - 1
                           else b"") for i, seg in enumerate(segs))


def scans(data: bytes):
    """(the bytes before the first SOS, [each scan's SOS segment and
    entropy-coded data], the bytes after the last scan)."""
    first = data.index(b"\xff\xda")
    pos, out = first, []
    while data[pos:pos + 2] == b"\xff\xda":
        end = pos + 2 + struct.unpack_from(">H", data, pos + 2)[0]
        while not (data[end] == 0xFF and data[end + 1] not in
                   (0, *range(0xD0, 0xD8))):
            end += 1
        out.append(data[pos:end])
        pos = end
        while data[pos:pos + 2] not in (b"\xff\xda", b"\xff\xd9"):
            # tables between scans (DHT) stay with the scan that follows
            n = struct.unpack_from(">H", data, pos + 2)[0]
            out.append(data[pos:pos + 2 + n])
            pos += 2 + n
    return data[:first], out, data[pos:]


def scan_params(scan: bytes) -> tuple:
    """(component ids, Ss, Se, Ah, Al) of an SOS segment."""
    ns = scan[4]
    ss, se, a = scan[5 + 2 * ns:8 + 2 * ns]
    return tuple(scan[5 + 2 * i] for i in range(ns)), ss, se, a >> 4, a & 15


def without_scans(data: bytes, drop) -> bytes:
    """A progressive file with the scans ``drop`` (indexes among its SOS
    segments) cut out, and every later scan that refines what they carried
    (the same component, an overlapping band), so the progression stays
    consistent."""
    head, parts, tail = scans(data)
    sos = [p for p in parts if p[:2] == b"\xff\xda"]
    gone = set()
    for i, p in enumerate(sos):
        c, ss, se, _, _ = scan_params(p)
        if i in drop or any(set(c) & set(scan_params(sos[j])[0]) and not (
                se < scan_params(sos[j])[1] or ss > scan_params(sos[j])[2])
                for j in gone):
            gone.add(i)
    keep, i = [], 0
    for p in parts:
        if p[:2] == b"\xff\xda":
            if i not in gone:
                keep.append(p)
            i += 1
        else:
            keep.append(p)
    return head + b"".join(keep) + tail


def cut_in_scan(data: bytes, k: int) -> bytes:
    """The file cut halfway into scan ``k``'s entropy-coded data."""
    head, parts, _ = scans(data)
    at = len(head)
    for p in parts:
        if p[:2] == b"\xff\xda":
            if k == 0:
                n = 2 + struct.unpack_from(">H", p, 2)[0]
                return data[:at + n + (len(p) - n) // 2]
            k -= 1
        at += len(p)
    raise ValueError("no such scan")


def synthetic(h: int, w: int, seed: int, noise: float = 12.0) -> np.ndarray:
    """Smooth waves, an edge and a little noise: uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.02, 0.2, 6)
    img = np.stack([
        128 + 90 * np.sin(f[0] * xx + f[1] * yy),
        128 + 80 * np.cos(f[2] * yy + 1.0) * np.sin(f[3] * xx),
        128 + 70 * np.sin(f[4] * (xx + yy) + f[5] * xx * 0.1),
    ], -1)
    img[: h // 2, : w // 3] += 40  # a hard edge
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_jpeg(rgb: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], list(params))
    assert ok
    return buf.tobytes()


def decoded(data: bytes) -> np.ndarray:
    """cv2's RGB pixels of a JPEG."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1])


def pil_jpeg(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "JPEG", **kw)
    return b.getvalue()


def fixtures() -> dict:
    """{file name: bytes}."""
    q, sf = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out = {}
    for name, code in (("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                       ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                       ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                       ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                       ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)):
        out[f"baseline_{name}.jpg"] = cv2_jpeg(
            synthetic(61, 83, len(out)), q, 90, sf, code)
    gray = synthetic(45, 70, 10)[..., 1]
    ok, buf = cv2.imencode(".jpg", gray, [q, 88])
    out["gray.jpg"] = buf.tobytes()
    prog = cv2.IMWRITE_JPEG_PROGRESSIVE
    out["progressive_420.jpg"] = cv2_jpeg(
        synthetic(70, 90, 11), q, 85, prog, 1, sf,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    out["progressive_444.jpg"] = cv2_jpeg(
        synthetic(53, 67, 12), q, 92, prog, 1, sf,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    out["restart_interval.jpg"] = cv2_jpeg(
        synthetic(64, 96, 13), q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out["optimized_huffman.jpg"] = cv2_jpeg(
        synthetic(64, 96, 14), q, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    out["size_1x1.jpg"] = cv2_jpeg(synthetic(1, 1, 15), q, 90)
    out["size_17x31.jpg"] = cv2_jpeg(synthetic(17, 31, 16), q, 90)
    out["size_513x769.jpg"] = cv2_jpeg(synthetic(513, 769, 17, 3.0), q, 60)
    for o in range(2, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        out[f"exif_orientation_{o}.jpg"] = pil_jpeg(
            Image.fromarray(synthetic(40, 64, 20 + o)), quality=90,
            exif=exif.tobytes())
    rng = np.random.default_rng(30)
    cmyk = Image.fromarray(np.concatenate(
        [synthetic(36, 52, 31), rng.integers(0, 256, (36, 52, 1),
                                             dtype=np.uint8)], -1), "CMYK")
    out["adobe_cmyk.jpg"] = pil_jpeg(cmyk, quality=90)
    ycck = bytearray(out["adobe_cmyk.jpg"])
    i = ycck.find(b"Adobe")
    ycck[i + 11] = 2  # the Adobe transform byte: YCCK
    out["adobe_ycck.jpg"] = bytes(ycck)
    out["photo_768x512.jpg"] = cv2_jpeg(synthetic(512, 768, 40, 4.0), q, 80)
    photo = decoded(out["photo_768x512.jpg"])
    out["encoded_photo_q95.jpg"] = cv2_jpeg(photo)
    out["encoded_reconstruction_q95.jpg"] = cv2_jpeg(
        decoded(out["encoded_photo_q95.jpg"]))
    base = out["baseline_420.jpg"]
    out["refused_sof9.jpg"] = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    out["refused_sof3.jpg"] = base.replace(b"\xff\xc0", b"\xff\xc3", 1)
    sof = base.index(b"\xff\xc0")
    out["refused_12bit.jpg"] = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    out["truncated_baseline.jpg"] = base[:len(base) * 2 // 3]
    prog = out["progressive_420.jpg"]
    last = prog.rindex(b"\xff\xda")  # the last scan: luma's last AC bit
    out["truncated_progressive.jpg"] = prog[:(last + len(prog)) // 2]
    rst = out["restart_interval.jpg"]
    out["truncated_restart.jpg"] = rst[:rst.index(b"\xff\xd4")]
    out["truncated_no_eoi.jpg"] = base[:-2]
    out.update(smoothing_fixtures(out["progressive_420.jpg"],
                                  out["progressive_444.jpg"]))
    out.update(arith_fixtures())
    photo = huffman_coefficients(out["photo_768x512.jpg"])
    for name, kw in ARITH_PHOTO.items():
        out[name] = arith_jpeg(photo, **kw)
    # the photo progressive: its refinements cut out, and cut inside its
    # luma refinement (scan 5), both smoothed by libjpeg
    prog = cv2_jpeg(synthetic(512, 768, 40, 4.0), q, 80,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    sos = [p for p in scans(prog)[1] if p[:2] == b"\xff\xda"]
    out["smooth_768x512.jpg"] = without_scans(
        prog, {i for i, p in enumerate(sos) if scan_params(p)[3]})
    out["truncated_smooth_768x512.jpg"] = cut_in_scan(prog, 5)
    return out


def smoothing_fixtures(p420: bytes, p444: bytes) -> dict:
    """Progressive files whose scans leave low coefficients unrefined
    (libjpeg smooths their blocks): scans cut out of the scan list, and
    the files cut inside each scan."""
    out = {}
    for tag, data in (("420", p420), ("444", p444)):
        sos = [p for p in scans(data)[1] if p[:2] == b"\xff\xda"]
        last = [i for i, p in enumerate(sos)  # each component's last bit
                if scan_params(p)[3] == 1 and scan_params(p)[1] > 0]
        for i in last:
            out[f"smooth_{tag}_no_scan{i}.jpg"] = without_scans(data, {i})
        refines = {i for i, p in enumerate(sos) if scan_params(p)[3]}
        out[f"smooth_{tag}_no_refinements.jpg"] = without_scans(data,
                                                                refines)
        first_ac = [i for i, p in enumerate(sos)
                    if scan_params(p)[1] > 0 and scan_params(p)[3] == 0]
        out[f"smooth_{tag}_no_ac_scan{first_ac[-1]}.jpg"] = without_scans(
            data, {first_ac[-1]})
        for k in range(len(sos)):
            out[f"truncated_{tag}_scan{k}.jpg"] = cut_in_scan(data, k)
    return out


# the arithmetic files: name -> (the twin's sampling, arith_jpeg's options)
ARITH = {
    "arith_seq_420.jpg": ("420", {}),
    "arith_seq_444.jpg": ("444", {}),
    "arith_seq_gray.jpg": ("gray", {}),
    "arith_restart_420.jpg": ("420", {"restart": 3}),
    "arith_dac_420.jpg": ("420", {"dac": {(0, 0): 0x52, (0, 1): 0x31,
                                          (1, 0): 12, (1, 1): 2}}),
    "arith_prog_420.jpg": ("420", {"script": SCRIPT3}),
    "arith_prog_gray.jpg": ("gray", {"script": SCRIPT1}),
    "arith_prog_restart_444.jpg": ("444", {"script": SCRIPT3, "restart": 2}),
}
# the 768x512 photo's coefficients (photo_768x512.jpg, cv2's baseline
# 4:2:0) arithmetic-coded, for the card's decode timing
ARITH_PHOTO = {"arith_seq_768x512.jpg": {},
               "arith_prog_768x512.jpg": {"script": SCRIPT3}}
# arithmetic file -> its Huffman twin (the same coefficients and tables)
TWINS = {**{name: f"arith_twin_{tag}.jpg" for name, (tag, _) in
            ARITH.items()},
         **{name: "photo_768x512.jpg" for name in ARITH_PHOTO}}


def arith_fixtures() -> dict:
    """Arithmetic-coded files and their Huffman twins (module doc)."""
    out, srcs = {}, {}
    for tag, sub in (("420", 2), ("444", 0), ("gray", None)):
        img = synthetic(45, 61, 50 + len(srcs))
        im = Image.fromarray(img[..., 1] if sub is None else img)
        twin = pil_jpeg(im, quality=85, **({} if sub is None else
                                           {"subsampling": sub}))
        out[f"arith_twin_{tag}.jpg"] = twin
        srcs[tag] = huffman_coefficients(twin)
    for name, (tag, kw) in ARITH.items():
        out[name] = arith_jpeg(srcs[tag], **kw)
    prog = out["arith_prog_420.jpg"]
    sos = [p for p in scans(prog)[1] if p[:2] == b"\xff\xda"]
    refines = {i for i, p in enumerate(sos) if scan_params(p)[3]}
    out["smooth_arith_420_no_refinements.jpg"] = without_scans(prog, refines)
    out["truncated_arith_prog_420.jpg"] = cut_in_scan(prog, 5)
    rst = out["arith_restart_420.jpg"]
    out["truncated_arith_restart_420.jpg"] = rst[:len(rst) * 3 // 5]
    return out


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def oracle_digests(path: str) -> dict:
    """The digests of what cv2 (file path) and PIL (body path) decode."""
    with open(path, "rb") as f:
        data = f.read()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return {"file": sha(bgr[..., ::-1]), "file_shape": list(bgr.shape),
            "body": sha(rgb), "body_shape": list(rgb.shape)}


def truncated_digests(path: str) -> dict:
    """cv2's digests of a truncated file, PIL's refusal of it."""
    with open(path, "rb") as f:
        data = f.read()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except OSError as e:
        pil = str(e)
    else:
        raise AssertionError(f"PIL reads {path}")
    return {"file": sha(bgr[..., ::-1]), "file_shape": list(bgr.shape),
            "body_raises": "truncated data", "pil": pil}


def twin_check(files: dict) -> None:
    """cv2.imread of each arithmetic file equals cv2.imread of its Huffman
    twin, byte for byte: the QM coder and the scans are right."""
    for name, twin in TWINS.items():
        a, b = (cv2.imread(os.path.join(HERE, n), cv2.IMREAD_COLOR)
                for n in (name, twin))
        assert a is not None and b is not None and a.shape == b.shape \
            and a.tobytes() == b.tobytes(), f"{name} != its twin {twin}"
        assert files[name] != files[twin]


def main() -> None:
    digests = {}
    files = fixtures()
    for name, data in sorted(files.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    twin_check(files)
    for name in sorted(files):
        path = os.path.join(HERE, name)
        digests[name] = ({"raises": REFUSED[name]} if name in REFUSED
                         else truncated_digests(path)
                         if name in TRUNCATED or name.startswith("truncated_")
                         else oracle_digests(path))
        data = files[name]
        if name.startswith("encoded_"):
            digests[name]["bytes"] = hashlib.sha256(data).hexdigest()
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
