"""JPEG 2000 reading on the host, as ``cv2.imread`` reads a file and as
PIL's ``convert("RGB")`` reads a request body (no JAX counterpart: the JAX
package's files go through cv2 and its server through PIL, both of which
decode JPEG 2000 with OpenJPEG 2.5, and the machines the port runs on have
neither).

The codestream (from its SOC marker) is decoded by
``runtime/csrc/jpeg2000.cpp`` (plain C ABI, standard headers only, built
with ``g++ -ffp-contract=off`` at first use into ``build/crdr_tpu_torch/``
and called through ctypes, which releases the GIL) to the integers
OpenJPEG gives each component.  The JP2 boxes are parsed here: the
signature, ``ftyp``, ``jp2h`` with ``ihdr``, ``colr`` (an enumerated space
or an ICC profile: only the first counts), ``pclr``, ``cmap`` and
``cdef``, then ``jp2c``.  A bare codestream (``FF 4F FF 51``) is read too.

A file, as cv2's OpenJPEG decoder reads it (``IMREAD_COLOR``): one to four
components, none signed, the widest of at least 8 bits; OpenJPEG applies
the palette (``pclr`` with ``cmap``) and the channel definitions
(``cdef``: a colour channel associated with another place is swapped
there); every component then full size at the image's origin (cv2 refuses
subsampled components and an image offset as "tiles"); each sample
shifted down by the widest component's bits past 8, keeping the low byte.
The colour space comes from ``colr``'s enumerated space (sRGB 16, gray
17, sYCC 18, eYCC 24, CMYK 12); any other, an ICC profile or no ``colr``
box (a bare codestream too) leaves it unspecified, which cv2 takes as
sRGB.  sRGB: components 0-2 as RGB, refused with fewer than three; gray:
component 0; sYCC: components 0-2 through ``cvtColor(COLOR_YUV2BGR)``;
eYCC and CMYK refused.

A body, as PIL's ``Jpeg2KImagePlugin`` reads it: the mode from the
codestream's component count (``L``, or ``I;16`` past 8 bits; ``LA``,
``RGB``, ``RGBA``) or from ``ihdr``, with ``CMYK`` for four components in
``colr`` space 12 and ``P`` / ``PA`` for an ``L`` / ``LA`` image with a
``pclr`` of at most 8 bits (PIL's own palette, each colour added once).
OpenJPEG decodes tile by tile there, so the palette and the channel
definitions are not applied; an unspecified space follows the component
count (gray for one or two), and the mode, the space and the component
count pick PIL's unpacker.  Each sample is offset by half its range when
signed and shifted to 8 bits (16 for ``I;16``), rounding a shift down,
keeping the low byte; sYCC through PIL's YCbCr tables
(``ycbcr_to_rgb_pil``); then ``convert("RGB")``: ``I;16`` clips to 255,
``CMYK`` through ``cmyk2rgb``.  Subsampled components are refused (PIL
reads a file whose first component alone is subsampled).

Both: an ``ihdr`` of another size than the codestream's image is refused
(OpenJPEG), and so is what OpenJPEG's strict mode refuses (data that ends
before a tile-part or a code-block segment, or right after the last
tile-part); a tile the codestream does not hold is black.  Two bytes
other than EOC after the last tile-part end a file (``opj_decode`` reads
on) and fail a body (PIL's tile by tile decode).

Each path raises a ``ValueError`` naming the source and the reason where
its oracle returns None or raises; more than ``MAX_PIXELS`` pixels raise
on both.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .device import build_library, package_path
from .png import MAX_PIXELS

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_MAGIC = b"\xff\x4f\xff\x51"

_SRC = package_path("runtime", "csrc", "jpeg2000.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# OpenJPEG's colour spaces, as set from colr's enumerated space (any other
# value, an ICC profile or no colr box: not specified)
UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


def is_jpeg2000(data: bytes) -> bool:
    """The JP2 signature box or a codestream's SOC and SIZ markers."""
    return data.startswith(JP2_SIGNATURE) or data.startswith(J2K_MAGIC)


def build() -> str:
    """Compile the decoder (no-op when the built library is up to date)."""
    return build_library(
        "crdr_jpeg2000", [_SRC],
        ["g++", "-O3", "-std=c++17", "-ffp-contract=off", "-fPIC",
         "-shared", _SRC])


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i, p, n = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
                c = ctypes.c_char_p
                lib.crdr_j2k_header.argtypes = [c, n, p, i, c, i]
                lib.crdr_j2k_decode.argtypes = [c, n, i, p, c, i]
                lib.crdr_j2k_header.restype = i
                lib.crdr_j2k_decode.restype = i
                _lib = lib
    return _lib


class Component(NamedTuple):
    prec: int
    sgnd: int
    dx: int
    dy: int


class Codestream(NamedTuple):
    x0: int
    y0: int
    x1: int
    y1: int
    comps: Tuple[Component, ...]

    def size(self, c: int) -> Tuple[int, int]:
        """(height, width) of component c."""
        k = self.comps[c]
        return (-(-self.y1 // k.dy) - -(-self.y0 // k.dy),
                -(-self.x1 // k.dx) - -(-self.x0 // k.dx))


def _call(fn, name: str, *args) -> None:
    err = ctypes.create_string_buffer(256)
    if fn(*args, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")


def codestream_header(cs: bytes, name: str) -> Codestream:
    """The image and components a codestream's main header declares."""
    info = np.zeros(5 + 4 * 16384, np.int32)
    _call(_get_lib().crdr_j2k_header, name, cs, len(cs), info.ctypes.data,
          len(info))
    x0, y0, x1, y1, nc = (int(v) for v in info[:5])
    comps = tuple(Component(*(int(v) for v in info[5 + 4 * c:9 + 4 * c]))
                  for c in range(nc))
    return Codestream(x0, y0, x1, y1, comps)


def decode_components(cs: bytes, head: Codestream, name: str,
                      eoc: bool) -> List[np.ndarray]:
    """Each component's samples as OpenJPEG gives them, int32 [h, w];
    ``eoc``: the codestream must end with EOC, as OpenJPEG's tile by tile
    decode for PIL requires (``opj_decode`` for cv2 reads on past two other
    bytes)."""
    sizes = [head.size(c) for c in range(len(head.comps))]
    if sum(h * w for h, w in sizes) > MAX_PIXELS:
        raise ValueError(f"{name}: JPEG 2000 of more than {MAX_PIXELS} "
                         "samples")
    out = np.empty(sum(h * w for h, w in sizes), np.int32)
    _call(_get_lib().crdr_j2k_decode, name, cs, len(cs), int(eoc),
          out.ctypes.data)
    planes, at = [], 0
    for h, w in sizes:
        planes.append(out[at:at + h * w].reshape(h, w))
        at += h * w
    return planes


# ---------------------------------------------------------------------------
# JP2 boxes
# ---------------------------------------------------------------------------

class Jp2(NamedTuple):
    codestream: bytes
    size: Tuple[int, int]             # ihdr's height and width
    space: int                        # OpenJPEG's colour space
    pclr: Optional[Tuple[List[int], List[int], np.ndarray]]  # sizes,
    # signs, entries [entries, channels]
    cmap: Optional[List[Tuple[int, int, int]]]  # (cmp, mtyp, pcol)
    cdef: Optional[List[Tuple[int, int, int]]]  # (cn, typ, asoc)


def _boxes(data: bytes, pos: int, end: int, name: str, top: bool):
    """(type, payload start, payload end) of each box in data[pos:end]
    (OpenJPEG's box headers: XLBox for a length of 1, a length of 0 to the
    end)."""
    while pos < end:
        if pos + 8 > end:
            raise ValueError(f"{name}: truncated JP2 box header")
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError(f"{name}: truncated JP2 box header")
            length = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
            if length >> 32:
                raise ValueError(f"{name}: JP2 box of 2^32 bytes or more")
        elif length == 0:
            if not top or kind != b"jp2c":
                raise ValueError(f"{name}: JP2 box {kind!r} of undefined "
                                 "size")
            length = end - pos
        if length < head:
            raise ValueError(f"{name}: JP2 box {kind!r} of {length} bytes")
        if pos + length > end and kind != b"jp2c":
            raise ValueError(f"{name}: truncated JP2 box {kind!r}")
        yield kind, pos + head, min(pos + length, end)
        pos += length


def _pclr(p: bytes, name: str):
    if len(p) < 3:
        raise ValueError(f"{name}: truncated JP2 pclr box")
    ne, npc = struct.unpack_from(">HB", p)
    if ne == 0 or ne > 1024 or npc == 0:
        raise ValueError(f"{name}: JP2 pclr box of {ne} entries of {npc} "
                         "channels")
    if len(p) < 3 + npc:
        raise ValueError(f"{name}: truncated JP2 pclr box")
    sizes = [(b & 0x7F) + 1 for b in p[3:3 + npc]]
    signs = [b >> 7 for b in p[3:3 + npc]]
    nbytes = [min(4, (s + 7) >> 3) for s in sizes]
    pos = 3 + npc
    entries = np.zeros((ne, npc), np.int64)
    for j in range(ne):
        for i in range(npc):
            if pos + nbytes[i] > len(p):
                raise ValueError(f"{name}: truncated JP2 pclr box")
            entries[j, i] = int.from_bytes(p[pos:pos + nbytes[i]], "big")
            pos += nbytes[i]
    return sizes, signs, entries


def parse_jp2(data: bytes, name: str) -> Jp2:
    """A JP2 file's boxes as OpenJPEG reads them."""
    state = 0  # 1 signature, 2 ftyp, 3 jp2h read
    size = pclr = cmap = cdef = None
    space = None
    for kind, a, b in _boxes(data, 0, len(data), name, True):
        p = data[a:b]
        if kind == b"jP  ":
            if state != 0 or p != b"\r\n\x87\n":
                raise ValueError(f"{name}: bad JP2 signature box")
            state = 1
        elif kind == b"ftyp":
            if state != 1 or len(p) < 8 or (len(p) - 8) % 4:
                raise ValueError(f"{name}: bad JP2 ftyp box")
            state = 2
        elif kind == b"jp2h":
            if state < 2:
                raise ValueError(f"{name}: JP2 header box before the file "
                                 "type box")
            for sub, sa, sb in _boxes(data, a, b, name, False):
                q = data[sa:sb]
                if sub == b"ihdr" and size is None:
                    if len(q) != 14:
                        raise ValueError(f"{name}: bad JP2 ihdr box")
                    h, w, nc = struct.unpack_from(">IIH", q)
                    if h < 1 or w < 1 or nc < 1:
                        raise ValueError(f"{name}: JP2 ihdr of {w}x{h} with "
                                         f"{nc} components")
                    size = (h, w)
                elif sub == b"colr" and space is None:
                    if len(q) < 3:
                        raise ValueError(f"{name}: bad JP2 colr box")
                    if q[0] == 1:
                        if len(q) < 7:
                            raise ValueError(f"{name}: bad JP2 colr box")
                        space = _ENUMCS.get(
                            struct.unpack_from(">I", q, 3)[0], UNSPECIFIED)
                    elif q[0] == 2:
                        space = UNSPECIFIED  # an ICC profile
                elif sub == b"pclr" and pclr is None:
                    pclr = _pclr(q, name)
                elif sub == b"cmap" and cmap is None:
                    if pclr is None:
                        raise ValueError(f"{name}: JP2 cmap box before its "
                                         "pclr box")
                    n = len(pclr[0])
                    if len(q) < 4 * n:
                        raise ValueError(f"{name}: truncated JP2 cmap box")
                    cmap = [struct.unpack_from(">HBB", q, 4 * i)
                            for i in range(n)]
                elif sub == b"cdef" and cdef is None:
                    if len(q) < 2:
                        raise ValueError(f"{name}: truncated JP2 cdef box")
                    n = struct.unpack_from(">H", q)[0]
                    if n == 0 or len(q) < 2 + 6 * n:
                        raise ValueError(f"{name}: bad JP2 cdef box")
                    cdef = [struct.unpack_from(">HHH", q, 2 + 6 * i)
                            for i in range(n)]
            if size is None:
                raise ValueError(f"{name}: JP2 header box without ihdr")
            state = 3
        elif kind == b"jp2c":
            if state != 3:
                raise ValueError(f"{name}: JP2 codestream box before the "
                                 "header box")
            return Jp2(data[a:], size, UNSPECIFIED if space is None else space,
                       pclr, cmap, cdef)
        elif state < 2:
            raise ValueError(f"{name}: JP2 file that does not start with "
                             "its signature and file type boxes")
    raise ValueError(f"{name}: JP2 file without a codestream box")


def _check_color(jp2: Jp2, ncomps: int, name: str) -> None:
    """OpenJPEG's ``opj_jp2_check_color``."""
    nch = len(jp2.pclr[0]) if jp2.pclr and jp2.cmap else ncomps
    if jp2.cdef:
        for cn, _, asoc in jp2.cdef:
            if cn >= nch or (asoc not in (0, 65535) and asoc - 1 >= nch):
                raise ValueError(f"{name}: JP2 cdef of channel {cn} "
                                 f"(associated {asoc}) past {nch} channels")
        if not set(range(nch)) <= {cn for cn, _, _ in jp2.cdef}:
            raise ValueError(f"{name}: incomplete JP2 channel definitions")
    if jp2.pclr and jp2.cmap:
        used = [False] * nch
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            if cmp >= ncomps or mtyp > 1 or pcol >= nch or (
                    mtyp == 1 and (used[pcol] or pcol != i)) or (
                    mtyp == 0 and pcol != 0):
                raise ValueError(f"{name}: JP2 cmap entry {i} ({cmp}, "
                                 f"{mtyp}, {pcol}) is not read")
            used[pcol] = used[pcol] or mtyp == 1
        if any(not u and m[1] != 0 for u, m in zip(used, jp2.cmap)):
            raise ValueError(f"{name}: JP2 palette channel without a "
                             "mapping")


def _apply_color(jp2: Jp2, comps: list, name: str) -> list:
    """OpenJPEG's palette and channel definitions: [(prec, sgnd, plane)]."""
    _check_color(jp2, len(comps), name)
    if jp2.pclr and jp2.cmap:
        sizes, signs, entries = jp2.pclr
        out = []
        for i, (cmp, mtyp, pcol) in enumerate(jp2.cmap):
            src = comps[cmp][2]
            if mtyp == 0:
                plane = src
            else:
                plane = entries[np.clip(src, 0, len(entries) - 1), pcol]
            out.append((sizes[i], signs[i], plane))
        comps = out
    if jp2.cdef:
        cdef = [list(d) for d in jp2.cdef]
        for i, (cn, typ, asoc) in enumerate(cdef):
            if cn >= len(comps) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(comps) or cn == acn or typ != 0:
                continue
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for d in cdef[i + 1:]:
                if d[0] == cn:
                    d[0] = acn
                elif d[0] == acn:
                    d[0] = cn
    return comps


# ---------------------------------------------------------------------------
# the two oracles
# ---------------------------------------------------------------------------

def _open(data: bytes, name: str):
    """(the JP2 boxes or None, the codestream, its header); OpenJPEG
    refuses an ``ihdr`` of another size than the codestream's image."""
    jp2 = parse_jp2(data, name) if data.startswith(JP2_SIGNATURE) else None
    cs = jp2.codestream if jp2 else data
    head = codestream_header(cs, name)
    h, w = head.y1 - head.y0, head.x1 - head.x0
    if jp2 and jp2.size != (h, w):
        raise ValueError(f"{name}: JP2 ihdr of {jp2.size[1]}x{jp2.size[0]} "
                         f"over a {w}x{h} codestream")
    if h * w > MAX_PIXELS:
        raise ValueError(f"{name}: JPEG 2000 of more than {MAX_PIXELS} "
                         "pixels")
    return jp2, cs, head


def _cv2_none(name: str, why: str):
    raise ValueError(f"{name}: {why} (cv2.imread returns None)")


def yuv_to_rgb_cv2(yuv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(COLOR_YUV2BGR)`` on uint8 (fixed point, 14 bits),
    returned as RGB."""
    y, u, v = (yuv[..., i].astype(np.int64) for i in range(3))
    u, v = u - 128, v - 128
    d = 1 << 13
    r = y + ((v * 18678 + d) >> 14)
    g = y + ((u * -6472 + v * -9519 + d) >> 14)
    b = y + ((u * 33292 + d) >> 14)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _pil_table(c: float) -> np.ndarray:
    """One of PIL's YCbCr tables: ``(i - 128) * c`` at 6 fractional bits,
    rounded as C's ``(int)(v + 0.5)``."""
    return np.trunc((np.arange(256) - 128) * c * 64 + 0.5).astype(np.int64)


_R_CR, _G_CB, _G_CR, _B_CB = (_pil_table(c) for c in (1.402, -0.34414,
                                                      -0.71414, 1.772))


def ycbcr_to_rgb_pil(ycc: np.ndarray) -> np.ndarray:
    """PIL's ``ImagingConvertYCbCr2RGB`` on uint8 [..., 3]: each channel Y
    plus its tables' sum shifted down 6 bits, clipped."""
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _decode_cv2(data: bytes, name: str) -> np.ndarray:
    jp2, cs, head = _open(data, name)
    n = len(head.comps)
    if not 1 <= n <= 4:
        _cv2_none(name, f"JPEG 2000 with {n} components")
    for c, k in enumerate(head.comps):
        if k.sgnd:
            _cv2_none(name, f"JPEG 2000 component {c}/{n} is signed")
    maxprec = max(k.prec for k in head.comps)
    if maxprec < 8:
        _cv2_none(name, f"JPEG 2000 of {maxprec}-bit components (cv2 reads "
                  "8 bits and more)")
    planes = decode_components(cs, head, name, eoc=False)
    comps = [(k.prec, k.sgnd, p) for k, p in zip(head.comps, planes)]
    space = UNSPECIFIED
    if jp2:
        comps = _apply_color(jp2, comps, name)
        space = jp2.space
    if space in (EYCC, CMYK):
        _cv2_none(name, "JPEG 2000 in the " + ("eYCC" if space == EYCC
                                               else "CMYK")
                  + " colour space")
    if space == SYCC and len(comps) < 3:
        _cv2_none(name, f"sYCC JPEG 2000 of {len(comps)} components")
    h, w = head.y1 - head.y0, head.x1 - head.x0
    if head.x0 or head.y0 or any(k.dx != 1 or k.dy != 1
                                 for k in head.comps) \
            or any(p.shape != (h, w) for _, _, p in comps):
        _cv2_none(name, "JPEG 2000 with subsampled components or an image "
                  "offset (cv2: tiles are not supported)")
    if space != GRAY and len(comps) < 3:
        _cv2_none(name, f"JPEG 2000 of {len(comps)} components in the sRGB "
                  "colour space (cv2 takes an unspecified one as sRGB)")
    shift = maxprec - 8
    pick = [0, 0, 0] if space == GRAY else [0, 1, 2]
    rgb = (np.stack([comps[c][2] >> shift for c in pick], -1) & 0xFF
           ).astype(np.uint8)  # cv2 keeps the low byte
    return yuv_to_rgb_cv2(rgb) if space == SYCC else rgb


def _pil_mode(data: bytes, head: Codestream, jp2: Optional[Jp2],
              name: str):
    """PIL's ``Jpeg2KImageFile._open``: (mode, palette or None)."""
    if jp2 is None:
        n = len(head.comps)
        if n == 1:
            return ("I;16" if head.comps[0].prec > 8 else "L"), None
        modes = {2: "LA", 3: "RGB", 4: "RGBA"}
        if n not in modes:
            raise ValueError(f"{name}: JPEG 2000 of {n} components (PIL: "
                             "unable to determine J2K image mode)")
        return modes[n], None
    # PIL's own reading of the first jp2h: each ihdr, colr and pclr as met
    mode = nc = palette = None
    a, b = next((a, b) for kind, a, b in _boxes(data, 0, len(data), name,
                                                True) if kind == b"jp2h")
    for kind, qa, qb in _boxes(data, a, b, name, False):
        q = data[qa:qb]
        if kind == b"ihdr":
            if len(q) < 11:
                raise ValueError(f"{name}: not enough data in the JP2 ihdr "
                                 "box (PIL)")
            _, _, nc, bpc = struct.unpack_from(">IIHB", q)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA",
                    3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and nc == 4:
            if len(q) < 7:
                raise ValueError(f"{name}: not enough data in the JP2 colr "
                                 "box (PIL)")
            if q[0] == 1 and struct.unpack_from(">I", q, 3)[0] == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack_from(">HB", q)
            if max(q[3:3 + npc]) <= 8:
                if len(q) < 3 + npc + ne * npc:
                    raise ValueError(f"{name}: not enough data in the JP2 "
                                     "pclr box (PIL)")
                colours = []  # PIL's ImagePalette.getcolor: each once
                for i in range(3 + npc, 3 + npc + ne * npc, npc):
                    if tuple(q[i:i + npc]) not in colours:
                        colours.append(tuple(q[i:i + npc]))
                if len(colours) > 256:
                    raise ValueError(f"{name}: JP2 palette of more than 256 "
                                     "colours (PIL)")
                palette = np.zeros((256, 3), np.uint8)
                palette[:len(colours)] = np.array(colours, np.uint8)[:, :3]
                mode = "P" if mode == "L" else "PA"
    if mode is None:
        raise ValueError(f"{name}: malformed JP2 header (PIL)")
    return mode, palette


def _pil_bytes(plane: np.ndarray, k: Component, bits: int) -> np.ndarray:
    """PIL's unpackers: the sample in its tile buffer (the low 1, 2 or 4
    bytes), offset when signed, shifted to ``bits``."""
    size = (k.prec + 7) >> 3
    mask = {1: 0xFF, 2: 0xFFFF}.get(size, 0xFFFFFFFF)
    shift = bits - k.prec
    offset = (1 << (k.prec - 1) if k.sgnd else 0) + (
        1 << (-shift - 1) if shift < 0 else 0)  # rounds a shift down
    v = (plane.astype(np.int64) & mask) + offset
    return (v << shift if shift >= 0 else v >> -shift) & ((1 << bits) - 1)


def _decode_pil(data: bytes, name: str) -> np.ndarray:
    jp2, cs, head = _open(data, name)
    mode, palette = _pil_mode(data, head, jp2, name)
    n = len(head.comps)
    space = jp2.space if jp2 else UNSPECIFIED
    if not 1 <= n <= 4:
        raise ValueError(f"{name}: JPEG 2000 of {n} components (PIL: broken "
                         "data stream)")
    if any(k.dx != 1 or k.dy != 1 for k in head.comps):
        raise ValueError(f"{name}: JPEG 2000 with subsampled components is "
                         "not read")
    if space == UNSPECIFIED:
        space = GRAY if n <= 2 else SRGB
    unpackers = {("L", GRAY, 1): "l", ("P", SRGB, 1): "l",
                 ("PA", SRGB, 2): "l", ("I;16", GRAY, 1): "i",
                 ("LA", GRAY, 2): "l", ("RGB", GRAY, 1): "l",
                 ("RGB", GRAY, 2): "l", ("RGBA", GRAY, 1): "l",
                 ("RGBA", GRAY, 2): "l", ("RGB", SRGB, 3): "rgb",
                 ("RGB", SRGB, 4): "rgb", ("RGBA", SRGB, 3): "rgb",
                 ("RGBA", SRGB, 4): "rgb", ("RGB", SYCC, 3): "ycc",
                 ("RGB", SYCC, 4): "ycc", ("RGBA", SYCC, 3): "ycc",
                 ("RGBA", SYCC, 4): "ycc", ("CMYK", CMYK, 4): "cmyk"}
    kind = unpackers.get((mode, space, n))
    if kind is None:
        raise ValueError(f"{name}: JPEG 2000 mode {mode} of {n} components "
                         "in its colour space (PIL: broken data stream)")
    planes = decode_components(cs, head, name, eoc=True)
    if kind == "i":
        v = np.minimum(_pil_bytes(planes[0], head.comps[0], 16), 255)
        return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
    if kind == "l":
        v = _pil_bytes(planes[0], head.comps[0], 8).astype(np.uint8)
        if mode in ("P", "PA"):
            return palette[v]
        return np.repeat(v[..., None], 3, axis=2)
    chans = np.stack([_pil_bytes(planes[c], head.comps[c], 8)
                      for c in range(4 if kind == "cmyk" else 3)], -1)
    if kind == "cmyk":
        nk = 255 - chans[..., 3:]
        t = chans[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    if kind == "ycc":
        return ycbcr_to_rgb_pil(chans)
    return chans.astype(np.uint8)


def decode_jpeg2000(data: bytes, name: str = "JPEG 2000 data",
                    file_path: bool = False) -> np.ndarray:
    """A JP2 file or a JPEG 2000 codestream -> uint8 [H, W, 3] RGB, as
    PIL's ``convert("RGB")`` reads a request body or, with ``file_path``,
    as ``cv2.imread`` reads a file (module doc).  Raises ``ValueError``
    starting with ``name``."""
    if not is_jpeg2000(data):
        raise ValueError(f"{name}: not a JPEG 2000 file")
    rgb = (_decode_cv2 if file_path else _decode_pil)(data, name)
    return np.ascontiguousarray(rgb)
