"""PNG reading and writing on the host, as the JAX package's readers give
it: ``cv2.imread`` for files, PIL's ``convert("RGB")`` for request bodies
(no JAX counterpart: the JAX package calls cv2 and PIL, which the machines
the port runs on do not have).

The chunks are parsed and the image data inflated here, with Python's
``zlib``; the pixels are rebuilt by ``runtime/csrc/png.cpp`` (plain C ABI,
built with ``g++`` at first use into ``build/crdr_tpu_torch/`` and called
through ctypes, which releases the GIL, so the data loader's threads decode
in parallel).  ``png_pixels_plain`` is the same reconstruction in numpy: the
C++ decoder's plain twin, which the tests hold it to.  No reader falls back
to it.

Every colour type at every bit depth it allows, the five row filters and
Adam7 interlacing; alpha and tRNS dropped, gray and palettes expanded.
Two callers, two behaviours:

* ``decode_png(data, name, file_path=True)`` (``cv2.imread``: the datasets
  and the CLIs, through ``img_utils.read_image``): the EXIF orientation of
  the first valid ``eXIf`` chunk applied (before or after the image data;
  libpng ignores an ``eXIf`` that does not start with a TIFF byte order and
  EXIF carried in text chunks); 16 bits by their high byte; an ancillary
  chunk whose CRC does not match is skipped and an unknown critical chunk
  raises.  An APNG gives its default image (the IDAT image, also when it is
  not a frame of the animation: what ``cv2.imread`` gives a file, where
  ``cv2.imdecode`` of the same bytes gives the first frame).
* ``file_path=False`` (PIL, the HTTP server's request bodies): no
  orientation; 16-bit gray clipped to 255 (PIL's ``I;16`` -> ``RGB``); an
  ancillary chunk with a bad CRC before the image data raises, an unknown
  critical chunk is skipped; an APNG gives its default image.

What raises a ``ValueError`` naming the source and the reason, on both
paths: a CRC mismatch in a critical chunk but IEND (PIL reads a body whose
IDAT CRC is wrong), a missing IHDR, more than ``MAX_PIXELS`` pixels, a palette image without PLTE (PIL
reads one with a default palette), an invalid IHDR, image data split by
another chunk, corrupt or too little image data, an unknown row filter; a
file without IEND (PIL reads such a body).  Image data past what the image
needs is ignored, as in both readers.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import NamedTuple, Optional

import numpy as np

from .device import build_library, package_path
from .jpeg import orient

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

_SRC = package_path("runtime", "csrc", "png.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: x start, y start, x step, y step
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngImage(NamedTuple):
    """A PNG's inflated image data and what its pixels need."""
    data: bytes
    width: int
    height: int
    depth: int
    color: int
    interlace: int
    palette: bytes       # PLTE (RGB triples) of a palette image, else b""
    orientation: int     # EXIF orientation, 1 unless a file's eXIf says


def build() -> str:
    """Compile the decoder (no-op when the built library is up to date)."""
    return build_library(
        "crdr_png", [_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC])


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i = ctypes.c_int
                lib.crdr_png_decode.restype = i
                lib.crdr_png_decode.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, i, i, i, i, i,
                    ctypes.c_char_p, i, i, ctypes.c_void_p, ctypes.c_char_p,
                    i]
                _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------

def exif_orientation(tiff: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 of a TIFF-structured EXIF
    block, 1 when absent or out of 1-8 (``jpeg.cpp``'s ``parse_exif``)."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack_from(e + "H", tiff, 2)[0] != 42:
        return 1
    ifd = struct.unpack_from(e + "I", tiff, 4)[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack_from(e + "H", tiff, ifd)[0]):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 1
        tag, kind = struct.unpack_from(e + "HH", tiff, at)
        if tag == 0x0112:
            v = (struct.unpack_from(e + "H", tiff, at + 8)[0] if kind == 3
                 else struct.unpack_from(e + "I", tiff, at + 8)[0]
                 if kind == 4 else 0)
            return v if 1 <= v <= 8 else 1
    return 1


def _chunks(data: bytes, name: str, file_path: bool):
    """(kind, body) of each chunk up to IEND, with the CRC rules of the
    module doc."""
    pos, seen_idat = len(PNG_SIGNATURE), False
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        pos += 12 + length
        critical = not kind[0] & 0x20
        seen_idat |= kind == b"IDAT"
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            if (critical and kind != b"IEND") \
                    or not (file_path or seen_idat):
                raise ValueError(f"{name}: CRC mismatch in PNG chunk "
                                 f"{kind!r}")
            if kind == b"IEND":
                return
            continue  # libpng warns and skips the chunk
        yield kind, body
        if kind == b"IEND":
            return
    if file_path:  # PIL reads a body without IEND
        raise ValueError(f"{name}: PNG without IEND")


def parse_png(data: bytes, name: str = "PNG data",
              file_path: bool = True) -> PngImage:
    """The chunks of a PNG -> its inflated image data and header
    (module doc: what each path reads and what raises)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, orientation, exif_seen = None, b"", 1, False
    idat, run = [], None  # run: the last chunk's kind
    for kind, body in _chunks(data, name, file_path):
        if header is None:
            if kind != b"IHDR" or len(body) != 13:
                raise ValueError(f"{name}: PNG without IHDR")
            header = struct.unpack(">IIBBBBB", body)
            continue
        if kind == b"IDAT":
            if idat and run != b"IDAT":
                raise ValueError(f"{name}: PNG image data split by another "
                                 "chunk")
            idat.append(body)
        elif kind == b"PLTE":  # read for a palette image only, as libpng
            if header[3] == 3 and (len(body) % 3 or len(body) > 768):
                raise ValueError(f"{name}: invalid PLTE of {len(body)} "
                                 "bytes")
            palette = body
        elif kind == b"eXIf" and file_path and not exif_seen \
                and body[:2] in (b"II", b"MM"):
            exif_seen, orientation = True, exif_orientation(body)
        elif not kind[0] & 0x20 and kind != b"IEND" and file_path:
            raise ValueError(f"{name}: unknown critical PNG chunk {kind!r}")
        run = kind
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, color, comp, filt, interlace = header
    if w == 0 or h == 0 or w * h > MAX_PIXELS or color not in _DEPTHS \
            or depth not in _DEPTHS[color] or comp or filt or interlace > 1:
        raise ValueError(f"{name}: invalid PNG header ({w}x{h}, bit depth "
                         f"{depth}, color type {color}, compression {comp}, "
                         f"filter {filt}, interlace {interlace})")
    if color == 3 and not palette:
        raise ValueError(f"{name}: palette PNG without PLTE")
    if not idat:
        raise ValueError(f"{name}: PNG without image data")
    return PngImage(_inflate(b"".join(idat), image_bytes(
        w, h, depth, color, interlace), name), w, h, depth, color,
        interlace, palette if color == 3 else b"", orientation)


def image_bytes(w: int, h: int, depth: int, color: int,
                interlace: int) -> int:
    """The bytes of filtered image data a PNG's header asks for."""
    bits = _CHANNELS[color] * depth
    total = 0
    for pw, ph, *_ in _passes(w, h, interlace):
        total += ph * ((pw * bits + 7) // 8 + 1)
    return total


def _passes(w: int, h: int, interlace: int):
    """(width, height, x0, y0, dx, dy) of each non-empty pass."""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            yield pw, ph, x0, y0, dx, dy


def _inflate(z: bytes, need: int, name: str) -> bytes:
    d = zlib.decompressobj()
    try:
        out = d.decompress(z, need)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if len(out) < need:
        raise ValueError(f"{name}: truncated image data ({len(out)} of "
                         f"{need} bytes)")
    return out


# ---------------------------------------------------------------------------
# pixels
# ---------------------------------------------------------------------------

def png_pixels(img: PngImage, gray16_clip: bool, name: str = "PNG data"
               ) -> np.ndarray:
    """The image data of ``img`` -> uint8 [H, W, 3] RGB, in C++
    (``png.cpp``), before any orientation."""
    lib = _get_lib()
    out = np.empty((img.height, img.width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.crdr_png_decode(img.data, len(img.data), img.width, img.height,
                           img.depth, img.color, img.interlace, img.palette,
                           len(img.palette) // 3, int(gray16_clip),
                           out.ctypes.data, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, name: str
              ) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of
    ``raw`` (h rows of a filter byte + ``stride`` bytes)."""
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) \
                .astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average / Paeth: serial along the row
            cur_b, up, filt = bytearray(stride), prev.tolist(), line.tolist()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur_b[i] = (filt[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"{name}: unknown PNG row filter {kind}")
        out[r] = cur
        prev = out[r]
    return out


def _samples(rows: np.ndarray, pw: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, pw, ch] (int64)."""
    h = rows.shape[0]
    if depth == 16:
        v = rows[:, :pw * ch * 2].reshape(h, pw * ch, 2).astype(np.int64)
        return (v[..., 0] << 8 | v[..., 1]).reshape(h, pw, ch)
    if depth == 8:
        return rows[:, :pw * ch].reshape(h, pw, ch).astype(np.int64)
    bits = np.unpackbits(rows, axis=1)[:, :pw * depth].reshape(h, pw, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    return (bits.astype(np.int64) * weights).sum(-1)[..., None]


def png_pixels_plain(img: PngImage, gray16_clip: bool,
                     name: str = "PNG data") -> np.ndarray:
    """``png_pixels`` in numpy: the C++ decoder's plain twin."""
    ch, depth = _CHANNELS[img.color], img.depth
    bits = ch * depth
    out = np.zeros((img.height, img.width, 3), np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(img.palette) // 3] = np.frombuffer(
        img.palette, np.uint8).reshape(-1, 3)
    pos = 0
    for pw, ph, x0, y0, dx, dy in _passes(img.width, img.height,
                                          img.interlace):
        stride = (pw * bits + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(img.data):
            raise ValueError(f"{name}: truncated image data")
        rows = _unfilter(img.data[pos:pos + n], ph, stride,
                         max(1, bits // 8), name)
        pos += n
        s = _samples(rows, pw, ch, depth)
        if img.color == 3:
            rgb = pal[s[..., 0]]
        else:
            if img.color in (0, 4):
                s = s[..., :1]
            if depth == 16:
                s = np.minimum(s, 255) if gray16_clip and img.color == 0 \
                    else s >> 8
            elif depth < 8:
                s = s * (255 // ((1 << depth) - 1))
            rgb = np.broadcast_to(s[..., :3], (ph, pw, 3)).astype(np.uint8)
        out[y0::dy, x0::dx] = rgb
    return out


def decode_png(data: bytes, name: str = "PNG data",
               file_path: bool = True) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB, as ``cv2.imread`` gives a file
    (``file_path``) or PIL's ``convert("RGB")`` a body (module doc).
    Raises ``ValueError`` starting with ``name``."""
    img = parse_png(data, name, file_path)
    return orient(png_pixels(img, not file_path, name), img.orientation)


def decode_png_plain(data: bytes, name: str = "PNG data",
                     file_path: bool = True) -> np.ndarray:
    """``decode_png`` through the numpy twin."""
    img = parse_png(data, name, file_path)
    return orient(png_pixels_plain(img, not file_path, name),
                  img.orientation)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes of an 8-bit RGB PNG (row filter 0)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", zlib.crc32(kind + body))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """``decode_png`` of a file; errors name the path."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W, 3] RGB -> an 8-bit RGB PNG file (``encode_png``)."""
    data = encode_png(img)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
