"""BMP reading and writing on the host, as the JAX package's readers give
it: ``cv2.imread`` for files, PIL's ``convert("RGB")`` for request bodies
(no JAX counterpart: the JAX package calls cv2 and PIL, which the machines
the port runs on do not have).

Read, on both paths: the 12-byte OS/2 core header and the 40- to 124-byte
Windows headers; 1-, 4- and 8-bit palettes (an index past the palette is
black), RLE8 and RLE4, 16-bit 555, 24-bit, 32-bit (the fourth byte
dropped), bottom-up and top-down rows.  Where the two readers differ, a
file follows cv2 and a body PIL:

* 16 bits: cv2 shifts each field up (``v << 3``), PIL scales it
  (``v * 255 // 31``, ``// 63`` for a 6-bit green);
* bitfields: cv2 reads 16-bit 565 / 555 masks after a 40-byte header only,
  ignores a 32-bit image's masks under a 56-byte header or where one of
  them is zero, and otherwise scales each field to 8 bits (times ``255 /
  its maximum`` in float32, truncated), and refuses 24-bit bitfields; PIL
  takes the mask sets of its own table (``BmpImagePlugin``), whatever the
  header;
* RLE: cv2 fills what a stream skips (end of line, delta, end of bitmap)
  with palette entry 0, moves an RLE4 delta right only (its rows are
  dropped) and needs every row's runs to fit; PIL pads with
  index 0 too, clips a run at the row's end, reads a delta's two bytes
  after two more, aligns absolute runs on the file's position and raises
  when the stream ends short of the image.

Anything else raises a ``ValueError`` that starts with the source's name:
other bit counts and compressions, more than ``MAX_PIXELS`` pixels,
truncated pixel data, a run past its
row (cv2), a top-down RLE file (cv2).

``encode_bmp`` writes what ``cv2.imwrite('.bmp')`` writes for an RGB
image, byte for byte: a 24-bit bottom-up BMP with a 40-byte header.
"""

from __future__ import annotations

import struct

import numpy as np

from .png import MAX_PIXELS

BMP_MAGIC = b"BM"

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# the bitfields PIL reads (BmpImagePlugin): 32-bit (r, g, b, a) mask sets,
# 24- and 16-bit (r, g, b) ones
_PIL_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
    (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)}
_MASKS565, _MASKS555 = (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)
_PIL_MASKS = {32: _PIL_MASKS32, 24: {(0xFF0000, 0xFF00, 0xFF)},
              16: {_MASKS565, _MASKS555}}


def _fail(name: str, why: str):
    raise ValueError(f"{name}: {why}")


def _bytes_of(masks, name: str):
    """Byte-aligned 8-bit (r, g, b) masks -> the byte index of each in a
    little-endian pixel; all-zero masks -> BGR's."""
    if not any(masks):
        return (2, 1, 0)
    out = []
    for m in masks:
        if m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
            _fail(name, f"32-bit BMP bitfields {[hex(v) for v in masks]} "
                  "are not byte-aligned 8-bit masks")
        out.append(m.bit_length() // 8 - 1)
    return tuple(out)


def _unpack_bits(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8 rows of 1- / 4-bit indexes -> [h, w] (MSB first)."""
    bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(
        rows.shape[0], w, bpp)
    return (bits * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(
        -1).astype(np.uint8)


def _rle_cv2(data: bytes, pos: int, w: int, h: int, rle4: bool,
             name: str) -> np.ndarray:
    """cv2's RLE decoder (grfmt_bmp.cpp): [h, w] indexes, bottom row
    first; what the stream skips is index 0."""
    idx = np.zeros((h, w), np.uint8)
    x = y = 0
    line_end_flag = 0

    def read(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            _fail(name, "truncated RLE data")
        pos += n
        return data[pos - n:pos]

    def skip(count: int) -> None:  # FillUniColor: at least one step
        nonlocal x, y
        while True:
            take = min(count, w - x)
            x += take
            count -= take
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if count <= 0:
                return

    while True:
        n, c = read(2)
        if n:  # encoded run
            if x + n > w:
                _fail(name, "RLE run past the end of its row")
            if rle4:
                idx[y, x:x + n] = np.resize(np.array([c >> 4, c & 15],
                                                     np.uint8), n)
            else:
                idx[y, x:x + n] = c
            x += n
            if not rle4:  # RLE8 fills through FillUniColor: a full row ends
                prev = y
                if x >= w:
                    x, y = 0, y + 1
                line_end_flag = y - prev
                if y >= h:
                    break
        elif c > 2:  # absolute run
            if x + c > w:
                _fail(name, "RLE run past the end of its row")
            if rle4:
                raw = np.frombuffer(read((((c + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                idx[y, x:x + c] = np.stack([raw >> 4, raw & 15],
                                           -1).reshape(-1)[:c]
            else:
                idx[y, x:x + c] = np.frombuffer(read((c + 1) & ~1),
                                                np.uint8)[:c]
            x += c
            line_end_flag = 0
        else:  # end of line (0), end of bitmap (1), delta (2)
            if rle4 or c or not line_end_flag or x > 0:
                if c == 2:  # cv2's RLE4 delta moves right only
                    dx, dy = read(2)
                    count = dx + (0 if rle4 else dy * w)
                else:
                    count = (w - x) + (0 if c == 0 else (h - y) * w)
                if y >= h:
                    break
                skip(count)
            line_end_flag = 0
            if y >= h:
                break
    return idx


def _rle_pil(data: bytes, pos: int, w: int, h: int, rle4: bool,
             name: str) -> np.ndarray:
    """PIL's ``BmpRleDecoder``: the flat indexes in the file's row
    order."""
    out = bytearray()
    x = 0
    while len(out) < w * h:
        if pos + 2 > len(data):
            break
        n, c = data[pos], data[pos + 1]
        pos += 2
        if n:
            n = min(n, max(0, w - x))
            out += (bytes([c >> 4, c & 15]) * n)[:n] if rle4 \
                else bytes([c]) * n
            x += n
        elif c == 0:
            out += bytes(-len(out) % w)
            x = 0
        elif c == 1:
            break
        elif c == 2:  # PIL reads two bytes, then the delta from two more
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                _fail(name, "truncated RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            count = c // 2 if rle4 else c
            got = data[pos:pos + count]
            pos += len(got)
            if rle4:
                out += bytes(v for b in got for v in (b >> 4, b & 15))
            else:
                out += got
            if len(got) < count:
                break
            x += c
            pos += pos % 2
    if len(out) < w * h:
        _fail(name, "not enough image data")
    return np.frombuffer(bytes(out[:w * h]), np.uint8).reshape(h, w)


def decode_bmp(data: bytes, name: str = "BMP data",
               file_path: bool = True) -> np.ndarray:
    """BMP bytes -> uint8 [H, W, 3] RGB, as ``cv2.imread`` gives a file
    (``file_path``) or PIL's ``convert("RGB")`` a body (module doc).
    Raises ``ValueError`` starting with ``name``."""
    if len(data) < 18 or data[:2] != BMP_MAGIC:
        _fail(name, "not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize not in _HEADERS or len(data) < 14 + hsize:
        _fail(name, f"BMP header of {hsize} bytes")
    if hsize == 12:
        w, h, _planes, bpp = struct.unpack_from("<HHHH", data, 18)
        comp, colors, entry = 0, 0, 3
    else:
        w, h, _planes, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        colors, entry = struct.unpack_from("<I", data, 46)[0], 4
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0 or w * h > MAX_PIXELS:
        _fail(name, f"BMP of {w}x{h} pixels")
    ok = {0: (1, 4, 8, 16, 24, 32), 1: (8,), 2: (4,), 3: (16, 24, 32)}
    if bpp not in ok.get(comp, ()):
        _fail(name, f"{bpp}-bit BMP with compression {comp} is not read")
    masks = None
    if comp == 3:
        if len(data) < 66:
            _fail(name, "truncated BMP bitfields")
        masks = struct.unpack_from("<IIII", data, 54)
        if hsize < 56:  # a 40- or 52-byte header carries no alpha mask
            masks = masks[:3] + (0,)
        if file_path and (bpp == 24 or (bpp == 16 and hsize != 40)):
            _fail(name, f"{bpp}-bit BMP bitfields under a {hsize}-byte "
                  "header (cv2 refuses them)")
        if not file_path and (masks if bpp == 32 else masks[:3]) \
                not in _PIL_MASKS[bpp]:
            _fail(name, "unsupported BMP bitfields layout "
                  f"{[hex(v) for v in masks]}")
        if bpp == 16 and masks[:3] not in (_MASKS565, _MASKS555):
            _fail(name, "16-bit BMP bitfields "
                  f"{[hex(v) for v in masks[:3]]}")

    palette = None
    if bpp <= 8:
        n = colors or 1 << bpp
        if n > 1 << 16:  # PIL's limit
            _fail(name, f"BMP palette of {n} colours")
        raw = data[14 + hsize:14 + hsize + n * entry]
        palette = np.zeros((max(256, n), 3), np.uint8)
        got = np.frombuffer(raw[:len(raw) // entry * entry], np.uint8)
        palette[:len(got) // entry] = got.reshape(-1, entry)[:, 2::-1]
        if not file_path and offset == 14 + hsize:  # PIL skips the palette
            offset += 4 * n

    if comp in (1, 2):
        if top_down and file_path:
            _fail(name, "top-down RLE BMP")
        decode = _rle_cv2 if file_path else _rle_pil
        idx = decode(data, offset, w, h, comp == 2, name)
        if file_path or not top_down:
            idx = idx[::-1]
        return np.ascontiguousarray(palette[idx])

    stride = (w * bpp + 31) // 32 * 4
    if len(data) < offset + stride * h:
        _fail(name, "truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(
        h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        idx = rows[:, :w] if bpp == 8 else _unpack_bits(rows, w, bpp)
        return np.ascontiguousarray(palette[idx])
    if bpp == 16:
        v = rows[:, :2 * w].copy().view("<u2").astype(np.int64)
        six = masks is not None and masks[:3] == _MASKS565
        r = (v >> (11 if six else 10)) & 31
        g = (v >> 5) & (63 if six else 31)
        b = v & 31
        if file_path:
            rgb = (r << 3, g << (2 if six else 3), b << 3)
        else:
            rgb = (r * 255 // 31, g * 255 // (63 if six else 31),
                   b * 255 // 31)
        return np.stack(rgb, -1).astype(np.uint8)
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)
    order = (2, 1, 0)
    if bpp == 32 and masks is not None and file_path and hsize >= 56 \
            and all(masks[:3]):
        return _scaled_fields(px, masks[:3])
    if bpp == 32 and masks is not None and not file_path:
        order = _bytes_of(masks[:3], name)
    return np.ascontiguousarray(px[..., list(order)])


def _scaled_fields(px: np.ndarray, masks) -> np.ndarray:
    """cv2's 32-bit bitfields (a header of 56 bytes or more, no mask
    zero): each field ``(v & mask) >> shift`` times ``255 / (mask >>
    shift)``, in float32, truncated."""
    v = np.ascontiguousarray(px).view("<u4")[..., 0].astype(np.int64)
    out = []
    for m in masks:
        shift = (m & -m).bit_length() - 1
        top = m >> shift
        f = ((v & m) >> shift).astype(np.float32)
        out.append((f * np.float32(255.0 / top)).astype(np.uint8))
    return np.stack(out, -1)


def encode_bmp(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes ``cv2.imencode('.bmp', img[...,
    ::-1])`` gives: 24-bit, bottom-up, a 40-byte header, no resolution."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_bmp takes uint8 [H, W, 3], got {img.shape}")
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, -1)
    body = rows.tobytes()
    return (BMP_MAGIC + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
            + body)
