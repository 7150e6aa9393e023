"""TIFF reading on the host: the first page (IFD0), as PIL + libtiff
decode a request body and ``convert("RGB")`` turns it to RGB (no JAX
counterpart: the JAX server calls PIL, which the machines the port runs on
do not have).

Read: byte order ``II`` or ``MM``; strips and tiles; planar
configurations 1 (chunky) and 2 (one plane a sample: RGB and an
unassociated alpha at 8 bits; compressed, also at 16 bits, with an
associated alpha, gray with alpha, and tiled with an unused extra
sample); compression none,
LZW (``runtime/csrc/lzw.cpp``: MSB first, the early change), Adobe Deflate
and old Deflate (Python's ``zlib``) and PackBits; the horizontal
differencing predictor (2) after LZW and Deflate, as libtiff runs it (not
after PackBits, nor on uncompressed data, where PIL reads the bytes as
they are); the photometric interpretations:

* min-is-white / min-is-black gray at 1, 2, 4 and 8 bits (min-is-white
  inverted), and 16 bits (``I;16``, clipped to 255 by ``convert("RGB")``;
  PIL reads 16-bit min-is-white as min-is-black and has no big-endian
  min-is-white at 16 bits), with an unassociated alpha at 8 bits;
* RGB at 8 and 16 bits (16 by the high byte), with an alpha or unused
  extra samples: an unassociated alpha is dropped, an associated
  (premultiplied) one divided out as PIL's ``RGBa`` unpacker does
  (``v * 255 // a``, 0 where a is 0);
* palette at 1, 2, 4 and 8 bits (the ColorMap's high bytes).

Pillow does not apply the TIFF orientation on ``open``, and neither does
this reader.  Refused by name, each with a ``ValueError`` naming the source
and the reason: JPEG-compressed TIFF (compression 7), CCITT (2-4), LZMA,
ZSTD, WebP-in-TIFF and other compressions; float and signed samples; CMYK,
YCbCr, CIELab and other photometric interpretations; bit depths and sample
layouts outside the lists above; the bit-reversed fill order; BigTIFF; data
that ends before the image.  The file path (``cv2.imread``'s globs) does
not read TIFF: ``img_utils.decode_image`` refuses it there.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, List

import numpy as np

from .gif import get_lib
from .png import MAX_PIXELS

TIFF_MAGICS = (b"II*\x00", b"MM\x00*")

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i",
          16: "Q"}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Adobe Deflate", 32946: "Deflate",
                 32773: "PackBits"}
_REFUSED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
            6: "old-style JPEG", 7: "JPEG", 34925: "LZMA", 50000: "ZSTD",
            50001: "WebP", 34712: "JPEG 2000", 32809: "ThunderScan",
            34892: "lossy JPEG (DNG)"}
_PHOTOMETRICS = {0: "min-is-white", 1: "min-is-black", 2: "RGB",
                 3: "palette", 4: "transparency mask", 5: "CMYK (separated)",
                 6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                 32844: "LogL", 32845: "LogLuv"}


def is_tiff(data: bytes) -> bool:
    """``II*\\0`` or ``MM\\0*``."""
    return data[:4] in TIFF_MAGICS


def _ifd0(data: bytes, name: str) -> Dict[int, List[int]]:
    """The tags of IFD0 -> their values (numbers)."""
    e = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack_from(e + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError(f"{name}: TIFF IFD0 past the end of the data")
    (count,) = struct.unpack_from(e + "H", data, off)
    tags = {}
    for i in range(count):
        at = off + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD0")
        tag, kind, n = struct.unpack_from(e + "HHI", data, at)
        if kind not in _TYPES:
            continue  # rationals, floats: no tag read here takes them
        fmt = _TYPES[kind]
        size = struct.calcsize(fmt) * n
        src = at + 8 if size <= 4 else struct.unpack_from(e + "I", data,
                                                          at + 8)[0]
        if src + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} past the end of the "
                             "data")
        tags[tag] = list(struct.unpack_from(f"{e}{n}{fmt}", data, src))
    return tags


def _one(tags, tag: int, default=None):
    v = tags.get(tag)
    return v[0] if v else default


def _packbits(src: bytes, need: int) -> bytes:
    """libtiff's PackBitsDecode of one strip or tile."""
    out, i = bytearray(), 0
    while i < len(src) and len(out) < need:
        n = src[i]
        i += 1
        if n > 128:
            out += src[i:i + 1] * min(257 - n, need - len(out))
            i += 1
        elif n < 128:
            k = min(n + 1, need - len(out))
            out += src[i:i + k]
            i += n + 1
    return bytes(out)


def _decompress(src: bytes, comp: int, need: int, name: str) -> bytes:
    if comp == 1:
        out = src[:need]
    elif comp == 5:
        buf = np.empty(need, np.uint8)
        err = ctypes.create_string_buffer(256)
        n = get_lib().crdr_tiff_lzw(src, len(src), buf.ctypes.data, need,
                                    err, len(err))
        if n < 0:
            raise ValueError(f"{name}: {err.value.decode()}")
        out = buf[:n].tobytes()
    elif comp in (8, 32946):
        d = zlib.decompressobj()
        try:
            out = d.decompress(src, need)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt TIFF Deflate data ({e})") \
                from None
    else:
        out = _packbits(src, need)
    if len(out) < need:
        raise ValueError(f"{name}: truncated TIFF image data ({len(out)} of "
                         f"{need} bytes in a strip or tile)")
    return out


def _undo_predictor(rows: np.ndarray, spp: int, bits: int, e: str
                    ) -> np.ndarray:
    """Horizontal differencing undone on [rows, row_bytes] of one strip or
    tile: a running sum along each row, per sample, modulo the sample's
    range."""
    if bits == 8:
        n = rows.shape[1] // spp * spp
        v = rows[:, :n].reshape(rows.shape[0], -1, spp)
        rows = rows.copy()
        rows[:, :n] = np.cumsum(v, axis=1, dtype=np.uint8).reshape(
            rows.shape[0], n)
        return rows
    dt = np.dtype(e + "u2")
    n = rows.shape[1] // (2 * spp) * 2 * spp
    v = rows[:, :n].copy().view(dt).reshape(rows.shape[0], -1, spp)
    s = np.cumsum(v, axis=1, dtype=np.uint16).astype(dt)
    rows = rows.copy()
    rows[:, :n] = s.reshape(rows.shape[0], -1).view(np.uint8)
    return rows


def _samples(planes: np.ndarray, w: int, pspp: int, bits: int, e: str
             ) -> np.ndarray:
    """[planes, h, row_bytes] -> samples [h, w, samples] as int64 (each
    plane's rows hold w * pspp samples)."""
    p, h, _ = planes.shape
    out = []
    for k in range(p):
        rows = planes[k]
        if bits == 16:
            v = rows.view(np.dtype(e + "u2")).astype(np.int64)
        elif bits == 8:
            v = rows.astype(np.int64)
        else:
            b = np.unpackbits(rows, axis=1)
            n = b.shape[1] // bits
            v = (b[:, :n * bits].reshape(h, n, bits).astype(np.int64)
                 * (1 << np.arange(bits - 1, -1, -1))).sum(-1)
        out.append(v)
    if p == 1:
        return out[0][:, :w * pspp].reshape(h, w, pspp)
    return np.stack([v[:, :w] for v in out], axis=-1)


def decode_tiff(data: bytes, name: str = "TIFF data") -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 3] RGB of IFD0, as PIL + libtiff and
    ``convert("RGB")`` read a request body (module doc).  Raises
    ``ValueError`` starting with ``name``."""
    if not is_tiff(data) or len(data) < 8:
        raise ValueError(f"{name}: not a TIFF file (BigTIFF is not read)")
    e = "<" if data[:2] == b"II" else ">"
    tags = _ifd0(data, name)
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: TIFF image of {w}x{h} pixels")
    comp = _one(tags, 259, 1)
    if comp not in _COMPRESSIONS:
        what = _REFUSED.get(comp, f"compression {comp}")
        raise ValueError(f"{name}: {what}-compressed TIFF is not read")
    photo = _one(tags, 262)
    spp = _one(tags, 277, 1)
    bits_list = tags.get(258, [1] * spp)
    bits = bits_list[0]
    extra = tuple(tags.get(338, ()))
    fmt = set(tags.get(339, [1]))
    planar = _one(tags, 284, 1)
    if fmt != {1}:
        raise ValueError(f"{name}: TIFF sample format {sorted(fmt)} (float "
                         "and signed samples are not read)")
    if _one(tags, 266, 1) != 1:
        raise ValueError(f"{name}: TIFF with the bit-reversed fill order")
    if photo not in (0, 1, 2, 3):
        what = _PHOTOMETRICS.get(photo, f"photometric {photo}")
        raise ValueError(f"{name}: {what} TIFF is not read")
    if len(set(bits_list)) != 1 or len(bits_list) != spp or planar not in \
            (1, 2):
        raise ValueError(f"{name}: TIFF samples {bits_list} "
                         f"(SamplesPerPixel {spp}, planar {planar})")
    color = 3 if photo == 2 else 1
    layouts = {  # (color samples, bits) -> the extra-sample tuples read
        (1, 1): [()], (1, 2): [()], (1, 4): [()], (1, 8): [(), (2,)],
        (1, 16): [()], (3, 8): [(), (0,), (1,), (2,), (0, 0), (1, 0),
                                (2, 0), (0, 0, 0), (1, 0, 0), (2, 0, 0)],
        (3, 16): [(), (0,), (1,), (2,)]}
    if photo == 3:
        layouts = {(1, 1): [()], (1, 2): [()], (1, 4): [()],
                   (1, 8): [(), (0,), (2,)]}
    if color == 3 and bits == 16 and spp == 4 and not extra:
        extra = (2,)  # PIL's RGBA;16 for four samples without ExtraSamples
    ok = layouts.get((color, bits), [])
    if spp != color + len(extra) or extra not in ok \
            or (photo == 0 and bits == 16 and e == ">") \
            or (photo == 0 and extra):
        kind = _PHOTOMETRICS[photo]
        raise ValueError(f"{name}: {kind} TIFF at {bits} bits with "
                         f"{spp} samples (extra {list(extra)}) is not read")
    if planar == 2 and spp > 1 and (
            (0 in extra and (comp == 1 or 322 not in tags)) or photo == 3
            or (comp == 1 and (bits == 16 or color == 1 or 1 in extra))):
        # PIL refuses these (no raw mode for the planes), or reads
        # uncompressed 16-bit planes as 8-bit ones
        raise ValueError(f"{name}: planar TIFF with {spp} samples of {bits} "
                         f"bits (extra {list(extra)}, compression "
                         f"{_COMPRESSIONS[comp]}) is not read")
    predictor = _one(tags, 317, 1)
    if comp in (5, 8, 32946) and predictor not in (1, 2):
        raise ValueError(f"{name}: TIFF predictor {predictor} is not read")
    use_pred = comp in (5, 8, 32946) and predictor == 2
    if use_pred and bits < 8:
        raise ValueError(f"{name}: TIFF predictor 2 at {bits} bits")
    nplanes = spp if planar == 2 else 1
    pspp = 1 if planar == 2 else spp  # samples a pixel within a plane
    row_bytes = (w * pspp * bits + 7) // 8
    planes = np.zeros((nplanes, h, row_bytes), np.uint8)
    if 322 in tags:  # tiles
        tw, th = _one(tags, 322), _one(tags, 323, 0)
        offsets, counts = tags.get(324, []), tags.get(325, [])
        if not tw or not th or tw * th > MAX_PIXELS:
            raise ValueError(f"{name}: TIFF tiles of {tw}x{th}")
        across, down = -(-w // tw), -(-h // th)
        tile_row = (tw * pspp * bits + 7) // 8
        need = tile_row * th
        if len(offsets) < across * down * nplanes or len(counts) < len(
                offsets):
            raise ValueError(f"{name}: TIFF without every tile's offset")
        for k in range(nplanes):
            for t in range(across * down):
                i = k * across * down + t
                raw = _decompress(data[offsets[i]:offsets[i] + counts[i]],
                                  comp, need, name)
                rows = np.frombuffer(raw, np.uint8, need).reshape(th, tile_row)
                if use_pred:
                    rows = _undo_predictor(rows, pspp, bits, e)
                ty, tx = divmod(t, across)
                y0, x0 = ty * th, tx * tw * pspp * bits // 8
                y1 = min(h, y0 + th)
                x1 = min(row_bytes, x0 + tile_row)
                planes[k, y0:y1, x0:x1] = rows[:y1 - y0, :x1 - x0]
    else:
        per = min(_one(tags, 278, h) or h, h)
        offsets, counts = tags.get(273), tags.get(279)
        nstrips = -(-h // per)
        if not offsets or not counts or len(offsets) < nstrips * nplanes:
            raise ValueError(f"{name}: TIFF without every strip's offset")
        for k in range(nplanes):
            for s in range(nstrips):
                i = k * nstrips + s
                y0 = s * per
                rows_n = min(per, h - y0)
                need = rows_n * row_bytes
                cnt = counts[i] if i < len(counts) else 0
                raw = _decompress(data[offsets[i]:offsets[i] + cnt], comp,
                                  need, name)
                rows = np.frombuffer(raw, np.uint8, need).reshape(
                    rows_n, row_bytes)
                if use_pred:
                    rows = _undo_predictor(rows, pspp, bits, e)
                planes[k, y0:y0 + rows_n] = rows
    s = _samples(planes, w, pspp, bits, e)  # [h, w, spp]
    if photo == 3:
        cmap = tags.get(320, [])
        n = 1 << bits
        if len(cmap) < 3 * n:
            raise ValueError(f"{name}: palette TIFF without a full ColorMap")
        pal = (np.asarray(cmap[:3 * n], np.int64) // 256).reshape(3, n).T
        return pal[s[..., 0]].astype(np.uint8)
    if color == 1:
        v = s[..., 0]
        if bits == 16:
            v = np.minimum(v, 255)
        elif bits < 8:
            v = v * (255 // ((1 << bits) - 1))
        if photo == 0 and bits < 16:
            v = 255 - v
        return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
    rgb = s[..., :3] >> 8 if bits == 16 else s[..., :3]
    if extra and extra[0] == 1:  # associated alpha: PIL divides it out
        a = (s[..., 3] >> 8 if bits == 16 else s[..., 3])[..., None]
        rgb = np.where(a == 0, 0, np.where(
            a == 255, rgb, np.minimum(255, rgb * 255 // np.maximum(a, 1))))
    return rgb.astype(np.uint8)
