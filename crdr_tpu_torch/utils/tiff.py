"""TIFF reading on the host: the first page (IFD0), as PIL + libtiff
decode a request body and ``convert("RGB")`` turns it, or as
``cv2.imread`` reads a file (no JAX counterpart for bodies: the JAX server
calls PIL; the JAX package's files go through cv2; the machines the port
runs on have neither).

Read on both paths: byte order ``II`` or ``MM``; strips and tiles; planar
configurations 1 (chunky) and 2 (one plane a sample); compression none,
LZW (``runtime/csrc/lzw.cpp``: MSB first, the early change), Adobe Deflate
and old Deflate (Python's ``zlib``), PackBits and JPEG (compression 7: each
strip or tile an abbreviated stream whose tables are in JPEGTables, 347,
decoded by ``utils/jpeg.py`` as libtiff's ``JPEGCOLORMODE_RGB`` has libjpeg
decode it: YCbCr to RGB with fancy upsampling, RGB and gray as they are);
the horizontal differencing predictor (2) after LZW and Deflate, as
libtiff runs it (not after PackBits, nor on uncompressed data, where PIL
reads the bytes as they are).

A body (PIL): LZMA too (Python's ``lzma``); the photometric
interpretations

* min-is-white / min-is-black gray at 1, 2, 4 and 8 bits (min-is-white
  inverted), and 16 bits (``I;16``, clipped to 255 by ``convert("RGB")``;
  PIL reads 16-bit min-is-white as min-is-black and has no big-endian
  min-is-white at 16 bits), with an unassociated alpha at 8 bits;
* RGB at 8 and 16 bits (16 by the high byte), with an alpha or unused
  extra samples: an unassociated alpha is dropped, an associated
  (premultiplied) one divided out as PIL's ``RGBa`` unpacker does
  (``v * 255 // a``, 0 where a is 0);
* palette at 1, 2, 4 and 8 bits (the ColorMap's high bytes);
* CMYK at 8 bits, as PIL's ``cmyk2rgb`` turns it;

and the Orientation tag (274) applied, as Pillow's ``load_end`` applies it
(``ImageOps.exif_transpose``, 2-8).

A file (cv2): OpenCV reads an 8-bit colour image through libtiff's
``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``, so this follows
``tif_getimage.c``: gray at 1 and 8 bits as they are (min-is-white
inverted), at 16 bits by the high byte; RGB at 8 bits, at 16 bits as
``(v + 128) // 257``, an unassociated alpha premultiplied (``(v * a + 127)
// 255``), an associated one or an unspecified extra sample past the third
left as it is, four samples without ExtraSamples an associated alpha; a
palette of 1, 4 or 8 bits (a ColorMap of values under 256 read as 8-bit);
CMYK at 8 bits (``k * (255 - c) // 255``); planar gray read as RGB from its
first plane; a strip or tile whose data ends short decoded as far as it
goes, then zeros (libtiff goes on past a strip's error).  The Orientation
tag: 2-4 applied; 5-8 applied to a square image, None otherwise (OpenCV
would transpose into a buffer of the other shape).  None for what OpenCV
or libtiff refuse: 2-bit samples, 4-bit ones but a palette's, 32-bit
samples, more than 4 samples a pixel, LZMA, ZSTD and WebP compression
("not configured"), an RGB image with fewer than 3 colour samples.

Refused by name, each with a ``ValueError`` naming the source and the
reason: CCITT (2-4, which cv2 reads: a gap, listed in ROADMAP.md),
old-style JPEG, ZSTD and WebP-in-TIFF on the body path, and other
compressions; float and signed samples; YCbCr but under JPEG, CIELab and
other photometric interpretations; bit depths and sample layouts outside
the lists above; the bit-reversed fill order; BigTIFF; data that ends
before the image (a body); on the file path, tiles OpenCV assembles out
of place (gray with an extra sample or at 16 bits; mirrored by orientation
2, 3, 6 or 7 across more than one column of tiles), where cv2 returns rows
of zeros and of other tiles' bytes.
"""

from __future__ import annotations

import ctypes
import lzma
import struct
import zlib
from typing import Dict, List

import numpy as np

from .gif import get_lib
from .jpeg import decode_jpeg, orient
from .png import MAX_PIXELS

TIFF_MAGICS = (b"II*\x00", b"MM\x00*")

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i",
          16: "Q"}
_COMPRESSIONS = {1: "none", 5: "LZW", 7: "JPEG", 8: "Adobe Deflate",
                 32946: "Deflate", 32773: "PackBits", 34925: "LZMA"}
# compressions the libtiff under OpenCV is built without
_CV2_UNCONFIGURED = {34925: "LZMA", 50000: "ZSTD", 50001: "WEBP"}
_REFUSED = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
            6: "old-style JPEG", 50000: "ZSTD",
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


def _decompress(src: bytes, comp: int, need: int, name: str,
                partial: bool = False) -> bytes:
    """One strip or tile's bytes.  Short data raises, or with ``partial``
    (libtiff under ``TIFFReadRGBAStrip``, which goes on past a strip's
    error) is what was decoded, then zeros."""
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
    elif comp == 34925:
        try:
            out = lzma.LZMADecompressor().decompress(src, need)
        except lzma.LZMAError as e:
            raise ValueError(f"{name}: corrupt TIFF LZMA data ({e})") \
                from None
    else:
        out = _packbits(src, need)
    if len(out) < need:
        if partial:
            return out + bytes(need - len(out))
        raise ValueError(f"{name}: truncated TIFF image data ({len(out)} of "
                         f"{need} bytes in a strip or tile)")
    return out


def _jpeg_chunk(src: bytes, tables: bytes, photo: int, spp: int,
                size: tuple, name: str, partial: bool) -> bytes:
    """One strip or tile of a JPEG-compressed TIFF (compression 7): an
    abbreviated JPEG stream that takes its quantization and Huffman tables
    from the JPEGTables tag (347), decoded as libtiff has libjpeg decode it
    (``JPEGCOLORMODE_RGB``: YCbCr to RGB, any other photometric's samples as
    they are) -> its ``size`` (width, height) x ``spp`` bytes, row-major."""
    if src[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: a JPEG TIFF strip or tile without SOI")
    if tables:
        if tables[:2] != b"\xff\xd8":
            raise ValueError(f"{name}: TIFF JPEGTables without SOI")
        end = len(tables) - 2 if tables[-2:] == b"\xff\xd9" else len(tables)
        src = src[:2] + tables[2:end] + src[2:]
    space = {6: "ycc", 2: "rgb"}.get(photo, "gray")
    rgb = decode_jpeg(src, name, file_path=partial, space=space)
    if (rgb.shape[1], rgb.shape[0]) != size:
        raise ValueError(f"{name}: a JPEG TIFF strip or tile of "
                         f"{rgb.shape[1]}x{rgb.shape[0]} where the TIFF says "
                         f"{size[0]}x{size[1]}")
    return np.ascontiguousarray(rgb[..., :spp]).tobytes()


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


def _planes(data: bytes, tags, name: str, e: str, w: int, h: int,
            bits: int, spp: int, partial: bool) -> np.ndarray:
    """The image's decompressed bytes: [planes, h, row_bytes], one plane
    a sample when planar (configuration 2), else one."""
    comp = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if comp == 7 and (bits != 8 or (planar == 2 and spp > 1)
                      or spp not in (1, 3)):
        raise ValueError(f"{name}: JPEG-compressed TIFF with {spp} samples "
                         f"of {bits} bits (planar {planar}) is not read")
    tables = bytes(tags.get(347, ()))
    photo = _one(tags, 262)

    def chunk(src: bytes, need: int, cols: int, rows: int) -> bytes:
        if comp == 7:
            return _jpeg_chunk(src, tables, photo, spp, (cols, rows), name,
                               partial)
        return _decompress(src, comp, need, name, partial)

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
                raw = chunk(data[offsets[i]:offsets[i] + counts[i]], need,
                            tw, th)
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
                raw = chunk(data[offsets[i]:offsets[i] + cnt], need, w,
                            rows_n)
                rows = np.frombuffer(raw, np.uint8, need).reshape(
                    rows_n, row_bytes)
                if use_pred:
                    rows = _undo_predictor(rows, pspp, bits, e)
                planes[k, y0:y0 + rows_n] = rows
    return planes


def _header(data: bytes, name: str):
    """(byte order, tags, width, height) of IFD0, the compression checked
    against the codecs read."""
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
    if _one(tags, 266, 1) != 1:
        raise ValueError(f"{name}: TIFF with the bit-reversed fill order")
    return e, tags, w, h


def _decode_tiff_pil(data: bytes, name: str) -> np.ndarray:
    """IFD0 as PIL + libtiff read a body and ``convert("RGB")`` turns it
    (module doc)."""
    e, tags, w, h = _header(data, name)
    comp = _one(tags, 259, 1)
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
    if photo == 6 and comp == 7:
        photo = 2  # libjpeg turns it to RGB
    if photo == 5 and bits == 8 and spp == 4 and planar == 1 \
            and _one(tags, 332, 1) == 1:
        s = _samples(_planes(data, tags, name, e, w, h, 8, 4, False), w, 4,
                     8, e)  # PIL's CMYK, then cmyk2rgb
        nk = 255 - s[..., 3:]
        t = s[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
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
    planes = _planes(data, tags, name, e, w, h, bits, spp, False)
    s = _samples(planes, w, 1 if planar == 2 else spp, bits, e)
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


def _cv2_none(name: str, why: str):
    raise ValueError(f"{name}: {why} (cv2.imread returns None)")


def _decode_tiff_cv2(data: bytes, name: str) -> np.ndarray:
    """IFD0 as ``cv2.imread`` reads a file: OpenCV's TIFF reader takes an
    8-bit colour image through libtiff's ``TIFFReadRGBAStrip`` /
    ``TIFFReadRGBATile`` (module doc)."""
    if is_tiff(data):
        comp = _one(_ifd0(data, name), 259, 1)
        if comp in _CV2_UNCONFIGURED:
            _cv2_none(name, f"{_CV2_UNCONFIGURED[comp]} compression support "
                      "is not configured")
    e, tags, w, h = _header(data, name)
    photo = _one(tags, 262)
    spp = _one(tags, 277, 1)
    bits_list = tags.get(258, [1] * spp)
    bits = bits_list[0]
    planar = _one(tags, 284, 1)
    extra = tuple(tags.get(338, ()))
    if photo is None:
        _cv2_none(name, "TIFF without a photometric interpretation")
    if photo == 6 and _one(tags, 259, 1) == 7 and planar == 1:
        photo = 2  # libtiff's JPEGCOLORMODE_RGB: libjpeg turns it to RGB
    if bits not in (1, 4, 8, 16) or (bits == 4 and photo != 3):
        _cv2_none(name, f"TIFF at {bits} bits a sample (OpenCV reads 1, 4 "
                  "(palette), 8 and 16)")
    if not 1 <= spp <= 4:
        _cv2_none(name, f"TIFF with {spp} samples a pixel")
    if set(tags.get(339, [1])) != {1}:
        raise ValueError(f"{name}: TIFF sample format "
                         f"{sorted(set(tags[339]))} (float and signed "
                         "samples are not read)")
    if len(set(bits_list)) != 1 or len(bits_list) != spp or planar not in \
            (1, 2):
        raise ValueError(f"{name}: TIFF samples {bits_list} "
                         f"(SamplesPerPixel {spp}, planar {planar})")
    # libtiff's TIFFRGBAImageBegin: which extra sample is an alpha
    alpha = 0
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else (1 if spp > 3 else 0)
    elif spp == 4 and photo == 2:
        alpha, extra = 1, (1,)
    contig = planar == 1 or spp == 1
    if photo in (0, 1, 3) and contig and spp != 1 and bits < 8:
        _cv2_none(name, "contiguous TIFF samples of under 8 bits beside "
                  "others")
    if photo == 2 and spp - len(extra) < 3:
        _cv2_none(name, "RGB TIFF with fewer than 3 colour samples")
    if photo == 5 and (_one(tags, 332, 1) != 1 or spp < 4 or bits != 8):
        _cv2_none(name, f"separated TIFF (inkset {_one(tags, 332, 1)}, {spp} "
                  f"samples of {bits} bits)")
    if photo not in (0, 1, 2, 3, 5):
        what = _PHOTOMETRICS.get(photo, f"photometric {photo}")
        raise ValueError(f"{name}: {what} TIFF is not read")
    if not contig and (photo == 3 or bits < 8):
        _cv2_none(name, f"planar TIFF, photometric {photo}, at {bits} bits")
    orientation = _one(tags, 274, 1)
    if orientation in (5, 6, 7, 8) and w != h:
        _cv2_none(name, f"TIFF orientation {orientation} (OpenCV's reader "
                  "would transpose into a buffer of the other shape)")
    if 322 in tags and ((orientation in (2, 3, 6, 7)
                         and w > _one(tags, 322, w)) or (
            photo in (0, 1) and contig and (bits == 16 or spp > 1))):
        # OpenCV assembles these tiles out of place (a mirrored tile put at
        # its unmirrored column; gray tiles read as a buffer of another
        # layout): rows of zeros and of other tiles' bytes
        raise ValueError(f"{name}: tiled TIFF ({_PHOTOMETRICS[photo]}, "
                         f"{spp} samples of {bits} bits, orientation "
                         f"{orientation}) that cv2.imread assembles out of "
                         "place is not read")
    planes = _planes(data, tags, name, e, w, h, bits, spp, True)
    s = _samples(planes, w, spp if contig else 1, bits, e)
    if photo == 3:
        cmap = tags.get(320, [])
        n = 1 << bits
        if len(cmap) < 3 * n:
            raise ValueError(f"{name}: palette TIFF without a full ColorMap")
        pal = np.asarray(cmap[:3 * n], np.int64).reshape(3, n).T
        if pal.max() >= 256:  # libtiff's checkcmap: else an 8-bit map
            pal = pal >> 8
        rgb = pal[s[..., 0]]
    elif photo == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        k = 255 - s[..., 3:4]
        rgb = k * (255 - s[..., :3]) // 255
    elif photo in (0, 1) and contig:  # the gray map: high byte at 16 bits
        v = s[..., 0] >> 8 if bits == 16 else s[..., 0] * (255 // (
            (1 << bits) - 1))
        rgb = np.repeat((255 - v if photo == 0 else v)[..., None], 3, 2)
    else:  # RGB, and planar gray read as RGB from its first plane
        c = s[..., :3] if photo == 2 else np.repeat(s[..., :1], 3, 2)
        a = s[..., -1:] if alpha else None
        if bits == 16:  # libtiff's Bitdepth16To8
            c = (c + 128) // 257
            a = None if a is None else (a + 128) // 257
        rgb = c
        if alpha == 2:  # unassociated: premultiplied, rounded (UaToAa)
            rgb = (c * a + 127) // 255
    rgb = rgb.astype(np.uint8)
    return orient(rgb, orientation) if 2 <= orientation <= 8 else rgb


def decode_tiff(data: bytes, name: str = "TIFF data",
                file_path: bool = False) -> np.ndarray:
    """TIFF bytes -> uint8 [H, W, 3] RGB of IFD0, as PIL + libtiff and
    ``convert("RGB")`` read a request body (turned by its orientation) or,
    with ``file_path``, as ``cv2.imread`` reads a file (module doc).
    Raises ``ValueError`` starting with ``name``."""
    if file_path:
        return _decode_tiff_cv2(data, name)
    rgb = _decode_tiff_pil(data, name)
    orientation = _one(_ifd0(data, name), 274, 1)
    return orient(rgb, orientation) if 2 <= orientation <= 8 else rgb
