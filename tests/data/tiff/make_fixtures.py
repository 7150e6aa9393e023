"""Make the TIFF fixtures of this folder and their ``digests.json``.

    python tests/data/tiff/make_fixtures.py

Seeded synthetic images, one file per variant the port's TIFF reader
(``crdr_tpu_torch/utils/tiff.py``) is held to: what PIL writes (raw, LZW,
Adobe Deflate, PackBits and JPEG compression, and its 1-bit, gray, palette
and RGBA modes) and, by hand (``write_tiff`` below, with its own LZW and
PackBits encoders), the layouts PIL does not write: ``MM`` byte order,
tiles, planar configuration 2, the predictor at 8 and 16 bits, old-style
Deflate, 2- / 4- / 16-bit samples, associated alpha, a last strip shorter
than RowsPerStrip, and the refusals (CCITT, LZMA-like and float samples,
CMYK).

``digests.json`` holds, for each file, the sha256 of the pixels (uint8 RGB,
row-major) that ``PIL.Image.open(...).convert("RGB")`` gives (``body``)
and their shape, or PIL's error (``refused``); ``cv2`` records what
``cv2.imread`` gives a file of the same bytes, for the record (the port's
file path refuses TIFF).  ``tests/test_torch_tiff.py`` recomputes PIL's.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np

from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB first, codes widening one code early)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    table = {bytes([i]): i for i in range(256)}
    free = 258
    put(256)
    cur = b""
    for b in data:
        nxt = cur + bytes([b])
        if nxt in table:
            cur = nxt
            continue
        put(table[cur])
        table[nxt] = free
        free += 1
        if free in (512, 1024, 2048):
            nbits += 1
        if free == 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            free, nbits = 258, 9
        cur = bytes([b])
    if cur:
        put(table[cur])
        free += 1
        if free in (512, 1024, 2048):
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more repeated, the rest literal."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        k = i
        while k < len(data) and k - i < 128 and not (
                k + 2 < len(data) and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def _compress(raw: bytes, comp: int) -> bytes:
    if comp == 1:
        return raw
    if comp == 5:
        return lzw_encode(raw)
    if comp in (8, 32946):
        return zlib.compress(raw, 6)
    if comp == 32773:
        return packbits_encode(raw)
    return raw  # a refused compression: the bytes do not matter


def _predict(rows: np.ndarray, spp: int, bits: int, e: str) -> np.ndarray:
    """Horizontal differencing of [rows, row_bytes]."""
    if bits == 8:
        v = rows.reshape(rows.shape[0], -1, spp).astype(np.int16)
        d = np.diff(v, axis=1, prepend=0)
        d[:, 0] = v[:, 0]
        return (d & 0xFF).astype(np.uint8).reshape(rows.shape)
    dt = np.dtype(e + "u2")
    v = rows.copy().view(dt).reshape(rows.shape[0], -1, spp).astype(np.int32)
    d = np.diff(v, axis=1, prepend=0)
    d[:, 0] = v[:, 0]
    return (d & 0xFFFF).astype(dt).reshape(rows.shape[0], -1).view(np.uint8)


def write_tiff(samples: np.ndarray, bits: int, photometric: int,
               comp: int = 1, order: str = "II", planar: int = 1,
               rows_per_strip=None, tile=None, predictor: int = 1,
               extra=(), colormap=None, sample_format=None) -> bytes:
    """A TIFF of ``samples`` ([h, w, spp] integers of ``bits`` bits)."""
    e = "<" if order == "II" else ">"
    h, w, spp = samples.shape
    planes = ([samples[..., k:k + 1] for k in range(spp)] if planar == 2
              else [samples])

    def pack(s: np.ndarray) -> np.ndarray:  # [h, w, p] -> [h, row_bytes]
        if bits == 16:
            return s.astype(e + "u2").reshape(s.shape[0], -1).view(np.uint8)
        if bits == 32:
            return s.astype(e + "f4").reshape(s.shape[0], -1).view(np.uint8)
        if bits == 8:
            return s.astype(np.uint8).reshape(s.shape[0], -1)
        flat = s.reshape(s.shape[0], -1).astype(np.uint8)
        b = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(
            s.shape[0], -1).astype(np.uint8)
        return np.packbits(b, axis=1)

    chunks = []  # encoded strips / tiles, plane by plane
    for p in planes:
        pspp = p.shape[2]
        if tile:
            tw, th = tile
            ph, pw = -(-h // th) * th, -(-w // tw) * tw
            full = np.zeros((ph, pw, pspp), p.dtype)
            full[:h, :w] = p
            for ty in range(0, ph, th):
                for tx in range(0, pw, tw):
                    rows = pack(full[ty:ty + th, tx:tx + tw])
                    if predictor == 2:
                        rows = _predict(rows, pspp, bits, e)
                    chunks.append(_compress(rows.tobytes(), comp))
        else:
            per = rows_per_strip or h
            for y in range(0, h, per):
                rows = pack(p[y:y + per])
                if predictor == 2:
                    rows = _predict(rows, pspp, bits, e)
                chunks.append(_compress(rows.tobytes(), comp))
    body = b"".join(chunks)
    offsets, pos = [], 8
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [comp]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]),
                    (324, 4, offsets), (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, offsets), (278, 4, [rows_per_strip or h]),
                    (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, list(colormap)))
    if extra:
        entries.append((338, 3, list(extra)))
    if sample_format is not None:
        entries.append((339, 3, [sample_format] * spp))
    entries.sort()
    ifd_off = pos + (pos & 1)
    ext = ifd_off + 2 + 12 * len(entries) + 4
    ifd = struct.pack(e + "H", len(entries))
    tail = bytearray()
    for tag, kind, vals in entries:
        fmt = "H" if kind == 3 else "I"
        payload = struct.pack(f"{e}{len(vals)}{fmt}", *vals)
        if len(payload) <= 4:
            ifd += struct.pack(e + "HHI", tag, kind, len(vals)) \
                + payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", tag, kind, len(vals),
                               ext + len(tail))
            tail += payload
    ifd += struct.pack(e + "I", 0)
    head = (b"II*\0" if order == "II" else b"MM\0*") + struct.pack(
        e + "I", ifd_off)
    return head + body + bytes(ifd_off - pos) + ifd + bytes(tail)


_spec = importlib.util.spec_from_file_location(
    "gif_fixtures", os.path.join(os.path.dirname(HERE), "gif",
                                 "make_fixtures.py"))
_gif = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gif)

# files PIL refuses: the port's reason
REFUSED = {"refused_truncated.tif": "truncated TIFF image data",
           "refused_planar_rgbx.tif": "planar TIFF",
           "refused_webp_in_tiff.tif": "WebP-compressed TIFF"}
# files PIL reads and the port refuses by name
ON_PURPOSE = {"pil_jpeg.tif": "JPEG-compressed TIFF",
              "pil_group4.tif": "CCITT Group 4-compressed TIFF",
              "pil_lzma.tif": "LZMA-compressed TIFF",
              "pil_zstd.tif": "ZSTD-compressed TIFF",
              "pil_float.tif": "sample format",
              "pil_cmyk.tif": "CMYK",
              "planar_16bit_raw.tif": "planar TIFF"}


def synthetic(h: int, w: int, bands: int, bits: int, seed: int
              ) -> np.ndarray:
    """Waves and a little noise: [h, w, bands] samples of ``bits`` bits."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    top = (1 << bits) - 1
    chans = [0.5 + 0.45 * np.sin(0.3 * xx * (b + 1) + 0.2 * yy + b)
             for b in range(bands)]
    v = np.stack(chans, -1) * top + rng.normal(0, top * 0.03, (h, w, bands))
    return np.clip(np.round(v), 0, top).astype(np.int64)


def pil_tiff(im: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    rgb8 = synthetic(19, 27, 3, 8, 1).astype(np.uint8)
    im = Image.fromarray(rgb8)
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        out[f"pil_rgb_{comp}.tif"] = pil_tiff(im, compression=comp)
    out["pil_l.tif"] = pil_tiff(im.convert("L"), compression="tiff_lzw")
    out["pil_1.tif"] = pil_tiff(im.convert("1"), compression="packbits")
    out["pil_p.tif"] = pil_tiff(im.quantize(16), compression="tiff_lzw")
    rgba = np.concatenate([rgb8, synthetic(19, 27, 1, 8, 2).astype(
        np.uint8)], -1)
    out["pil_rgba.tif"] = pil_tiff(Image.fromarray(rgba, "RGBA"),
                                   compression="tiff_adobe_deflate")
    out["pil_i16.tif"] = pil_tiff(Image.fromarray(
        synthetic(13, 17, 1, 9, 3)[..., 0].astype(np.uint16)))
    out["pil_jpeg.tif"] = pil_tiff(im, compression="jpeg")
    out["pil_group4.tif"] = pil_tiff(im.convert("1"), compression="group4")
    for comp in ("lzma", "zstd"):
        out[f"pil_{comp}.tif"] = pil_tiff(im, compression=comp)
    # PIL's libtiff has no WebP codec: it refuses such a file (and crashes
    # writing one)
    out["refused_webp_in_tiff.tif"] = write_tiff(rgb8, 8, 2, 50001)
    out["pil_float.tif"] = pil_tiff(Image.fromarray(
        rgb8[..., 0].astype(np.float32) / 7, "F"))
    out["pil_cmyk.tif"] = pil_tiff(im.convert("CMYK"))
    rgb = synthetic(21, 23, 3, 8, 4)
    for comp, tag in ((5, "lzw"), (8, "adobe_deflate"), (32946, "deflate")):
        out[f"predictor_8bit_{tag}.tif"] = write_tiff(rgb, 8, 2, comp,
                                                      predictor=2)
    rgb16 = synthetic(11, 13, 3, 16, 5)
    out["predictor_16bit_lzw.tif"] = write_tiff(rgb16, 16, 2, 5,
                                                predictor=2)
    out["predictor_16bit_mm.tif"] = write_tiff(rgb16, 16, 2, 8, "MM",
                                               predictor=2)
    out["rgb_16bit_mm.tif"] = write_tiff(rgb16, 16, 2, 1, "MM")
    out["rgb_mm_packbits.tif"] = write_tiff(rgb, 8, 2, 32773, "MM")
    out["tiles_lzw.tif"] = write_tiff(synthetic(29, 37, 3, 8, 6), 8, 2, 5,
                                      tile=(16, 32))
    out["tiles_raw_mm.tif"] = write_tiff(synthetic(20, 18, 1, 8, 7), 8, 1,
                                         1, "MM", tile=(16, 16))
    out["planar_rgb_raw.tif"] = write_tiff(rgb, 8, 2, 1, planar=2)
    out["planar_rgba_lzw.tif"] = write_tiff(
        synthetic(21, 23, 4, 8, 8), 8, 2, 5, planar=2, extra=(2,))
    out["planar_16bit_deflate.tif"] = write_tiff(rgb16, 16, 2, 8, planar=2,
                                                 predictor=2)
    out["planar_16bit_raw.tif"] = write_tiff(rgb16, 16, 2, 1, planar=2)
    out["short_last_strip.tif"] = write_tiff(rgb, 8, 2, 5,
                                             rows_per_strip=4)
    for bits in (1, 2, 4):
        g = synthetic(15, 21, 1, bits, 9 + bits)
        out[f"gray_{bits}bit_min_is_white.tif"] = write_tiff(g, bits, 0)
        out[f"gray_{bits}bit.tif"] = write_tiff(g, bits, 1, 32773)
        cmap = np.random.default_rng(bits).integers(0, 65536, 3 << bits)
        out[f"palette_{bits}bit.tif"] = write_tiff(g, bits, 3, 5,
                                                   colormap=cmap)
    g8 = synthetic(15, 21, 1, 8, 13)
    out["gray_8bit_min_is_white.tif"] = write_tiff(g8, 8, 0, 8)
    out["gray_16bit_mm.tif"] = write_tiff(synthetic(15, 21, 1, 16, 14), 16,
                                          1, 1, "MM")
    out["gray_alpha.tif"] = write_tiff(synthetic(15, 21, 2, 8, 15), 8, 1, 5,
                                       extra=(2,))
    a = synthetic(17, 19, 4, 8, 16)
    a[..., :3] = a[..., :3] * a[..., 3:] // 255  # premultiplied
    out["rgba_associated.tif"] = write_tiff(a, 8, 2, 5, extra=(1,))
    out["rgbx_unused_extra.tif"] = write_tiff(a, 8, 2, 1, extra=(0,))
    a16 = synthetic(9, 11, 4, 16, 17)
    a16[..., :3] = a16[..., :3] * a16[..., 3:] // 65535
    out["rgba_associated_16bit.tif"] = write_tiff(a16, 16, 2, 8,
                                                  extra=(1,))
    # a strip whose LZW data ends (its end code) after 7 of 21 rows
    short = bytearray(write_tiff(rgb[:7], 8, 2, 5))
    ifd = struct.unpack_from("<I", short, 4)[0]
    for i in range(struct.unpack_from("<H", short, ifd)[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", short, at)[0] in (257, 278):
            struct.pack_into("<I", short, at + 8, 21)
    out["refused_truncated.tif"] = bytes(short)
    out["refused_planar_rgbx.tif"] = write_tiff(a, 8, 2, 1, planar=2,
                                                extra=(0,))
    return out


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def pil_digests(data: bytes) -> dict:
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return {"body": sha(rgb), "body_shape": list(rgb.shape)}


def main() -> None:
    files = fixtures()
    _gif.write(HERE, files, REFUSED, pil_digests)
    path = os.path.join(HERE, "digests.json")
    with open(path) as f:
        digests = json.load(f)
    for name, why in ON_PURPOSE.items():
        digests[name]["refused"] = why
    with open(path, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
