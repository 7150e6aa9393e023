"""Make the PNG fixtures of this folder and their ``digests.json``.

    python tests/data/png/make_fixtures.py

Seeded synthetic images, one file per variant the port's PNG reader
(``crdr_tpu_torch/utils/png.py``) is held to:

* every colour type at every bit depth it allows, written by hand with a
  seeded row filter per row (``write_png`` below), non-interlaced and Adam7
  (PIL does not write Adam7);
* what PIL writes: an optimized RGB file, a palette (``convert("P")``), a
  palette with ``tRNS``, EXIF orientations 1-8 (an ``eXIf`` chunk), an APNG
  whose default image is its first frame and one whose default image is not
  in the animation (``cv2.imread`` and PIL read the default image,
  ``cv2.imdecode`` the first frame);
* ancillary chunks that change no pixel (gAMA, iCCP, sBIT, bKGD, cHRM,
  pHYs, sRGB, tIME, tEXt, zTXt, iTXt); an eXIf after the image data (cv2
  applies it), one with a JPEG's ``Exif\0\0`` prefix and orientation 6 in
  a text chunk (cv2 applies neither);
* 1x1 and odd sizes, Adam7 images with empty passes;
* two 768x512 RGB photos for timing: PIL's optimized file (the filters its
  optimizer picks: 511 of the 512 rows Paeth) and one every row of which is
  Paeth; the photo as PIL's 256-colour palette PNG (a request body on the
  card);
* files both readers refuse: a CRC mismatch in IDAT, image data cut short,
  image data split by another chunk, an unknown row filter, a palette image
  without PLTE.

``digests.json`` holds, for each decodable file, the sha256 of the pixels
(uint8 RGB, row-major) that ``cv2.imread`` gives (``file``: EXIF
orientation applied) and that ``PIL.Image.open(...).convert("RGB")`` gives
(``body``), with their shapes; for each refused file, the reason the port
gives.  ``tests/test_torch_png.py`` recomputes both from the committed
files.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

REFUSED = {
    "refused_crc_idat.png": "CRC mismatch in PNG chunk b'IDAT'",
    "refused_truncated.png": "truncated image data",
    "refused_split_idat.png": "image data split by another chunk",
    "refused_filter.png": "unknown PNG row filter 7",
    "refused_no_plte.png": "palette PNG without PLTE",
}


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body \
        + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_row(kind: int, cur: np.ndarray, prev: np.ndarray,
               bpp: int) -> bytes:
    """One row of raw bytes, filtered with PNG filter ``kind``."""
    cur, prev = cur.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[:len(cur)]
    upleft = np.concatenate([np.zeros(bpp, np.int64),
                             prev[:-bpp]])[:len(cur)]
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
            4: _paeth(left, prev, upleft)}[kind]
    return bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, ch] integer samples -> [h, stride] raw bytes at ``depth``."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def image_data(samples: np.ndarray, depth: int, color: int, interlace: int,
               filters) -> bytes:
    """The filtered image data of ``samples`` [h, w, ch]; ``filters(pass
    index, row index)`` picks each row's filter."""
    h, w, _ = samples.shape
    bits = CHANNELS[color] * depth
    out = bytearray()
    for p, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = pack_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in range(rows.shape[0]):
            out += filter_row(filters(p, r), rows[r], prev,
                              max(1, bits // 8))
            prev = rows[r]
    return bytes(out)


def write_png(samples: np.ndarray, depth: int, color: int,
              interlace: int = 0, filters=lambda p, r: 4,
              palette: bytes = None, trns: bytes = None, before=(),
              after=(), idat_parts: int = 1) -> bytes:
    """A PNG of integer ``samples`` [h, w, channels of ``color``]; extra
    chunks (kind, body) ``before`` / ``after`` the image data."""
    h, w, _ = samples.shape
    z = zlib.compress(image_data(samples, depth, color, interlace, filters))
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                 color, 0, 0, interlace))
    out += b"".join(chunk(k, b) for k, b in before)
    if palette is not None:
        out += chunk(b"PLTE", palette)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    cut = np.linspace(0, len(z), idat_parts + 1).astype(int)
    out += b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
    out += b"".join(chunk(k, b) for k, b in after)
    return out + chunk(b"IEND", b"")


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


def samples_for(color: int, depth: int, h: int, w: int, seed: int):
    """(samples [h, w, ch], PLTE or None) of a colour type and depth."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    base = synthetic(h, w, seed).astype(np.int64)
    if depth == 16:
        base = base * 257 + rng.integers(0, 256, base.shape)
    elif depth < 8:
        base = base >> (8 - depth)
    if color == 3:
        n = int(rng.integers(2, top + 2))
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes()
        return rng.integers(0, n, (h, w, 1)), pal
    ch = CHANNELS[color]
    s = base[..., :1] if ch <= 2 else base
    if ch in (2, 4):
        s = np.concatenate([s, rng.integers(0, top + 1, (h, w, 1))], -1)
    return s, None


def pil_png(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "PNG", **kw)
    return b.getvalue()


def exif_block(orientation: int) -> bytes:
    """The TIFF structure of an EXIF block holding one orientation tag."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()[6:]  # without the "Exif\0\0" of a JPEG APP1


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    names = {0: "gray", 2: "rgb", 3: "palette", 4: "gray_alpha", 6: "rgba"}
    seed = 0
    for color, depths in DEPTHS.items():
        for depth in depths:
            for interlace in (0, 1):
                seed += 1
                s, pal = samples_for(color, depth, 23, 37, seed)
                cycle = seed % 5
                out[f"{names[color]}_{depth}"
                    f"{'_adam7' if interlace else ''}.png"] = write_png(
                    s, depth, color, interlace,
                    lambda p, r, c=cycle: (r + p + c) % 5, pal)
    photo = synthetic(512, 768, 40, 4.0)
    out["photo_768x512_pil.png"] = pil_png(Image.fromarray(photo),
                                           optimize=True)
    out["photo_768x512_paeth.png"] = write_png(photo, 8, 2)
    out["palette_768x512.png"] = pil_png(Image.fromarray(photo).quantize(
        256), optimize=True)
    small = synthetic(29, 41, 50)
    out["pil_palette.png"] = pil_png(Image.fromarray(small).convert("P"))
    pal = Image.fromarray(small).convert("P")
    pal.info["transparency"] = 3
    out["palette_trns.png"] = pil_png(pal, transparency=3)
    s, _ = samples_for(0, 16, 19, 27, 60)
    out["gray_16_trns.png"] = write_png(s, 16, 0, trns=struct.pack(
        ">H", int(s[0, 0, 0])))
    s, _ = samples_for(2, 8, 19, 27, 61)
    out["rgb_8_trns.png"] = write_png(s, 8, 2, trns=struct.pack(
        ">HHH", *(int(v) for v in s[0, 0])))
    for o in range(1, 9):
        out[f"exif_orientation_{o}.png"] = pil_png(
            Image.fromarray(synthetic(21, 34, 70 + o)),
            exif=exif_block(o))
    s, _ = samples_for(2, 8, 18, 30, 80)
    out["exif_after_idat.png"] = write_png(s, 8, 2, after=[
        (b"eXIf", exif_block(6))])
    # EXIF that cv2 does not apply: an eXIf with a JPEG's "Exif\0\0"
    # prefix (libpng drops it as invalid), and orientation 6 in a text
    # chunk, ImageMagick's "Raw profile type exif"
    out["exif_prefixed.png"] = write_png(s, 8, 2, before=[
        (b"eXIf", b"Exif\0\0" + exif_block(6))])
    tiff = b"Exif\0\0" + exif_block(6)
    profile = f"\nexif\n{len(tiff):8d}\n{tiff.hex()}\n".encode()
    out["exif_in_text_chunk.png"] = write_png(s, 8, 2, before=[
        (b"zTXt", b"Raw profile type exif\0\0" + zlib.compress(profile))])
    text = b"Comment\0ancillary chunks change no pixel"
    out["ancillary.png"] = write_png(s, 8, 2, before=[
        (b"gAMA", struct.pack(">I", 45455)),
        (b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000,
                              60000, 15000, 6000)),
        (b"iCCP", b"profile\0\0" + zlib.compress(b"not a real profile")),
        (b"sBIT", bytes([5, 6, 5])),
        (b"bKGD", struct.pack(">HHH", 10, 200, 30)),
        (b"pHYs", struct.pack(">IIB", 2835, 2835, 1)),
        (b"tIME", struct.pack(">HBBBBB", 2024, 5, 6, 7, 8, 9)),
        (b"tEXt", text),
        (b"zTXt", b"Comment\0\0" + zlib.compress(b"zipped")),
        (b"iTXt", b"Comment\0\0\0en\0\0international")], after=[
        (b"tEXt", b"After\0the image data")], idat_parts=3)
    rng = np.random.default_rng(90)
    frames = [Image.fromarray(synthetic(22, 31, 91 + i)) for i in range(3)]
    out["apng.png"] = pil_png(frames[0], save_all=True,
                              append_images=frames[1:], duration=100)
    out["apng_hidden_default.png"] = pil_png(
        frames[0], save_all=True, append_images=frames[1:], duration=100,
        default_image=True)
    for h, w in ((1, 1), (1, 9), (7, 1), (3, 5), (9, 13)):
        for interlace in (0, 1):
            s = rng.integers(0, 256, (h, w, 3))
            out[f"size_{h}x{w}{'_adam7' if interlace else ''}.png"] = \
                write_png(s, 8, 2, interlace, lambda p, r: (p + r) % 5)
    s, pal = samples_for(2, 8, 12, 16, 100)
    good = write_png(s, 8, 2)
    i = good.index(b"IDAT")
    bad = bytearray(good)
    bad[i + 8] ^= 0xFF  # a byte of IDAT, its CRC left as it was
    out["refused_crc_idat.png"] = bytes(bad)
    z = zlib.compress(image_data(s, 8, 2, 0, lambda p, r: 1))
    ihdr = chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 12, 8, 2, 0, 0, 0))
    out["refused_truncated.png"] = SIGNATURE + ihdr + chunk(
        b"IDAT", zlib.compress(zlib.decompress(z)[:-40])) + \
        chunk(b"IEND", b"")
    out["refused_split_idat.png"] = SIGNATURE + ihdr + chunk(
        b"IDAT", z[:20]) + chunk(b"tEXt", b"a\0b") + chunk(
        b"IDAT", z[20:]) + chunk(b"IEND", b"")
    raw = bytearray(zlib.decompress(z))
    raw[(16 * 3 + 1) * 5] = 7  # row 5's filter byte
    out["refused_filter.png"] = SIGNATURE + ihdr + chunk(
        b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")
    idx, _ = samples_for(3, 8, 12, 16, 101)
    out["refused_no_plte.png"] = write_png(idx, 8, 3)
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


def main() -> None:
    digests = {}
    for name, data in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        digests[name] = ({"raises": REFUSED[name]} if name in REFUSED
                         else oracle_digests(path))
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
