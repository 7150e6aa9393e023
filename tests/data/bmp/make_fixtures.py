"""Make the BMP fixtures of this folder and their ``digests.json``.

    python tests/data/bmp/make_fixtures.py

Seeded synthetic images, one file per variant the port's BMP reader
(``crdr_tpu_torch/utils/bmp.py``) is held to: what cv2 and PIL write (cv2's
24-bit and its 8-bit gray palette, PIL's 1-bit, gray, palette and RGB), and
by hand (``write_bmp`` below): 1-, 4- and 8-bit palettes bottom-up and
top-down, a palette shorter than the indexes, RLE8 and RLE4 (runs, absolute
runs, end of line, end of bitmap, and a delta, which cv2 and PIL read
differently), 16-bit 555 and 565 / 555 bitfields (cv2 shifts the fields
up, PIL scales them), 32-bit with bitfields, the 12-byte OS/2 core header,
V4 and V5 headers, and odd sizes.

``digests.json`` holds, for each file, the sha256 of the pixels (uint8 RGB,
row-major) that ``cv2.imread`` gives (``file``) and that
``PIL.Image.open(...).convert("RGB")`` gives (``body``), with their shapes.
``tests/test_torch_bmp.py`` recomputes both from the committed files.
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


def pack_rows(values: np.ndarray, bpp: int) -> np.ndarray:
    """[h, w] indexes (bpp <= 8) or [h, w * bytes] bytes -> rows padded to
    4 bytes."""
    v = values.astype(np.uint8)
    if bpp < 8:
        bits = ((v[..., None] >> np.arange(bpp - 1, -1, -1)) & 1).reshape(
            v.shape[0], -1).astype(np.uint8)
        v = np.packbits(bits, axis=1)
    pad = -v.shape[1] % 4
    return np.concatenate([v, np.zeros((v.shape[0], pad), np.uint8)], 1)


def write_bmp(w: int, h: int, bpp: int, pixels: bytes, comp: int = 0,
              palette: bytes = b"", hsize: int = 40, masks=None,
              colors: int = 0, top_down: bool = False) -> bytes:
    """A BMP of already laid-out ``pixels`` (rows in file order)."""
    if hsize == 12:
        header = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        header = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h,
                             1, bpp, comp, len(pixels), 2835, 2835, colors, 0)
        if masks is not None:
            header += struct.pack(f"<{len(masks)}I", *masks)
        header += bytes(max(0, hsize - len(header)))
    offset = 14 + len(header) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + header + palette + pixels)


def rle_row(row: np.ndarray, rle4: bool, rng) -> bytes:
    """One row of indexes -> RLE8 / RLE4 runs and absolute runs of random
    lengths (no end of line)."""
    out = bytearray()
    x, w = 0, len(row)
    while x < w:
        n = int(min(w - x, rng.integers(1, 12)))
        if n >= 3 and rng.random() < 0.5:  # absolute
            px = [int(v) for v in row[x:x + n]]
            if rle4:
                px += [0] * (n % 2)
                body = bytes(px[i] << 4 | px[i + 1]
                             for i in range(0, len(px), 2))
            else:
                body = bytes(px)
            out += bytes([0, n]) + body + bytes(len(body) % 2)
        else:  # a run of the first pixel (RLE4: of its pair)
            a = int(row[x])
            b = int(row[x + 1]) if rle4 and x + 1 < w else a
            out += bytes([n, (a << 4 | b) if rle4 else a])
        x += n
    return bytes(out)


def rle_encode(idx: np.ndarray, rle4: bool, rng) -> bytes:
    """[h, w] indexes -> an RLE stream (bottom row first), an end of line
    after every row, an end of bitmap."""
    return b"".join(rle_row(row, rle4, rng) + b"\0\0"
                    for row in idx[::-1]) + b"\0\1"


def synthetic(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.05, 0.4, 3)
    img = np.stack([128 + 100 * np.sin(f[0] * xx), 128 + 90 * np.cos(f[1] * yy),
                    128 + 80 * np.sin(f[2] * (xx + yy))], -1)
    img += rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def palette_image(bpp: int, h: int, w: int, seed: int, entry: int = 4,
                  n: int = 0):
    """(indexes [h, w], palette bytes) of ``n`` (default 2^bpp) colours."""
    rng = np.random.default_rng(seed)
    n = n or 1 << bpp
    pal = rng.integers(0, 256, (n, entry), dtype=np.uint8)
    if entry == 4:
        pal[:, 3] = 0
    return rng.integers(0, 1 << bpp, (h, w)).astype(np.uint8), pal.tobytes()


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    img = synthetic(23, 37, 1)
    ok, buf = cv2.imencode(".bmp", img[..., ::-1])
    out["cv2_rgb.bmp"] = buf.tobytes()
    ok, buf = cv2.imencode(".bmp", img[..., 1])
    out["cv2_gray.bmp"] = buf.tobytes()
    for mode in ("1", "L", "P", "RGB"):
        b = io.BytesIO()
        pil = Image.fromarray(synthetic(19, 29, 2))
        (pil.convert(mode) if mode != "P" else pil.quantize(37)).save(b,
                                                                      "BMP")
        out[f"pil_{mode.lower()}.bmp"] = b.getvalue()
    seed = 10
    for bpp in (1, 4, 8):
        for top_down in (False, True):
            seed += 1
            idx, pal = palette_image(bpp, 13, 21, seed)
            rows = pack_rows(idx if top_down else idx[::-1], bpp)
            out[f"pal{bpp}{'_topdown' if top_down else ''}.bmp"] = \
                write_bmp(21, 13, bpp, rows.tobytes(), palette=pal,
                          top_down=top_down)
    idx, pal = palette_image(8, 9, 14, 20, n=5)
    out["pal8_short_palette.bmp"] = write_bmp(
        14, 9, 8, pack_rows(idx[::-1], 8).tobytes(), palette=pal, colors=5)
    rng = np.random.default_rng(30)
    for bpp, comp in ((8, 1), (4, 2)):
        idx, pal = palette_image(bpp, 17, 26, 31 + bpp)
        idx = np.repeat(idx[:, ::3], 3, axis=1)[:, :26]  # runs to encode
        out[f"rle{bpp}.bmp"] = write_bmp(26, 17, bpp, rle_encode(
            idx, bpp == 4, rng), comp, pal)
        # a delta (3 right, 1 up) after the bottom row, then the rest of
        # the third row: cv2 skips the pixels with palette entry 0, PIL
        # reads its offsets from the two bytes after them
        rows = idx[::-1]
        stream = (rle_row(rows[0], bpp == 4, rng) + b"\0\0\0\2\3\1"
                  + rle_row(rows[2][3:], bpp == 4, rng) + b"\0\0"
                  + rle_encode(rows[3:][::-1], bpp == 4, rng))
        out[f"rle{bpp}_delta.bmp"] = write_bmp(26, 17, bpp, stream, comp,
                                               pal)
    v = np.random.default_rng(40).integers(0, 1 << 16, (11, 15)).astype(
        "<u2")
    rows = pack_rows(v[::-1].view(np.uint8).reshape(11, -1), 8).tobytes()
    out["rgb16_555.bmp"] = write_bmp(15, 11, 16, rows)
    out["rgb16_565_bitfields.bmp"] = write_bmp(
        15, 11, 16, rows, 3, masks=(0xF800, 0x7E0, 0x1F))
    out["rgb16_555_bitfields.bmp"] = write_bmp(
        15, 11, 16, rows, 3, masks=(0x7C00, 0x3E0, 0x1F))
    px = np.random.default_rng(41).integers(0, 256, (12, 17, 4),
                                            dtype=np.uint8)
    rows32 = px[::-1].tobytes()
    out["rgb32.bmp"] = write_bmp(17, 12, 32, rows32)
    out["rgb32_bitfields.bmp"] = write_bmp(
        17, 12, 32, rows32, 3, masks=(0xFF0000, 0xFF00, 0xFF))
    out["rgb32_v5_rgba_bitfields.bmp"] = write_bmp(
        17, 12, 32, rows32, 3, hsize=124,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out["rgb32_v5_topdown.bmp"] = write_bmp(17, 12, 32, px.tobytes(),
                                            hsize=124, top_down=True)
    img = synthetic(14, 19, 50)
    out["os2_rgb24.bmp"] = write_bmp(19, 14, 24, pack_rows(
        img[::-1, :, ::-1].reshape(14, -1), 8).tobytes(), hsize=12)
    idx, pal = palette_image(8, 14, 19, 51, entry=3)
    out["os2_pal8.bmp"] = write_bmp(19, 14, 8, pack_rows(
        idx[::-1], 8).tobytes(), palette=pal, hsize=12)
    out["v4_rgb24.bmp"] = write_bmp(19, 14, 24, pack_rows(
        img[::-1, :, ::-1].reshape(14, -1), 8).tobytes(), hsize=108)
    for h, w in ((1, 1), (1, 7), (5, 1), (7, 13)):
        one = synthetic(h, w, 60 + w)
        ok, buf = cv2.imencode(".bmp", one[..., ::-1])
        out[f"size_{h}x{w}.bmp"] = buf.tobytes()
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
        digests[name] = oracle_digests(path)
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
