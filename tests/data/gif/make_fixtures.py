"""Make the GIF fixtures of this folder and their ``digests.json``.

    python tests/data/gif/make_fixtures.py

Seeded synthetic images, one file per variant the port's GIF reader
(``crdr_tpu_torch/utils/gif.py``, ``runtime/csrc/lzw.cpp``) is held to:
what PIL writes (GIF87a and GIF89a, interlaced or not, a transparency
index, grayscale, a 1-bit image, an animation) and, by hand
(``write_gif`` below, with its own LZW encoder): a local palette beside a
global one, a first frame smaller than the screen at an offset (with and
without a transparency index), a frame past the screen, no palette at all,
a gray-ramp palette, indexes past a short palette, minimum code sizes 2
and 8, a stream without a leading clear code, a table that fills and stays
full (the deferred clear), an interlaced frame of 5 rows; and refusals (an
end code before the last row, a truncated file, a corrupt code, no image).
One 768x512 file times the decoder: ``synthetic_images(1, 512, 768, 25)``
of ``crdr_tpu_torch/cli/serve_smoke.py`` quantized by PIL to 256 colours.

``digests.json`` holds, for each file, the sha256 of the pixels (uint8 RGB,
row-major) that ``PIL.Image.open(...).convert("RGB")`` gives (``body``)
and their shape; for a file PIL refuses, the port's reason (``refused``)
and PIL's message (``pil``).  ``cv2`` records what ``cv2.imread`` gives a
file of the same bytes, for the record (the port's file path refuses GIF).
``tests/test_torch_gif.py`` recomputes PIL's.
"""

import hashlib
import io
import json
import os
import re
import struct

import sys

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

REFUSED = {"refused_early_end_code.gif": "end code before",
           "refused_truncated.gif": "truncated GIF image data",
           "refused_bad_code.gif": "corrupt GIF LZW data",
           "refused_no_image.gif": "no image in the GIF"}


def lzw_encode(idx, bits: int, clear_first: bool = True,
               defer_clear: bool = False, end_at=None) -> bytes:
    """GIF LZW of the indexes ``idx`` (LSB first).  ``defer_clear``: a
    full table is kept, not cleared; ``end_at``: an end code after that
    many indexes."""
    idx = [int(v) for v in np.asarray(idx).ravel()]
    if end_at is not None:
        idx = idx[:end_at]
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0
    size = bits + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        return {(i,): i for i in range(clear)}, clear + 2

    table, nxt = reset()
    if clear_first:
        put(clear)
    cur = ()
    for v in idx:
        s = cur + (v,)
        if s in table:
            cur = s
            continue
        put(table[cur])
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt == (1 << size) + 1 and size < 12:
                size += 1
        elif not defer_clear:
            put(clear)
            table, nxt = reset()
            size = bits + 1
        cur = (v,)
    if cur:
        put(table[cur])
        if nxt < 4096:
            nxt += 1
            if nxt == (1 << size) + 1 and size < 12:
                size += 1
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def palette_bytes(colors: np.ndarray) -> tuple:
    """(flag bits, table bytes) of a palette padded to a power of 2."""
    n = max(2, len(colors))
    bits = (n - 1).bit_length()
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(colors)] = colors
    return bits, table.tobytes()


def write_gif(screen, frame_box, idx, bits: int, global_pal=None,
              local_pal=None, transparency=None, interlace=False,
              version=b"GIF89a", lzw=None) -> bytes:
    """A one-frame GIF; ``idx`` in the frame's row order."""
    sw, sh = screen
    flags, gtable = 0, b""
    if global_pal is not None:
        gbits, gtable = palette_bytes(global_pal)
        flags = 0x80 | (gbits - 1)
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gtable
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    x, y, w, h = frame_box
    fflags, ltable = (0x40 if interlace else 0), b""
    if local_pal is not None:
        lbits, ltable = palette_bytes(local_pal)
        fflags |= 0x80 | (lbits - 1)
    out += b"," + struct.pack("<HHHHB", x, y, w, h, fflags) + ltable
    data = lzw if lzw is not None else lzw_encode(idx, bits)
    return out + bytes([bits]) + sub_blocks(data) + b";"


def interlaced(rows: np.ndarray) -> np.ndarray:
    order = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
             for r in range(start, len(rows), step)]
    return rows[order]


def image(h: int, w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx // 3 + yy // 2) % n
    noise = rng.random((h, w)) < 0.1
    return np.where(noise, rng.integers(0, n, (h, w)), base).astype(np.uint8)


def colors(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3),
                                                dtype=np.uint8)


def pil_gif(im: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, "GIF", **kw)
    return b.getvalue()


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    rgb = np.stack([image(33, 41, 200, 1) * 1, image(33, 41, 150, 2),
                    image(33, 41, 90, 3)], -1).astype(np.uint8)
    pal = Image.fromarray(rgb).quantize(64)
    out["pil_87a.gif"] = pil_gif(pal, interlace=False)
    out["pil_89a_interlaced.gif"] = pil_gif(pal, interlace=True,
                                            transparency=5)
    out["pil_gray.gif"] = pil_gif(Image.fromarray(image(21, 30, 256, 4)))
    out["pil_1bit.gif"] = pil_gif(Image.fromarray(image(19, 23, 2, 5) * 255)
                                  .convert("1"))
    frames = [Image.fromarray(np.roll(rgb, 7 * s, 1)).quantize(32)
              for s in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "GIF", save_all=True, append_images=frames[1:],
                   duration=50)
    out["pil_animated.gif"] = b.getvalue()
    idx = image(14, 18, 16, 6)
    out["local_palette.gif"] = write_gif((18, 14), (0, 0, 18, 14), idx, 4,
                                         colors(16, 7), colors(16, 8))
    out["offset_frame.gif"] = write_gif((30, 25), (7, 5, 18, 14), idx, 4,
                                        colors(16, 9))
    out["offset_frame_transparency.gif"] = write_gif(
        (30, 25), (7, 5, 18, 14), idx, 4, colors(16, 10), transparency=3)
    out["frame_past_screen.gif"] = write_gif((12, 10), (4, 3, 18, 14), idx,
                                             4, colors(16, 11))
    out["no_palette.gif"] = write_gif((18, 14), (0, 0, 18, 14), idx * 13, 8)
    ramp = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)
    out["gray_ramp_palette.gif"] = write_gif((18, 14), (0, 0, 18, 14), idx,
                                             4, ramp)
    out["short_palette.gif"] = write_gif((18, 14), (0, 0, 18, 14), idx, 4,
                                         colors(4, 12))
    idx2 = image(9, 11, 4, 13)
    out["code_size_2.gif"] = write_gif((11, 9), (0, 0, 11, 9), idx2, 2,
                                       colors(4, 14), version=b"GIF87a")
    out["code_size_8.gif"] = write_gif((18, 14), (0, 0, 18, 14), idx * 15,
                                       8, colors(256, 15))
    out["no_leading_clear.gif"] = write_gif(
        (18, 14), (0, 0, 18, 14), idx, 4, colors(16, 16),
        lzw=lzw_encode(idx, 4, clear_first=False))
    big = np.random.default_rng(17).integers(0, 4, (140, 144))
    out["deferred_clear.gif"] = write_gif(  # ~4300 codes: the table fills
        (144, 140), (0, 0, 144, 140), big, 2, colors(4, 18),
        lzw=lzw_encode(big, 2, defer_clear=True))
    rows5 = image(5, 9, 16, 19)
    out["interlaced_5_rows.gif"] = write_gif(
        (9, 5), (0, 0, 9, 5), interlaced(rows5), 4, colors(16, 20),
        interlace=True)
    out["refused_early_end_code.gif"] = write_gif(
        (18, 14), (0, 0, 18, 14), idx, 4, colors(16, 21),
        lzw=lzw_encode(idx, 4, end_at=100))
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images

    out["photo_768x512.gif"] = pil_gif(Image.fromarray(
        synthetic_images(1, 512, 768, 25)[0]).quantize(256))
    good = out["local_palette.gif"]
    out["refused_truncated.gif"] = good[:len(good) - 40]
    bad = bytearray(write_gif((18, 14), (0, 0, 18, 14), idx, 4,
                              colors(16, 22)))
    at = bad.index(b",") + 10 + 48 + 2  # the LZW data's first bytes
    bad[at] = 0xFF
    bad[at + 1] = 0xFF
    out["refused_bad_code.gif"] = bytes(bad)
    out["refused_no_image.gif"] = good[:good.index(b",")] + b";"
    return out


def pil_message(e: Exception) -> str:
    """PIL's error message without the reprs of its objects."""
    return re.sub(r" <[^>]*>", "", str(e))


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def cv2_record(path: str):
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if bgr is None else sha(bgr[..., ::-1])


def pil_digests(data: bytes) -> dict:
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return {"body": sha(rgb), "body_shape": list(rgb.shape)}


def write(here: str, files: dict, refused: dict, digest) -> None:
    """Write ``files`` and their ``digests.json`` into ``here``."""
    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(here, name)
        with open(path, "wb") as f:
            f.write(data)
        if name in refused:
            try:
                digest(data)
            except Exception as e:  # noqa: BLE001 - PIL raises several types
                entry = {"refused": refused[name], "pil": pil_message(e)}
            else:
                raise AssertionError(f"PIL reads {name}")
        else:
            entry = digest(data)
        entry["cv2"] = cv2_record(path)
        digests[name] = entry
    with open(os.path.join(here, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    write(HERE, fixtures(), REFUSED, pil_digests)
