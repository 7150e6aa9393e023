"""Make the Sun raster fixtures of this folder and their ``digests.json``.

    python tests/data/sunras/make_fixtures.py

Neither PIL nor cv2 writes the variants the port's reader
(``crdr_tpu_torch/utils/sunras.py``, ``runtime/csrc/rle.cpp``) is held
to, so ``sun`` writes them from seeded images: depths 1, 4, 8, 24 and 32;
types 0 (old), 1 (standard), 2 (run-length: runs, literal 0x80 bytes,
runs across rows), 3 (RGB), 4 and 5; no colour map, a full one, a short
one and one whose length is not a multiple of 3; odd widths (rows padded
to 16 bits); data past the image.  A 768x512 8-bit run-length file with a
64-colour map times the decoder (``synthetic_images(1, 512, 768, 25)`` of
``crdr_tpu_torch/cli/serve_smoke.py``, quantised by PIL).  Refusals: a
truncated file (each type), depth 16, type 6, colour map type 2, a map of
more than 768 bytes, a map on depth 1, 24 or 32, a run-length file cut in
a run, a width of 0, and a file one pixel wide that PIL takes for a GIMP
brush.

``digests.json`` is written by ``tests/data/jpeg2000/make_fixtures.py``'s
``write`` (cv2's and PIL's digests or their refusals, with the port's
reasons); ``tests/test_torch_sunras.py`` recomputes them.
"""

import importlib.util
import os
import struct
import sys

import numpy as np

from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_fixtures", os.path.join(os.path.dirname(HERE), "jpeg2000",
                                      "make_fixtures.py"))
_j2k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_j2k)
write = _j2k.write

CV2 = "cv2.imread returns None"
# the port's reasons where cv2.imread returns None (set in fixtures())
FILE_REFUSED = {}
# the port's reason where PIL raises
BODY_REFUSED = {"refused_depth_16.ras": "PIL does not read it",
                "refused_type_6.ras": "PIL does not read it",
                "refused_maptype_2.ras": "PIL does not read it",
                "refused_map_1024.ras": "PIL does not read it",
                "map_depth_1.ras": "PIL does not read it",
                "refused_map_depth_24.ras": "PIL does not read it",
                "refused_map_depth_32.ras": "PIL does not read it",
                "refused_width_0.ras": "of 0x",
                "gimp_brush_width_1.ras": "GIMP brush",
                "size_1x1_depth_24.ras": "GIMP brush",
                "refused_rle_cut_in_run.ras": "truncated Sun raster",
                "refused_truncated_type_1.ras": "truncated Sun raster",
                "refused_truncated_type_2.ras": "truncated Sun raster"}


def rle(raw: bytes) -> bytes:
    """Sun's byte encoding: 0x80 n v for n + 1 copies of v (3 or more, or
    any 0x80), 0x80 0x00 for one 0x80, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and raw[j] == raw[i] and j - i < 256:
            j += 1
        n = j - i
        if raw[i] == 0x80 and n <= 2:
            out += b"\x80\x00" * n
        elif n >= 3:
            out += bytes([0x80, n - 1, raw[i]])
        else:
            out += raw[i:j]
        i = j
    return bytes(out)


def sun(img: np.ndarray, depth: int, kind: int = 1, cmap: bytes = b"",
        maptype=None, length=None, pad=None) -> bytes:
    """A Sun raster of ``img`` ([h, w] samples for depths 1-8, [h, w, 3 or
    4] bytes in file order for 24 / 32); rows padded to 16 bits unless
    run-length coded (type 2)."""
    h, w = img.shape[:2]
    if depth == 1:
        rows = np.packbits(img.astype(np.uint8), axis=1)
    elif depth == 4:
        v = np.zeros((h, w + (w & 1)), np.uint8)
        v[:, :w] = img
        rows = (v[:, 0::2] << 4) | v[:, 1::2]
    else:
        rows = img.reshape(h, -1).astype(np.uint8)
    pad = kind != 2 if pad is None else pad
    stride = ((w * depth + 15) // 16) * 2 if pad else (w * depth + 7) // 8
    data = np.zeros((h, stride), np.uint8)
    data[:, :rows.shape[1]] = rows
    data = data.tobytes()
    if kind == 2:
        data = rle(data)
    mt = (1 if cmap else 0) if maptype is None else maptype
    head = struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(data) if length is None else length, kind, mt,
                       len(cmap))
    return head + cmap + data


def image(h: int, w: int, seed: int, levels: int = 256) -> np.ndarray:
    """Samples with runs, noise and some 0x80 bytes: uint8 [h, w]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    v = (xx // 5 * 37 + yy * 11) % levels
    noise = rng.random((h, w)) < 0.3
    v[noise] = rng.integers(0, levels, noise.sum())
    if levels == 256:
        v[(xx + yy) % 13 == 0] = 0x80
    return v.astype(np.uint8)


def colour(h: int, w: int, c: int, seed: int) -> np.ndarray:
    return np.stack([image(h, w, seed + k) for k in range(c)], -1)


def cmap(n: int, seed: int) -> bytes:
    """n colours: their reds, greens, then blues."""
    return np.random.default_rng(seed).integers(0, 256, 3 * n,
                                                np.uint8).tobytes()


def fixtures() -> dict:
    """{file name: bytes}."""
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    out = {}
    for kind in (0, 1, 2, 3):
        out[f"depth_1_type_{kind}.ras"] = sun(image(9, 13, 1, 2), 1, kind)
        out[f"depth_4_type_{kind}.ras"] = sun(image(9, 13, 2, 16), 4, kind)
        out[f"depth_8_type_{kind}.ras"] = sun(image(9, 13, 3), 8, kind)
        out[f"depth_8_map_type_{kind}.ras"] = sun(image(9, 13, 4), 8, kind,
                                                  cmap(256, 5))
        out[f"depth_24_type_{kind}.ras"] = sun(colour(9, 13, 3, 6), 24, kind)
        out[f"depth_32_type_{kind}.ras"] = sun(colour(9, 13, 4, 7), 32, kind)
    for kind in (4, 5):
        out[f"depth_24_type_{kind}.ras"] = sun(colour(5, 6, 3, 8), 24, kind)
    out["depth_4_map.ras"] = sun(image(6, 11, 11, 16), 4, 1, cmap(16, 12))
    out["depth_8_short_map.ras"] = sun(image(7, 10, 13), 8, 1, cmap(10, 14))
    out["depth_8_map_31_bytes.ras"] = sun(image(7, 10, 15), 8, 1,
                                          cmap(10, 16) + b"\x07")
    out["depth_8_maptype_1_no_map.ras"] = sun(image(7, 10, 17), 8, 1,
                                              maptype=1)
    out["depth_8_rle_padded_rows.ras"] = sun(image(7, 11, 18), 8, 2,
                                             pad=True)
    out["depth_8_rle_long_runs.ras"] = sun(np.full((6, 300), 0x80,
                                                   np.uint8), 8, 2)
    out["depth_24_data_past_image.ras"] = sun(colour(4, 5, 3, 19), 24, 1) \
        + b"\x01\x02\x03"
    out["size_1x1_depth_24.ras"] = sun(colour(1, 1, 3, 20), 24, 1)
    out["size_3x1_depth_1.ras"] = sun(image(1, 3, 21, 2), 1, 1)
    q = Image.fromarray(synthetic_images(1, 512, 768, 25)[0]).quantize(64)
    pal = np.array(q.getpalette()[:192], np.uint8).reshape(64, 3)
    out["photo_768x512_rle.ras"] = sun(np.asarray(q), 8, 2, pal.T.tobytes())
    # refused by one oracle or both
    out["refused_depth_16.ras"] = sun(colour(3, 4, 2, 22), 16, 1)
    out["refused_type_6.ras"] = sun(image(3, 4, 23), 8, 6)
    out["refused_maptype_2.ras"] = sun(image(3, 4, 24), 8, 1, cmap(4, 25),
                                       maptype=2)
    out["refused_map_1024.ras"] = sun(image(3, 4, 26), 8, 1,
                                      cmap(341, 27) + b"\0")
    out["map_depth_1.ras"] = sun(image(3, 9, 28, 2), 1, 1, cmap(2, 29))
    out["refused_map_depth_24.ras"] = sun(colour(3, 4, 3, 30), 24, 1,
                                          cmap(4, 31))
    out["refused_map_depth_32.ras"] = sun(colour(3, 4, 4, 32), 32, 1,
                                          cmap(4, 33))
    out["refused_width_0.ras"] = struct.pack(">8I", 0x59A66A95, 0, 3, 8, 0,
                                             1, 0, 0)
    out["gimp_brush_width_1.ras"] = sun(image(5, 1, 34), 8, 1, length=4)
    run = sun(np.full((4, 20), 9, np.uint8), 8, 2)
    out["refused_rle_cut_in_run.ras"] = run[:-1]
    out["refused_truncated_type_1.ras"] = sun(image(5, 7, 35), 8, 1)[:-5]
    out["refused_truncated_type_2.ras"] = sun(image(5, 7, 36), 8, 2)[:-2]
    out["last_row_unpadded.ras"] = sun(image(5, 7, 37), 8, 1)[:-1]
    for name in out:  # OpenCV 5 reads types 0 and 1 only, and not these
        if name.startswith(("refused_", "depth_4_")) or any(
                f"type_{k}" in name for k in (2, 3, 4, 5)) or "rle" in name \
                or name in ("last_row_unpadded.ras",
                            "depth_8_maptype_1_no_map.ras"):
            FILE_REFUSED[name] = "of 0x" if "width_0" in name else CV2
    return out


if __name__ == "__main__":
    write(HERE, fixtures(), FILE_REFUSED, BODY_REFUSED)
