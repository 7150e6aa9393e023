"""Make the WebP fixtures of this folder and their ``digests.json``.

    python tests/data/webp/make_fixtures.py

Seeded synthetic images written by PIL (libwebp's encoder), one file per
variant the port's WebP reader (``crdr_tpu_torch/utils/webp.py``,
``runtime/csrc/webp.cpp``) is held to: lossy at three qualities and three
``method``s, lossless at ``method`` 0 / 4 / 6 and with 2-, 4- and
16-colour palettes (pixel bundling of 8, 4 and 2 at widths that are not a
multiple of the bundle), lossy and lossless with alpha at
``alpha_quality`` 100 and 50, an animation, 1x1, 1x7, 7x1 and odd sizes;
by hand, an animation whose first frame is smaller than its canvas and
lies at an offset, and a raw (uncompressed) ``ALPH`` chunk with the
gradient filter (PIL's encoder writes neither); and refusals (a truncated file, a VP8 inter frame, an
ALPH chunk beside a VP8L image).  Two 768x512 files time the decoder:
``synthetic_images(1, 512, 768, 25)`` of ``crdr_tpu_torch/cli/serve_smoke.py``
as lossy (quality 80) and lossless WebP; the lossless one decodes to those
pixels exactly.

``digests.json`` holds, for each file, the sha256 of the pixels (uint8 RGB,
row-major) that ``PIL.Image.open(...).convert("RGB")`` gives (``body``),
their shape, and the sha256 of PIL's RGBA (``rgba``, which holds the
decoded alpha); for a file PIL refuses, the port's reason (``refused``)
and PIL's message (``pil``).  ``cv2`` records what ``cv2.imread`` gives a
file of the same bytes, for the record (the port's file path refuses
WebP).  ``tests/test_torch_webp.py`` recomputes PIL's.
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

# files PIL refuses: the port's reason
REFUSED = {"refused_truncated.webp": "truncated WebP",
           "refused_inter_frame.webp": "inter frame",
           "refused_alph_with_vp8l.webp": "ALPH chunk beside a VP8L"}


def synthetic(h: int, w: int, seed: int, noise: float = 6.0) -> np.ndarray:
    """Smooth waves, an edge and a little noise: uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.05, 0.4, 4)
    img = np.stack([128 + 90 * np.sin(f[0] * xx + f[1] * yy),
                    128 + 80 * np.cos(f[2] * yy + 1.0),
                    128 + 70 * np.sin(f[3] * (xx + yy))], -1)
    img[: h // 2, : w // 3] += 40
    img += rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def alpha(h: int, w: int, seed: int) -> np.ndarray:
    """A ramp with a transparent hole and a few partial values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = (255 * xx / max(w - 1, 1)).astype(np.uint8)
    a[h // 4: h // 2, w // 4: w // 2] = 0
    a[rng.random((h, w)) < 0.05] = 255
    return a


def palette_image(h: int, w: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return colors[(xx // 3 + yy // 2 + (xx * yy) % 3) % n]


def webp(img: np.ndarray, **kw) -> bytes:
    mode = "RGBA" if img.shape[-1] == 4 else "RGB"
    b = io.BytesIO()
    Image.fromarray(img, mode).save(b, "WEBP", **kw)
    return b.getvalue()


def chunk(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


def riff(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def first_chunk(data: bytes):
    """(fourcc, payload) of a simple WebP's image chunk."""
    size = struct.unpack_from("<I", data, 16)[0]
    return data[12:16], data[20:20 + size]


def gradient_filtered(a: np.ndarray) -> bytes:
    """ALPH's gradient filter: each value less its prediction, clip(left +
    top - top-left) (the left one on the first row, the top one in the
    first column)."""
    a = a.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8).tobytes()


def u24(v: int) -> bytes:
    return v.to_bytes(3, "little")


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    img = synthetic(37, 53, 1)
    for q, m in ((10, 4), (50, 4), (95, 4), (50, 0), (50, 6)):
        out[f"lossy_q{q}_m{m}.webp"] = webp(img, quality=q, method=m)
    out["lossy_noisy_q80.webp"] = webp(synthetic(40, 40, 2, 40.0),
                                       quality=80, method=4)
    for m in (0, 4, 6):
        out[f"lossless_m{m}.webp"] = webp(synthetic(29, 31, 3, 2.0),
                                          lossless=True, method=m)
    for n, w in ((2, 13), (4, 15), (16, 17)):
        out[f"lossless_palette{n}.webp"] = webp(
            palette_image(11, w, n, 4 + n), lossless=True, method=4)
    rgba = np.concatenate([synthetic(23, 29, 5), alpha(23, 29, 5)[..., None]],
                          -1)
    for aq in (100, 50):
        out[f"alpha_lossy_aq{aq}.webp"] = webp(rgba, quality=70,
                                               alpha_quality=aq)
        out[f"alpha_lossless_aq{aq}.webp"] = webp(rgba, lossless=True,
                                                  alpha_quality=aq)
    out["alpha_lossy_exact.webp"] = webp(rgba, quality=70, exact=True)
    for h, w in ((1, 1), (1, 7), (7, 1), (13, 9), (17, 33)):
        out[f"size_{h}x{w}.webp"] = webp(synthetic(h, w, 6 + h + w),
                                         quality=80)
        out[f"size_{h}x{w}_lossless.webp"] = webp(synthetic(h, w, 7 + h),
                                                  lossless=True)
    frames = [Image.fromarray(synthetic(24, 32, 20 + s)) for s in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:],
                   duration=40, quality=70)
    out["animated.webp"] = b.getvalue()
    # by hand: a first frame of 12x10 at (6, 4) on a 26x20 canvas
    kind, image = first_chunk(webp(synthetic(10, 12, 30), lossless=True))
    anmf = (u24(3) + u24(2) + u24(11) + u24(9) + u24(100) + b"\x00"
            + chunk(kind, image))
    vp8x = bytes([0x02, 0, 0, 0]) + u24(25) + u24(19)
    anim = struct.pack("<IH", 0xFF336699, 0)
    out["anim_offset_frame.webp"] = riff(chunk(b"VP8X", vp8x)
                                         + chunk(b"ANIM", anim)
                                         + chunk(b"ANMF", anmf))
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images

    photo = synthetic_images(1, 512, 768, 25)[0]
    out["photo_768x512_lossy.webp"] = webp(photo, quality=80)
    out["photo_768x512_lossless.webp"] = webp(photo, lossless=True)
    kind, image = first_chunk(webp(synthetic(23, 29, 31), quality=70))
    vp8x = bytes([0x10, 0, 0, 0]) + u24(28) + u24(22)
    alph = bytes([0x0C]) + gradient_filtered(alpha(23, 29, 32))  # raw, 3
    out["alpha_raw_gradient.webp"] = riff(chunk(b"VP8X", vp8x)
                                          + chunk(b"ALPH", alph)
                                          + chunk(kind, image))
    good = out["lossy_q50_m4.webp"]
    out["refused_truncated.webp"] = good[:len(good) // 2]
    kind, image = first_chunk(good)
    inter = bytes([image[0] | 1]) + image[1:]  # the frame tag's inter bit
    out["refused_inter_frame.webp"] = riff(chunk(b"VP8 ", inter))
    kind, image = first_chunk(out["lossless_m4.webp"])
    vp8x = bytes([0x10, 0, 0, 0]) + u24(30) + u24(28)
    out["refused_alph_with_vp8l.webp"] = riff(
        chunk(b"VP8X", vp8x) + chunk(b"ALPH", b"\x00" + bytes(31 * 29))
        + chunk(kind, image))
    return out


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def cv2_record(path: str):
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if bgr is None else sha(bgr[..., ::-1])


def pil_digests(data: bytes) -> dict:
    im = Image.open(io.BytesIO(data))
    rgb = np.asarray(im.convert("RGB"))
    return {"body": sha(rgb), "body_shape": list(rgb.shape),
            "rgba": sha(np.asarray(im.convert("RGBA")))}


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
                entry = {"refused": refused[name], "pil": str(e)}
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
