"""Make the PNM fixtures of this folder and their ``digests.json``.

    python tests/data/pnm/make_fixtures.py

Seeded synthetic images, one file per variant the port's PNM reader
(``crdr_tpu_torch/utils/pnm.py``) is held to: P1 to P6 as PIL writes the
raw ones and by hand, maxval 1, 15, 255 and 65535 (and 1000), comments and
odd whitespace in the header (a comment inside a token, CR line ends),
comments in plain data, rows of P4 that are not whole bytes, PFM's gray
``Pf`` in both byte orders; and refusals (a truncated file, a sample past
the maxval, a maxval of 0, a P1 byte that is not 0 or 1, a token past 10
bytes, PFM's colour ``PF``).

``digests.json`` holds, for each file, the sha256 of the pixels (uint8 RGB,
row-major) that ``PIL.Image.open(...).convert("RGB")`` gives (``body``)
and their shape; for a file PIL refuses, the port's reason (``refused``)
and PIL's message (``pil``).  ``cv2`` records what ``cv2.imread`` gives a
file of the same bytes, for the record (cv2 scales 16-bit PNM where PIL
clips it; the port's file path refuses PNM).  ``tests/test_torch_pnm.py``
recomputes PIL's.
"""

import hashlib
import importlib.util
import io
import os

import numpy as np

from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "gif_fixtures", os.path.join(os.path.dirname(HERE), "gif",
                                 "make_fixtures.py"))
_gif = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gif)
write, pil_message = _gif.write, _gif.pil_message

REFUSED = {"refused_truncated.ppm": "truncated PNM data",
           "refused_sample_past_maxval.pgm": "outside 0-15",
           "refused_maxval_0.pgm": "maxval 0",
           "refused_p1_byte.pbm": "is not 0 or 1",
           "refused_long_token.ppm": "token too long",
           "refused_color_pfm.pfm": "not a PNG, JPEG, BMP"}


def values(h: int, w: int, bands: int, maxval: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 37 + yy * 11)[..., None] * (np.arange(bands) + 1)) % (
        maxval + 1)
    noise = rng.integers(0, maxval + 1, (h, w, bands))
    return np.where(rng.random((h, w, bands)) < 0.2, noise, base)


def plain(magic: bytes, v: np.ndarray, maxval, head_sep=b"\n",
          comments=False) -> bytes:
    h, w, _ = v.shape
    head = magic + head_sep + f"{w} {h}".encode() + head_sep
    if maxval is not None:
        head += str(maxval).encode() + b"\n"
    out = bytearray(head)
    for r, row in enumerate(v.reshape(h, -1)):
        out += b" ".join(str(int(s)).encode() for s in row)
        out += b" # row %d\n" % r if comments and r % 2 else b"\n"
    return bytes(out)


def raw(magic: bytes, v: np.ndarray, maxval: int, head: bytes = None
        ) -> bytes:
    h, w, _ = v.shape
    head = head or magic + f"\n{w} {h}\n{maxval}\n".encode()
    return head + v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


def fixtures() -> dict:
    """{file name: bytes}."""
    out = {}
    rgb = np.clip(values(23, 31, 3, 255, 1), 0, 255).astype(np.uint8)
    for mode, ext in (("1", "pbm"), ("L", "pgm"), ("RGB", "ppm")):
        b = io.BytesIO()
        Image.fromarray(rgb).convert(mode).save(b, "PPM")
        out[f"pil_{mode.lower()}.{ext}"] = b.getvalue()
    bits = values(13, 19, 1, 1, 2)
    out["p1.pbm"] = b"P1\n# a comment\n19 13\n" + b"\n".join(
        bytes(b"01"[int(s)] for s in row) for row in bits[..., 0]) + b"\n"
    out["p1_spaced.pbm"] = plain(b"P1", bits, None, comments=True)
    out["p4_width_13.pbm"] = b"P4\n13 7\n" + np.packbits(
        values(7, 13, 1, 1, 3)[..., 0].astype(np.uint8), axis=1).tobytes()
    for maxval in (1, 15, 255, 1000, 65535):
        out[f"p2_maxval_{maxval}.pgm"] = plain(
            b"P2", values(11, 14, 1, maxval, 4), maxval)
        out[f"p3_maxval_{maxval}.ppm"] = plain(
            b"P3", values(9, 12, 3, maxval, 5), maxval, comments=True)
        out[f"p5_maxval_{maxval}.pgm"] = raw(
            b"P5", values(17, 21, 1, maxval, 6), maxval)
        out[f"p6_maxval_{maxval}.ppm"] = raw(
            b"P6", values(15, 18, 3, maxval, 7), maxval)
    v = values(10, 11, 3, 255, 8)
    out["header_comments.ppm"] = raw(
        b"P6", v, 255, b"P6 #magic\r# two\r\n 1#split\n1\t10\x0b255\n")
    f = np.random.default_rng(9).uniform(-20, 280, (9, 13)).astype(np.float32)
    out["pfm_big_endian.pfm"] = b"Pf\n13 9\n1.0\n" + f.astype(">f4").tobytes()
    out["pfm_little_endian.pfm"] = (b"Pf\n13 9\n-1.0\n"
                                    + f.astype("<f4").tobytes())
    out["refused_truncated.ppm"] = out["p6_maxval_255.ppm"][:-100]
    bad = values(4, 5, 1, 15, 10)
    bad[2, 3, 0] = 16
    out["refused_sample_past_maxval.pgm"] = plain(b"P2", bad, 15)
    out["refused_maxval_0.pgm"] = b"P5\n2 2\n0\n" + bytes(4)
    out["refused_p1_byte.pbm"] = b"P1\n3 2\n0 1 0\n1 2 1\n"
    out["refused_long_token.ppm"] = b"P6\n000000000003 2\n255\n" + bytes(18)
    out["refused_color_pfm.pfm"] = (b"PF\n3 2\n1.0\n"
                                    + np.zeros(18, ">f4").tobytes())
    return out


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def pil_digests(data: bytes) -> dict:
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return {"body": sha(rgb), "body_shape": list(rgb.shape)}


if __name__ == "__main__":
    write(HERE, fixtures(), REFUSED, pil_digests)
