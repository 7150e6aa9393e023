"""Make the Radiance HDR fixtures of this folder and their
``digests.json``.

    python tests/data/hdr/make_fixtures.py

Files ``cv2.imwrite`` writes (``#?RADIANCE``, run-length scanlines for
widths 8-32767, flat ones otherwise) of seeded float images, and files
``rgbe`` writes by hand, each a variant the port's reader
(``crdr_tpu_torch/utils/hdr.py``, ``runtime/csrc/rle.cpp``) is held to:
the ``#?RGBE`` signature, comments, ``EXPOSURE`` / ``GAMMA`` lines and a
header line past 127 bytes, a resolution line with other spacing, flat
pixels at widths of 8 and more, run-length scanlines with runs and
literals of every length, a run-length scanline followed by flat ones,
old-style runs (``1 1 1 n``, read as the flat pixels they are), exponents
of 0 and past 2^31 / 255 (which cv2's ``cvRound`` overflows to 0), values
past 1.  A 768x512 run-length file times the decoder
(``synthetic_images(1, 512, 768, 25)`` of
``crdr_tpu_torch/cli/serve_smoke.py``, posterised to 64 levels and
written by cv2).  Refusals (cv2 returns None): another format (XYZE), no
FORMAT line, no empty line, a ``+Y`` resolution line, a width of 0.  PIL
opens no Radiance file, so each body is refused.

``digests.json`` is written by ``tests/data/jpeg2000/make_fixtures.py``'s
``write``; ``tests/test_torch_hdr.py`` recomputes it.
"""

import importlib.util
import os
import sys

import numpy as np

import cv2

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_fixtures", os.path.join(os.path.dirname(HERE), "jpeg2000",
                                      "make_fixtures.py"))
_j2k = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_j2k)
write = _j2k.write

FILE_REFUSED = {"refused_xyze.hdr": "without FORMAT=32-bit_rle_rgbe",
                "refused_no_format.hdr": "without FORMAT=32-bit_rle_rgbe",
                "refused_no_empty_line.hdr": "without its end",
                "refused_plus_y.hdr": "resolution line",
                "refused_width_0.hdr": "resolution line"}
BODY = "a Radiance HDR body"


def rgbe(px: np.ndarray) -> bytes:
    """[h, w, 4] RGBE bytes as flat quadruples."""
    return px.astype(np.uint8).tobytes()


def rle_channel(vals) -> bytes:
    """One channel of a scanline: runs of 3-127 as (128 + n, v), the rest as
    literals of up to 128 (n, then n bytes)."""
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, vals[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and vals[k] == vals[k + 1] == vals[k + 2]):
            k += 1
        out += bytes([k - i]) + bytes(vals[i:k])
        i = k
    return bytes(out)


def rle(px: np.ndarray) -> bytes:
    """[h, w, 4] RGBE as new-style run-length scanlines."""
    h, w, _ = px.shape
    return b"".join(bytes([2, 2, w >> 8, w & 255]) + b"".join(
        rle_channel(px[y, :, c].tolist()) for c in range(4)) for y in range(h))


def header(h: int, w: int, lines=(), magic=b"#?RADIANCE",
           fmt=b"FORMAT=32-bit_rle_rgbe", res=None) -> bytes:
    res = res if res is not None else f"-Y {h} +X {w}".encode()
    return magic + b"\n" + b"".join(line + b"\n" for line in lines) + fmt \
        + b"\n\n" + res + b"\n"


def pixels(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 4] RGBE bytes with runs, a zero exponent and large ones."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4))
    px[..., 3] = rng.choice([0, 100, 126, 127, 128, 129, 130, 140, 160, 255],
                            (h, w))
    px[:, w // 3: w // 2] = px[:, w // 3: w // 3 + 1]
    return px.astype(np.uint8)


def cv2_hdr(img: np.ndarray) -> bytes:
    """``cv2.imwrite`` of a float32 RGB image as Radiance."""
    path = os.path.join(HERE, "_tmp.hdr")
    cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1], np.float32))
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    return data


def fixtures() -> dict:
    """{file name: bytes}."""
    from crdr_tpu_torch.cli.serve_smoke import synthetic_images
    out = {}
    rng = np.random.default_rng(1)
    for w in (1, 7, 8, 33):
        img = rng.random((5, w, 3)).astype(np.float32) * 1.6
        out[f"cv2_width_{w}.hdr"] = cv2_hdr(img)
    photo = synthetic_images(1, 512, 768, 25)[0] // 4 * 4
    out["photo_768x512_rle.hdr"] = cv2_hdr(photo.astype(np.float32) / 200)
    px = pixels(6, 20, 2)
    out["rle_by_hand.hdr"] = header(6, 20) + rle(px)
    out["rle_long_runs.hdr"] = header(3, 300) + rle(np.repeat(
        pixels(3, 3, 3), 100, axis=1))
    out["flat_width_20.hdr"] = header(6, 20) + rgbe(px)
    mixed = pixels(4, 16, 4)
    mixed[1:, 0, :2] = 9  # the flat rows do not start 2 2
    out["rle_then_flat.hdr"] = header(4, 16) + rle(mixed[:1]) + rgbe(
        mixed[1:])
    old = pixels(3, 9, 5)
    old[1, 4] = (1, 1, 1, 3)
    out["old_style_run.hdr"] = header(3, 9) + rgbe(old)
    out["magic_rgbe.hdr"] = header(6, 20, magic=b"#?RGBE") + rle(px)
    out["header_lines.hdr"] = header(
        6, 20, [b"# made by hand", b"EXPOSURE=2.0", b"GAMMA=2.2",
                b"SOFTWARE=" + b"x" * 150]) + rle(px)
    out["resolution_spacing.hdr"] = header(
        6, 20, res=b"-Y  6\t+X 20 ") + rle(px)
    out["resolution_no_spaces.hdr"] = header(6, 20, res=b"-Y6+X20") + rle(px)
    out["data_past_image.hdr"] = header(6, 20) + rle(px) + b"\0\1\2"
    out["refused_xyze.hdr"] = header(6, 20, fmt=b"FORMAT=32-bit_rle_xyze") \
        + rle(px)
    out["refused_no_format.hdr"] = header(6, 20, fmt=b"# no format") + rle(
        px)
    out["refused_no_empty_line.hdr"] = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n"
    out["refused_plus_y.hdr"] = header(6, 20, res=b"+Y 6 +X 20") + rle(px)
    out["refused_width_0.hdr"] = header(6, 0) + b""
    return out


if __name__ == "__main__":
    files = fixtures()
    write(HERE, files, FILE_REFUSED, {name: BODY for name in files})
