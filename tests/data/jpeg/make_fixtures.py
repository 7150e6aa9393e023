"""Make the JPEG fixtures of this folder and their ``digests.json``.

    python tests/data/jpeg/make_fixtures.py

Seeded synthetic images, written with cv2 and PIL (the JAX package's JPEG
readers), one file per variant the port's decoder (``utils/jpeg.py``) is
held to: baseline at every sampling cv2 writes, grayscale, progressive,
restart intervals, optimized Huffman tables, odd sizes, EXIF orientations
2-8, Adobe CMYK (and YCCK, its Adobe transform byte set to 2), and one
photo-like 768x512 image for timing.  The variants neither writes are made
from a baseline file: its SOF0 marker rewritten to SOF9 (arithmetic) and to
SOF3 (lossless), its precision byte set to 12.  Four files are cut short,
as a scraped training set holds them: mid-scan (a baseline file), inside
the last scan of a progressive one, where a restart marker was due, and
just before EOI; ``cv2.imread`` reads each (libjpeg's "Premature end of
JPEG file": the rest of the image gray, or as the scans read so far left
it) and PIL refuses each ("image file is truncated").
Two files hold what ``cv2.imencode('.jpg')`` writes at its defaults (quality
95, 4:2:0), for the port's encoder (``utils/jpeg.py::encode_jpeg``): of the
768x512 photo's decoded pixels, and of that JPEG's decoded pixels (a
reconstruction); ``bytes`` in their entries is the sha256 of the file.

``digests.json`` holds, for each decodable file, the sha256 of the pixels
(uint8 RGB, row-major) that ``cv2.imread`` gives (``file``: EXIF orientation
applied) and that ``PIL.Image.open(...).convert("RGB")`` gives (``body``),
with their shapes; for each refused file, the reason the port gives; for
each truncated file, cv2's digests, the port's reason for refusing it on
the body path (``body_raises``) and PIL's message (``pil``).
``tests/test_torch_jpeg.py`` recomputes both from the committed files.
"""

import hashlib
import io
import json
import os

import numpy as np

import cv2
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

REFUSED = {
    "refused_sof9.jpg": "arithmetic-coded JPEG",
    "refused_sof3.jpg": "lossless JPEG",
    "refused_12bit.jpg": "12-bit samples",
}
# read on the file path as cv2 reads them, refused on the body path
TRUNCATED = ("truncated_baseline.jpg", "truncated_progressive.jpg",
             "truncated_restart.jpg", "truncated_no_eoi.jpg")


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


def cv2_jpeg(rgb: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1], list(params))
    assert ok
    return buf.tobytes()


def decoded(data: bytes) -> np.ndarray:
    """cv2's RGB pixels of a JPEG."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1])


def pil_jpeg(img: Image.Image, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, "JPEG", **kw)
    return b.getvalue()


def fixtures() -> dict:
    """{file name: bytes}."""
    q, sf = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out = {}
    for name, code in (("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                       ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                       ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                       ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                       ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)):
        out[f"baseline_{name}.jpg"] = cv2_jpeg(
            synthetic(61, 83, len(out)), q, 90, sf, code)
    gray = synthetic(45, 70, 10)[..., 1]
    ok, buf = cv2.imencode(".jpg", gray, [q, 88])
    out["gray.jpg"] = buf.tobytes()
    prog = cv2.IMWRITE_JPEG_PROGRESSIVE
    out["progressive_420.jpg"] = cv2_jpeg(
        synthetic(70, 90, 11), q, 85, prog, 1, sf,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    out["progressive_444.jpg"] = cv2_jpeg(
        synthetic(53, 67, 12), q, 92, prog, 1, sf,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    out["restart_interval.jpg"] = cv2_jpeg(
        synthetic(64, 96, 13), q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out["optimized_huffman.jpg"] = cv2_jpeg(
        synthetic(64, 96, 14), q, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    out["size_1x1.jpg"] = cv2_jpeg(synthetic(1, 1, 15), q, 90)
    out["size_17x31.jpg"] = cv2_jpeg(synthetic(17, 31, 16), q, 90)
    out["size_513x769.jpg"] = cv2_jpeg(synthetic(513, 769, 17, 3.0), q, 60)
    for o in range(2, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        out[f"exif_orientation_{o}.jpg"] = pil_jpeg(
            Image.fromarray(synthetic(40, 64, 20 + o)), quality=90,
            exif=exif.tobytes())
    rng = np.random.default_rng(30)
    cmyk = Image.fromarray(np.concatenate(
        [synthetic(36, 52, 31), rng.integers(0, 256, (36, 52, 1),
                                             dtype=np.uint8)], -1), "CMYK")
    out["adobe_cmyk.jpg"] = pil_jpeg(cmyk, quality=90)
    ycck = bytearray(out["adobe_cmyk.jpg"])
    i = ycck.find(b"Adobe")
    ycck[i + 11] = 2  # the Adobe transform byte: YCCK
    out["adobe_ycck.jpg"] = bytes(ycck)
    out["photo_768x512.jpg"] = cv2_jpeg(synthetic(512, 768, 40, 4.0), q, 80)
    photo = decoded(out["photo_768x512.jpg"])
    out["encoded_photo_q95.jpg"] = cv2_jpeg(photo)
    out["encoded_reconstruction_q95.jpg"] = cv2_jpeg(
        decoded(out["encoded_photo_q95.jpg"]))
    base = out["baseline_420.jpg"]
    out["refused_sof9.jpg"] = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    out["refused_sof3.jpg"] = base.replace(b"\xff\xc0", b"\xff\xc3", 1)
    sof = base.index(b"\xff\xc0")
    out["refused_12bit.jpg"] = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    out["truncated_baseline.jpg"] = base[:len(base) * 2 // 3]
    prog = out["progressive_420.jpg"]
    last = prog.rindex(b"\xff\xda")  # the last scan: luma's last AC bit
    out["truncated_progressive.jpg"] = prog[:(last + len(prog)) // 2]
    rst = out["restart_interval.jpg"]
    out["truncated_restart.jpg"] = rst[:rst.index(b"\xff\xd4")]
    out["truncated_no_eoi.jpg"] = base[:-2]
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


def truncated_digests(path: str) -> dict:
    """cv2's digests of a truncated file, PIL's refusal of it."""
    with open(path, "rb") as f:
        data = f.read()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
    except OSError as e:
        pil = str(e)
    else:
        raise AssertionError(f"PIL reads {path}")
    return {"file": sha(bgr[..., ::-1]), "file_shape": list(bgr.shape),
            "body_raises": "truncated data", "pil": pil}


def main() -> None:
    digests = {}
    for name, data in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        digests[name] = ({"raises": REFUSED[name]} if name in REFUSED
                         else truncated_digests(path) if name in TRUNCATED
                         else oracle_digests(path))
        if name.startswith("encoded_"):
            digests[name]["bytes"] = hashlib.sha256(data).hexdigest()
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
