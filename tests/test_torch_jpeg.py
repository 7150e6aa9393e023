"""The port's JPEG decoder (``utils/jpeg.py``, ``runtime/csrc/jpeg.cpp``) and
BMP reader against cv2 and PIL, on the CPU; tolerance 0 throughout.

* Every fixture of ``tests/data/jpeg/``: ``digests.json`` recomputed from
  the committed files with cv2 (the file path, EXIF orientation applied)
  and PIL (the body path), so it cannot drift; the port's pixels have the
  same digests on each path.  The refused fixtures (SOF9, SOF3, 12-bit)
  raise with the file's name and their reason.  The truncated ones (cut
  mid-scan, inside a progressive file's last scan, where a restart marker
  was due, before EOI) decode on the file path to ``cv2.imread``'s pixels
  (libjpeg's partial image) and raise on the body path, as PIL raises.
* 240 seeded random images across the variants (cv2 at every sampling it
  writes, progressive, restart intervals, optimized tables, grayscale, any
  quality and odd sizes; PIL's subsamplings, RGB without conversion, CMYK
  and YCCK, EXIF orientations): byte-equal to ``cv2.imdecode`` and to
  PIL's ``convert("RGB")``.
* ``imread`` reads a JPEG by its magic bytes, whatever its suffix, and
  decodes in several threads at once.
* 24- and 32-bit BMPs, bottom-up and top-down: equal to ``cv2.imread``;
  a bit count cv2 refuses, a truncated BMP and unknown formats raise (the
  other BMP variants: ``tests/test_torch_bmp.py``).
"""

import hashlib
import io
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import cv2
from PIL import Image

from crdr_tpu_torch.utils import img_utils
from crdr_tpu_torch.utils.jpeg import decode_jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def _oracles(data: bytes):
    """(cv2's RGB of a file, PIL's RGB of a body)."""
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return bgr[..., ::-1], np.asarray(Image.open(io.BytesIO(data))
                                      .convert("RGB"))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    path = os.path.join(FIXTURES, name)
    want = DIGESTS[name]
    if "raises" in want:
        with pytest.raises(ValueError, match=want["raises"]) as e:
            img_utils.read_image(path)
        assert path in str(e.value)
        return
    with open(path, "rb") as f:
        data = f.read()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    if "body_raises" in want:  # a truncated file
        with pytest.raises(OSError, match="image file is truncated") as e:
            Image.open(io.BytesIO(data)).convert("RGB")
        assert want == {"file": _sha(bgr[..., ::-1]),
                        "file_shape": list(bgr.shape),
                        "body_raises": "truncated data", "pil": str(e.value)}
        mine = img_utils.read_image(path)
        assert list(mine.shape) == want["file_shape"]
        assert _sha(mine) == want["file"]
        with pytest.raises(ValueError, match=f"^{name}: truncated data"):
            img_utils.decode_image(data, name, file_path=False)
        return
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert want == {"file": _sha(bgr[..., ::-1]),
                    "file_shape": list(bgr.shape),
                    "body": _sha(pil), "body_shape": list(pil.shape),
                    # cv2's output for the encoder (make_fixtures.py)
                    **({"bytes": hashlib.sha256(data).hexdigest()}
                       if name.startswith("encoded_") else {})}
    mine_file = img_utils.read_image(path)
    mine_body = decode_jpeg(data, name)
    assert list(mine_file.shape) == want["file_shape"]
    assert _sha(mine_file) == want["file"]
    assert list(mine_body.shape) == want["body_shape"]
    assert _sha(mine_body) == want["body"]


def _image(rng, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(0.02, 0.3, 3)
    img = np.stack([128 + 100 * np.sin(f[0] * xx + rng.random() * 6),
                    128 + 90 * np.cos(f[1] * yy),
                    128 + 80 * np.sin(f[2] * (xx + yy))], -1)
    img += rng.normal(0, rng.uniform(0, 30), img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


_CV2_SAMPLINGS = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)


def _random_jpeg(rng) -> bytes:
    """One seeded JPEG of a random variant, size and quality."""
    h, w = (int(v) for v in rng.integers(1, 140, 2))
    img = _image(rng, h, w)
    kind = int(rng.integers(0, 6))
    if kind <= 2:  # cv2: sampling, progressive / restarts / optimized
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 101)),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  _CV2_SAMPLINGS[int(rng.integers(0, 5))]]
        if rng.random() < 0.4:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if rng.random() < 0.3:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL,
                       int(rng.integers(1, 5))]
        if rng.random() < 0.3:
            params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        return buf.tobytes()
    if kind == 3:  # grayscale
        ok, buf = cv2.imencode(".jpg", img[..., 0], [
            cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(5, 101)),
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(rng.random() < 0.5)])
        assert ok
        return buf.tobytes()
    b = io.BytesIO()
    kw = {"quality": int(rng.integers(5, 96)),
          "progressive": bool(rng.random() < 0.4)}
    if kind == 4:  # PIL RGB: subsampling, RGB without conversion, EXIF
        if rng.random() < 0.2:
            kw["keep_rgb"] = True
        else:
            kw["subsampling"] = int(rng.integers(0, 3))
        if rng.random() < 0.5:
            exif = Image.Exif()
            exif[0x0112] = int(rng.integers(1, 9))
            kw["exif"] = exif.tobytes()
        Image.fromarray(img).save(b, "JPEG", **kw)
        return b.getvalue()
    k = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    Image.fromarray(np.concatenate([img, k], -1), "CMYK").save(b, "JPEG",
                                                               **kw)
    data = bytearray(b.getvalue())
    if rng.random() < 0.5:  # YCCK: the Adobe transform byte set to 2
        data[data.find(b"Adobe") + 11] = 2
    return bytes(data)


@pytest.mark.parametrize("chunk", range(8))
def test_random_jpegs_byte_equal_to_cv2_and_pil(chunk):
    rng = np.random.default_rng(1000 + chunk)
    for i in range(30):
        data = _random_jpeg(rng)
        ref_file, ref_body = _oracles(data)
        got_file = decode_jpeg(data, f"case {chunk}/{i}", file_path=True)
        got_body = decode_jpeg(data, f"case {chunk}/{i}")
        assert got_file.shape == ref_file.shape, (chunk, i)
        assert got_file.tobytes() == ref_file.tobytes(), (chunk, i)
        assert got_body.shape == ref_body.shape, (chunk, i)
        assert got_body.tobytes() == ref_body.tobytes(), (chunk, i)


def test_imread_reads_jpeg_by_magic_and_in_threads(tmp_path):
    src = os.path.join(FIXTURES, "baseline_420.jpg")
    odd = tmp_path / "photo.png"  # a JPEG under a PNG's suffix
    odd.write_bytes(open(src, "rb").read())
    want = cv2.imread(str(odd), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(img_utils.read_image(str(odd)), want)
    np.testing.assert_array_equal(img_utils.imread(str(odd)),
                                  img_utils.uint8_to_tensor(want))
    paths = [os.path.join(FIXTURES, n) for n in sorted(DIGESTS)
             if "raises" not in DIGESTS[n]] * 3
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(img_utils.read_image, paths))
    for p, g in zip(paths, got):
        assert _sha(g) == DIGESTS[os.path.basename(p)]["file"]
    with pytest.raises(ValueError, match="not a JPEG file"):
        decode_jpeg(b"\xff\xd8\xff", "tiny")
    with pytest.raises(ValueError, match="out.tif.*writes .png, .jpg"):
        img_utils.imwrite(str(tmp_path / "out.tif"), np.zeros((2, 2, 3)))


def _bmp(img: np.ndarray, bpp: int, top_down: bool) -> bytes:
    """A BITMAPINFOHEADER BMP of uint8 RGB ``img`` (alpha 255 at 32 bits)."""
    h, w, _ = img.shape
    px = img[..., ::-1]
    if bpp == 32:
        px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    body = rows.tobytes()
    header = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                         bpp, 0, len(body), 2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 14 + 40 + len(body), 0, 0, 54)
            + header + body)


@pytest.mark.parametrize("bpp", [24, 32])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_matches_cv2(tmp_path, bpp, top_down):
    img = np.random.default_rng(bpp + top_down).integers(
        0, 256, (13, 17, 3), np.uint8)
    path = str(tmp_path / "a.bmp")
    with open(path, "wb") as f:
        f.write(_bmp(img, bpp, top_down))
    want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(img_utils.read_image(path), want)
    cv2_path = str(tmp_path / "b.bmp")  # cv2's own writer (24-bit)
    assert cv2.imwrite(cv2_path, img[..., ::-1])
    np.testing.assert_array_equal(img_utils.read_image(cv2_path), img)


def test_bmp_and_unknown_formats_raise(tmp_path):
    data = bytearray(_bmp(np.zeros((4, 4, 3), np.uint8), 24, False))
    data[28] = 2  # 2 bits a pixel: a bit count cv2 refuses too
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8),
                        cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="2-bit BMP"):
        img_utils.decode_bmp(bytes(data), "pal.bmp")
    with pytest.raises(ValueError, match="truncated BMP"):
        img_utils.decode_bmp(_bmp(np.zeros((4, 4, 3), np.uint8), 24,
                                  False)[:-8], "cut.bmp")
    gif = tmp_path / "x.gif"
    gif.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="x.gif: not a PNG, JPEG or BMP"):
        img_utils.read_image(str(gif))
