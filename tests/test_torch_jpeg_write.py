"""The port's JPEG encoder (``utils/jpeg.py::encode_jpeg``,
``runtime/csrc/jpeg_encode.cpp``) against cv2 on the CPU; tolerance 0.

* ``encode_jpeg`` byte-equal to ``cv2.imencode('.jpg', rgb[..., ::-1])`` at
  cv2's defaults on 1x1, 7x9, 15x17, 16x16, 17x31, 513x769 and 768x512,
  each flat, a gradient and noise; on 200 seeded random sizes and contents;
  at other qualities;
* the fixtures ``encoded_*.jpg`` of ``tests/data/jpeg/`` (cv2's bytes,
  ``make_fixtures.py``): the port's encoder gives them from the same
  pixels, which the port's decoder gives (``chip_smoke.py`` phase 25 holds
  the card's host to the same digests);
* ``imwrite`` of ``.jpg`` / ``.jpeg`` equal to ``cv2.imwrite`` of the BGR
  array, file for file; the port's decoder and ``cv2.imread`` read the
  port's output identically;
* a shape or dtype the encoder does not take raises.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import cv2

from crdr_tpu_torch.utils import img_utils
from crdr_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
SIZES = [(1, 1), (7, 9), (15, 17), (16, 16), (17, 31), (513, 769),
         (768, 512)]


def _cv2(rgb: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           list(params))
    assert ok
    return buf.tobytes()


def _content(kind: str, h: int, w: int, rng) -> np.ndarray:
    if kind == "flat":
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "gradient":
        return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                         (xx + 2 * yy) % 256], -1).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["flat", "gradient", "noise"])
@pytest.mark.parametrize("size", SIZES)
def test_encode_jpeg_byte_equal_to_cv2(size, kind):
    img = _content(kind, *size, np.random.default_rng(size[0] * size[1]))
    assert encode_jpeg(img) == _cv2(img)


@pytest.mark.parametrize("chunk", range(4))
def test_random_sizes_byte_equal_to_cv2(chunk):
    """200 seeded cases in all: sizes 1-300 a side, smooth images with
    noise of a random amplitude (the DCT's and the quantiser's whole
    range, runs past 16 zeros, 0xFF bytes to stuff)."""
    rng = np.random.default_rng(2000 + chunk)
    for i in range(50):
        h, w = (int(v) for v in rng.integers(1, 301, 2))
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        f = rng.uniform(1, 20, 3)
        base = np.stack([np.sin(f[c] * xx + c) * np.cos(f[(c + 1) % 3] * yy)
                         for c in range(3)], -1) * 100 + 128
        img = np.clip(base + rng.normal(0, rng.uniform(0, 60), base.shape),
                      0, 255).astype(np.uint8)
        assert encode_jpeg(img) == _cv2(img), (chunk, i, h, w)


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 90, 100])
def test_other_qualities_byte_equal_to_cv2(quality):
    img = _content("noise", 37, 53, np.random.default_rng(quality))
    assert encode_jpeg(img, quality) == _cv2(
        img, cv2.IMWRITE_JPEG_QUALITY, quality)


def test_encoded_fixtures_from_the_ports_own_pixels():
    """The photo's pixels through the port's decoder, encoded: cv2's bytes
    (``encoded_photo_q95.jpg``); those bytes decoded and encoded again: the
    reconstruction's (``encoded_reconstruction_q95.jpg``)."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    with open(os.path.join(FIXTURES, "photo_768x512.jpg"), "rb") as f:
        pixels = decode_jpeg(f.read())
    for name in ("encoded_photo_q95.jpg", "encoded_reconstruction_q95.jpg"):
        data = encode_jpeg(pixels)
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert data == f.read(), name
        assert hashlib.sha256(data).hexdigest() == digests[name]["bytes"]
        pixels = decode_jpeg(data)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".JPG"])
def test_imwrite_jpeg_equals_cv2_imwrite(tmp_path, ext):
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (1, 45, 70, 3)).astype(np.float32)
    mine, theirs = str(tmp_path / f"mine{ext}"), str(tmp_path / f"cv2{ext}")
    img_utils.imwrite(mine, img)
    assert cv2.imwrite(theirs, img_utils.tensor_to_uint8(img[0])[..., ::-1])
    data = open(mine, "rb").read()
    assert data == open(theirs, "rb").read()
    np.testing.assert_array_equal(
        img_utils.read_image(mine), cv2.imread(mine, cv2.IMREAD_COLOR)[
            ..., ::-1])
    np.testing.assert_array_equal(decode_jpeg(data, file_path=True),
                                  img_utils.read_image(mine))


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32),
                                 np.zeros((0, 4, 3), np.uint8)])
def test_encode_jpeg_refuses_what_it_does_not_take(bad):
    with pytest.raises(ValueError, match="encode_jpeg"):
        encode_jpeg(bad)
