"""The port's WebP reader (``utils/webp.py``, ``runtime/csrc/webp.cpp``)
against PIL (libwebp's animation decoder), on the CPU; tolerance 0.

* Every fixture of ``tests/data/webp/``: ``digests.json`` recomputed from
  the committed files with PIL, so it cannot drift; the port's RGB (and its
  RGBA, which holds the decoded ``ALPH``) have the same digests through
  ``img_utils.decode_image`` on the body path.  The files PIL refuses
  raise with their reason.  On the file path, each equals its ``cv2``
  digest (``cv2.imread`` of the file, recomputed), or raises where cv2
  returns None: cv2 reads an ``ALPH`` beside a ``VP8L`` (libwebp's
  ``WebPDecode`` drops it) and turns a file by its EXIF orientation.
* 48 seeded random WebPs (lossy at any quality and ``method``, lossless,
  noise and palettes, alpha at any ``alpha_quality``, sizes 1-90): RGBA
  byte-equal to PIL's; 24 more with an EXIF orientation, as files, equal
  to ``cv2.imread``.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import img_utils, webp
from tests.cv2_files import assert_fixture_file, assert_like_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "webp")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = DIGESTS[name]
    assert_fixture_file(os.path.join(FIXTURES, name), want)
    if "refused" in want:
        with pytest.raises(Exception) as e:
            Image.open(io.BytesIO(data)).convert("RGB")
        assert str(e.value) == want["pil"]
        with pytest.raises(ValueError, match=f"^{name}: .*{want['refused']}"):
            img_utils.decode_image(data, name, file_path=False)
        return
    im = Image.open(io.BytesIO(data))
    pil = np.asarray(im.convert("RGB"))
    assert {k: want[k] for k in ("body", "body_shape", "rgba")} == {
        "body": _sha(pil), "body_shape": list(pil.shape),
        "rgba": _sha(np.asarray(im.convert("RGBA")))}
    mine = img_utils.decode_image(data, name, file_path=False)
    assert list(mine.shape) == want["body_shape"]
    assert _sha(mine) == want["body"]
    assert _sha(webp.decode_webp_rgba(data, name)) == want["rgba"]


def _random_webp(rng) -> bytes:
    h, w = (int(v) for v in rng.integers(1, 91, 2))
    kind = int(rng.integers(0, 4))
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(0.02, 0.5, 3)
    img = np.stack([128 + 100 * np.sin(f[0] * xx), 128 + 90 * np.cos(
        f[1] * yy), 128 + 80 * np.sin(f[2] * (xx + yy))], -1)
    img = img + rng.normal(0, rng.uniform(0, 40), img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if kind == 3:  # a few colours: colour indexing
        colors = rng.integers(0, 256, (int(rng.integers(2, 20)), 3))
        img = colors[(xx + 3 * yy) % len(colors)].astype(np.uint8)
    kw = {"method": int(rng.integers(0, 7)),
          "quality": int(rng.integers(0, 101))}
    if kind >= 2 or rng.random() < 0.3:
        kw["lossless"] = True
    if kind == 1:
        a = rng.integers(0, 256, (h, w), dtype=np.uint8)
        a[rng.random((h, w)) < 0.5] = 255
        img = np.concatenate([img, a[..., None]], -1)
        kw["alpha_quality"] = int(rng.integers(0, 101))
    b = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else "RGB").save(
        b, "WEBP", **kw)
    return b.getvalue()


@pytest.mark.parametrize("chunk", range(4))
def test_random_webps_byte_equal_to_pil(chunk):
    rng = np.random.default_rng(1000 + chunk)
    for i in range(12):
        data = _random_webp(rng)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        got = webp.decode_webp_rgba(data, f"random {chunk}.{i}")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


@pytest.mark.parametrize("chunk", range(2))
def test_random_webp_files_as_cv2_reads_them(tmp_path, chunk):
    rng = np.random.default_rng(1100 + chunk)
    for i in range(12):
        data = _random_webp(rng)
        if i % 2:  # an EXIF orientation, 0-9 (cv2 turns 2-8)
            exif = Image.Exif()
            exif[0x0112] = int(rng.integers(0, 10))
            im = Image.open(io.BytesIO(data))
            b = io.BytesIO()
            im.save(b, "WEBP", lossless=bool(i % 4 == 1), quality=70,
                    exif=exif.tobytes())
            data = b.getvalue()
        assert_like_cv2(tmp_path, data, ".webp", i)
