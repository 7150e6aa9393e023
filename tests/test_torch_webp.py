"""The port's WebP reader (``utils/webp.py``, ``runtime/csrc/webp.cpp``)
against PIL (libwebp's animation decoder), on the CPU; tolerance 0.

* Every fixture of ``tests/data/webp/``: ``digests.json`` recomputed from
  the committed files with PIL, so it cannot drift; the port's RGB (and its
  RGBA, which holds the decoded ``ALPH``) have the same digests through
  ``img_utils.decode_image`` on the body path.  The files PIL refuses
  raise with their reason; on the file path every WebP raises, naming the
  format.
* 48 seeded random WebPs (lossy at any quality and ``method``, lossless,
  noise and palettes, alpha at any ``alpha_quality``, sizes 1-90): RGBA
  byte-equal to PIL's.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import img_utils, webp

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
    with pytest.raises(ValueError, match=f"^{name}: not a PNG, JPEG or BMP "
                       "file \\(a WebP file"):
        img_utils.decode_image(data, name, file_path=True)
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
