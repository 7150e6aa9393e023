"""The port's GIF reader (``utils/gif.py``, ``runtime/csrc/lzw.cpp``)
against PIL, on the CPU; tolerance 0.

* Every fixture of ``tests/data/gif/``: ``digests.json`` recomputed from
  the committed files with PIL, so it cannot drift; the port's RGB has the
  same digest through ``img_utils.decode_image`` on the body path.  The
  files PIL refuses raise with their reason.  On the file path, each
  equals its ``cv2`` digest (``cv2.imread`` of the file, recomputed), or
  raises where cv2 returns None (OpenCV's own GIF decoder: the screen
  filled with the background index, transparent pixels left, a default
  gray palette with index 1 white, every block of the file walked).
* 60 seeded random GIFs: PIL's writer (palettes of 2-256 colours, gray,
  1-bit, interlaced or not, a transparency index) and the fixture script's
  own writer (a frame at an offset on a larger screen, local palettes,
  minimum code sizes 2-8, short palettes, interlacing): byte-equal to
  PIL's ``convert("RGB")``; 80 more from the script's writer (offsets,
  transparency, background indexes, code sizes 2-11, cuts), as files,
  equal to ``cv2.imread``.
"""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import gif, img_utils
from tests.cv2_files import assert_fixture_file, assert_like_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "gif")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "gif_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


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
        assert make.pil_message(e.value) == want["pil"]
        with pytest.raises(ValueError, match=f"^{name}: .*{want['refused']}"):
            img_utils.decode_image(data, name, file_path=False)
        return
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert {k: want[k] for k in ("body", "body_shape")} == {
        "body": _sha(pil), "body_shape": list(pil.shape)}
    mine = img_utils.decode_image(data, name, file_path=False)
    assert list(mine.shape) == want["body_shape"]
    assert _sha(mine) == want["body"]


def _random_gif(rng) -> bytes:
    h, w = (int(v) for v in rng.integers(1, 60, 2))
    if rng.random() < 0.5:  # PIL's writer
        img = np.stack([make.image(h, w, 256, int(rng.integers(1 << 30)))
                        for _ in range(3)], -1)
        im = Image.fromarray(img)
        kind = int(rng.integers(0, 4))
        im = [im.quantize(int(rng.integers(2, 257))), im.convert("L"),
              im.convert("1"), im.convert("P")][kind]
        kw = {"interlace": bool(rng.integers(0, 2))}
        if rng.random() < 0.3:
            kw["transparency"] = int(rng.integers(0, 2))
        return make.pil_gif(im, **kw)
    bits = int(rng.integers(2, 9))
    n = int(rng.integers(1, (1 << bits) + 1))
    idx = make.image(h, w, 1 << bits, int(rng.integers(1 << 30)))
    sw, sh = w + int(rng.integers(0, 9)), h + int(rng.integers(0, 9))
    x, y = int(rng.integers(0, sw - w + 1)), int(rng.integers(0, sh - h + 1))
    interlace = bool(rng.random() < 0.4)
    local = rng.random() < 0.4
    pal = make.colors(n, int(rng.integers(1 << 30)))
    return make.write_gif(
        (sw, sh), (x, y, w, h), make.interlaced(idx) if interlace else idx,
        bits, None if local else pal, pal if local else None,
        int(rng.integers(0, n)) if rng.random() < 0.3 else None, interlace)


@pytest.mark.parametrize("chunk", range(4))
def test_random_gifs_byte_equal_to_pil(chunk):
    rng = np.random.default_rng(2000 + chunk)
    for i in range(15):
        data = _random_gif(rng)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = gif.decode_gif(data, f"random {chunk}.{i}")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


def _random_gif_file(rng, i: int) -> bytes:
    sw, sh = (int(v) for v in rng.integers(1, 30, 2))
    fw, fh = int(rng.integers(1, sw + 1)), int(rng.integers(1, sh + 1))
    x0 = int(rng.integers(0, sw - fw + 1))
    y0 = int(rng.integers(0, sh - fh + 1))
    if rng.random() < 0.1:
        x0 += int(rng.integers(1, 4))  # past the screen: cv2 refuses
    bits = int(rng.integers(2, 12))
    n = int(rng.integers(1, min(1 << bits, 600) + 1))
    idx = rng.integers(0, n, (fh, fw))
    top = 1 << min(bits, 8)
    gp = make.colors(int(rng.integers(2, top + 1)), i) \
        if rng.random() < 0.7 else None
    lp = make.colors(int(rng.integers(2, top + 1)), i + 1000) \
        if rng.random() < 0.4 else None
    tr = int(rng.integers(0, min(n + 2, 256))) if rng.random() < 0.5 \
        else None
    il = rng.random() < 0.3
    data = bytearray(make.write_gif((sw, sh), (x0, y0, fw, fh),
                                    make.interlaced(idx) if il else idx,
                                    bits, gp, lp, tr, il))
    if gp is not None and rng.random() < 0.5:
        data[11] = int(rng.integers(0, 8))  # the background index
    if rng.random() < 0.1:
        data = data[:int(rng.integers(6, len(data)))]
    return bytes(data)


@pytest.mark.parametrize("chunk", range(4))
def test_random_gif_files_as_cv2_reads_them(tmp_path, chunk):
    rng = np.random.default_rng(2100 + chunk)
    for i in range(20):
        assert_like_cv2(tmp_path, _random_gif_file(rng, i), ".gif", i)
