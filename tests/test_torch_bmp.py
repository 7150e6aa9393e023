"""The port's BMP reader and writer (``utils/bmp.py``) against cv2 and PIL,
on the CPU; tolerance 0 throughout.

* Every fixture of ``tests/data/bmp/``: ``digests.json`` recomputed from
  the committed files with ``cv2.imread`` (the file path) and PIL's
  ``convert("RGB")`` (the body path); the port's pixels have the same
  digests on each path.
* 120 seeded random BMPs across the variants (1-, 4- and 8-bit palettes,
  RLE8 / RLE4, 16-, 24- and 32-bit, bitfields, header sizes, top-down):
  each path equal to its oracle, or refused where its oracle refuses.
* The variants where cv2 and PIL part (bitfields, a stream that ends
  early, a run past its row), each path against its oracle.
* ``imwrite('.bmp')`` and ``encode_bmp`` byte-equal to ``cv2.imwrite``.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct

import numpy as np
import pytest

import cv2
from PIL import Image

from crdr_tpu_torch.utils import bmp, img_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "bmp")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "bmp_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def _oracles(tmp_path, data: bytes):
    """(cv2.imread of a file holding ``data`` or None, PIL's read of the
    bytes or its exception)."""
    path = str(tmp_path / "oracle.bmp")
    with open(path, "wb") as f:
        f.write(data)
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    try:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - PIL raises several types
        pil = e
    return (None if bgr is None else bgr[..., ::-1]), pil


def _check_paths(tmp_path, data: bytes, name: str) -> None:
    """Each path equal to its oracle, or refused where it refuses."""
    for file_path, ref in zip((True, False), _oracles(tmp_path, data)):
        if ref is None or isinstance(ref, Exception):
            with pytest.raises(ValueError, match=f"^{name}: "):
                bmp.decode_bmp(data, name, file_path)
            continue
        got = bmp.decode_bmp(data, name, file_path)
        assert got.shape == ref.shape, (name, file_path)
        assert got.tobytes() == ref.tobytes(), (name, file_path)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    want = DIGESTS[name]
    assert want == {"file": _sha(bgr[..., ::-1]),
                    "file_shape": list(bgr.shape),
                    "body": _sha(pil), "body_shape": list(pil.shape)}
    mine_file = img_utils.read_image(path)
    mine_body = img_utils.decode_image(data, name, file_path=False)
    assert list(mine_file.shape) == want["file_shape"]
    assert _sha(mine_file) == want["file"]
    assert list(mine_body.shape) == want["body_shape"]
    assert _sha(mine_body) == want["body"]


def _random_bmp(rng) -> bytes:
    """One seeded BMP of a random variant."""
    h, w = (int(v) for v in rng.integers(1, 30, 2))
    kind = int(rng.integers(0, 5))
    top_down = bool(rng.random() < 0.3)
    if kind <= 1:  # palettes, raw or RLE
        bpp = int(rng.choice([1, 4, 8]) if kind == 0 else rng.choice([4, 8]))
        n = int(rng.integers(1, (1 << bpp) + 1))
        idx, pal = make.palette_image(bpp, h, w, int(rng.integers(1 << 30)),
                                      n=n)
        idx = idx % max(n, 2)  # now and then one past the palette
        if kind == 0:
            rows = make.pack_rows(idx if top_down else idx[::-1], bpp)
            return make.write_bmp(w, h, bpp, rows.tobytes(), palette=pal,
                                  colors=n, top_down=top_down)
        stream = make.rle_encode(idx, bpp == 4, rng) + bytes(8)
        return make.write_bmp(w, h, bpp, stream, 1 if bpp == 8 else 2, pal,
                              colors=n)
    if kind == 2:  # 16-bit
        v = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
        v = v if top_down else v[::-1]
        rows = make.pack_rows(v.view(np.uint8).reshape(h, -1), 8).tobytes()
        masks = [None, (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)][
            int(rng.integers(0, 3))]
        return make.write_bmp(w, h, 16, rows, 0 if masks is None else 3,
                              masks=masks, top_down=top_down)
    bpp = 24 if kind == 3 else 32
    px = rng.integers(0, 256, (h, w, bpp // 8), dtype=np.uint8)
    px = px if top_down else px[::-1]
    rows = make.pack_rows(px.reshape(h, -1), 8).tobytes()
    hsize = int(rng.choice([12, 40, 56, 108, 124] if bpp == 24
                           else [40, 56, 108, 124]))
    if bpp == 32 and rng.random() < 0.5:
        masks = [(0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000,
                                            0xFF000000),
                 (0xFF0000, 0xFF00, 0xFF, 0xFF000000)][
            int(rng.integers(0, 3))]
        if hsize == 40:
            masks = masks[:3]
        return make.write_bmp(w, h, 32, rows, 3, hsize=hsize, masks=masks,
                              top_down=top_down)
    return make.write_bmp(w, h, bpp, rows, hsize=hsize,
                          top_down=top_down and hsize != 12)


@pytest.mark.parametrize("chunk", range(4))
def test_random_bmps_against_cv2_and_pil(chunk, tmp_path):
    rng = np.random.default_rng(3000 + chunk)
    for i in range(30):
        _check_paths(tmp_path, _random_bmp(rng), f"case {chunk}/{i}")


def _parted(kind: str) -> bytes:
    """A BMP that cv2 and PIL read differently (``test_readers_part``)."""
    v = np.random.default_rng(7).integers(0, 1 << 16, (5, 6)).astype("<u2")
    rows16 = make.pack_rows(v.view(np.uint8).reshape(5, -1), 8).tobytes()
    px = np.random.default_rng(8).integers(0, 256, (5, 6, 4), np.uint8)
    idx, pal = make.palette_image(8, 4, 6, 9, n=16)
    if kind == "bitfields16_v4":
        return make.write_bmp(6, 5, 16, rows16, 3, hsize=108,
                              masks=(0xF800, 0x7E0, 0x1F, 0))
    if kind == "bitfields24":
        rows = make.pack_rows(px[..., :3].reshape(5, -1), 8).tobytes()
        return make.write_bmp(6, 5, 24, rows, 3,
                              masks=(0xFF0000, 0xFF00, 0xFF))
    if kind == "bitfields32_rgb_order":
        return make.write_bmp(6, 5, 32, px.tobytes(), 3,
                              masks=(0xFF, 0xFF00, 0xFF0000))
    if kind == "rle8_early_end":
        return make.write_bmp(6, 4, 8, bytes([6, 1, 0, 0, 2, 3, 0, 1]), 1,
                              pal, colors=16)
    if kind == "rle8_run_past_row":
        return make.write_bmp(6, 4, 8, bytes([9, 1, 0, 1]), 1, pal,
                              colors=16)
    if kind == "truncated":
        return make.write_bmp(6, 5, 32, px.tobytes()[:-7])
    if kind == "bits2":
        return make.write_bmp(6, 5, 2, bytes(20), palette=pal[:16])
    raise KeyError(kind)


@pytest.mark.parametrize("kind", [
    "bitfields16_v4", "bitfields24", "bitfields32_rgb_order",
    "rle8_early_end", "rle8_run_past_row", "truncated", "bits2"])
def test_readers_part(kind, tmp_path):
    _check_paths(tmp_path, _parted(kind), kind)


def test_bitfields_cv2_scales_are_refused():
    """cv2 reads 32-bit masks wider or narrower than a byte under a V5
    header by scaling each field; the port refuses them (a gap, listed in
    ROADMAP.md) and PIL does too."""
    px = np.zeros((2, 3, 4), np.uint8)
    data = make.write_bmp(3, 2, 32, px.tobytes(), 3, hsize=124,
                          masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))
    for file_path in (True, False):
        with pytest.raises(ValueError, match="bitfields"):
            bmp.decode_bmp(data, "wide.bmp", file_path)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (13, 17), (64, 33)])
def test_imwrite_bmp_byte_equal_to_cv2(tmp_path, shape):
    rgb = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,),
                                                   np.uint8)
    want = str(tmp_path / "cv2.bmp")
    assert cv2.imwrite(want, rgb[..., ::-1])
    got = str(tmp_path / "port.bmp")
    img_utils.imwrite(got, img_utils.uint8_to_tensor(rgb))
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()
    ok, buf = cv2.imencode(".bmp", rgb[..., ::-1])
    assert bmp.encode_bmp(rgb) == buf.tobytes()
    np.testing.assert_array_equal(img_utils.read_image(got), rgb)
    with pytest.raises(ValueError, match="encode_bmp"):
        bmp.encode_bmp(rgb[..., 0])
    assert struct.unpack_from("<H", buf.tobytes(), 28)[0] == 24
