"""The port's JPEG 2000 reader (``utils/jpeg2000.py``,
``runtime/csrc/jpeg2000.cpp``) against cv2 (files) and PIL (bodies), both
OpenJPEG 2.5, and against the JAX package's own readers; on the CPU,
tolerance 0.

* Every fixture of ``tests/data/jpeg2000/`` on both paths: ``digests.json``
  recomputed from the committed files with ``cv2.imread`` of the file and
  PIL's ``convert("RGB")`` of the bytes, so it cannot drift; the port's
  RGB has the same sha256, or raises a ``ValueError`` with the reason
  recorded where the oracle returns None or raises.  The irreversible
  (9/7) files are byte-equal too: the decoder keeps OpenJPEG's order of
  float operations.
* The same bytes through the JAX package: ``crdr_tpu.utils.img_utils.
  imread`` against the port's ``imread`` (equal float32, or both raise),
  ``crdr_tpu.serving.http_server._png_to_uint8`` against the port's body
  decode (equal uint8, or both raise).
* Seeded random files PIL writes (sizes, tiles, offsets, code-blocks,
  precincts, progressions, layers, both wavelets, modes) on both paths.
* Seeded mutations of the small fixtures (bytes set, flipped or cut) on
  both paths: read as cv2 and PIL read them, or refused where they refuse
  (OpenJPEG's marker, tile-part and strict-mode rules), but for the
  bodies refused on purpose (subsampled components).
* ``yuv_to_rgb_cv2`` against ``cv2.cvtColor(COLOR_YUV2BGR)``,
  ``ycbcr_to_rgb_pil`` against PIL's YCbCr to RGB, every input.
"""

import importlib.util
import io
import json
import os

import numpy as np
import pytest

import cv2
from PIL import Image

from crdr_tpu_torch.utils import jpeg2000
from tests.cv2_files import (assert_fixture, assert_fixture_like_jax,
                             assert_like_cv2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg2000")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "jpeg2000_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_as_cv2_and_pil_read_it(name):
    assert_fixture(os.path.join(FIXTURES, name), DIGESTS[name])


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_through_the_jax_package(name):
    assert_fixture_like_jax(os.path.join(FIXTURES, name), DIGESTS[name])


def _random_jpeg2000(rng, i: int) -> bytes:
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    c = [1, 2, 3, 4][i % 4]
    kw = {"irreversible": bool(rng.random() < 0.5),
          "num_resolutions": int(rng.integers(1, 5)),
          "progression": ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"][i % 5],
          "no_jp2": bool(rng.random() < 0.3)}
    if c >= 3:
        kw["mct"] = int(rng.integers(0, 2))
    if rng.random() < 0.5:
        kw["codeblock_size"] = tuple(int(v) for v in rng.choice([4, 8, 16,
                                                                 32], 2))
    if rng.random() < 0.5:
        kw["precinct_size"] = (64, 64)
    if rng.random() < 0.4:
        kw["quality_layers"] = [int(rng.integers(2, 30)), 1]
    if rng.random() < 0.3:
        kw["tile_size"] = (int(rng.integers(16, 40)), int(rng.integers(16,
                                                                       40)))
        if rng.random() < 0.5:
            kw["tile_offset"] = (int(rng.integers(0, 4)),
                                 int(rng.integers(0, 4)))
            kw["offset"] = (kw["tile_offset"][0] + int(rng.integers(0, 4)),
                            kw["tile_offset"][1] + int(rng.integers(0, 4)))
    img = make.synthetic(h, w, c, 100 + i)
    return make.save(img, {1: None, 2: "LA", 3: None, 4: "RGBA"}[c], **kw)


@pytest.mark.parametrize("chunk", range(4))
def test_random_files_as_cv2_and_pil_read_them(tmp_path, chunk):
    rng = np.random.default_rng(4000 + chunk)
    for i in range(10):
        try:
            data = _random_jpeg2000(rng, 10 * chunk + i)
        except OSError:  # PIL's writer refuses some settings
            continue
        assert_like_cv2(tmp_path, data, ".jp2", i)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # noqa: BLE001 - PIL raises several types
            with pytest.raises(ValueError, match="^random: "):
                jpeg2000.decode_jpeg2000(data, "random")
            continue
        got = jpeg2000.decode_jpeg2000(data, "random")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


_SMALL = sorted(n for n in DIGESTS
                if os.path.getsize(os.path.join(FIXTURES, n)) < 30000)


@pytest.mark.parametrize("chunk", range(2))
def test_seeded_mutations_as_cv2_and_pil_read_them(tmp_path, chunk):
    rng = np.random.default_rng(4400 + chunk)
    for i in range(100):
        with open(os.path.join(FIXTURES, _SMALL[rng.integers(len(_SMALL))]),
                  "rb") as f:
            data = bytearray(f.read())
        for _ in range(int(rng.integers(1, 4))):
            at, r = int(rng.integers(0, len(data))), rng.random()
            if r < 0.6:
                data[at] = int(rng.integers(0, 256))
            elif r < 0.8:
                data[at] ^= 1 << int(rng.integers(0, 8))
            else:
                del data[at:at + int(rng.integers(1, 20))]
        data = bytes(data)
        try:
            jp2, _, head = jpeg2000._open(data, "m")
            if (head.x1 - head.x0) * (head.y1 - head.y0) > 1 << 20:
                continue  # keep the test small
        except ValueError:
            pass
        assert_like_cv2(tmp_path, data, ".jp2", i)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # noqa: BLE001 - PIL raises several types
            with pytest.raises(ValueError, match="^m: "):
                jpeg2000.decode_jpeg2000(data, "m")
            continue
        try:
            got = jpeg2000.decode_jpeg2000(data, "m")
        except ValueError as e:
            assert "subsampled" in str(e), i
            continue
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


def test_yuv_to_rgb_as_cv2():
    yuv = np.random.default_rng(4100).integers(0, 256, (512, 512, 3),
                                                np.uint8)
    yuv[0, :256] = np.stack([np.arange(256)] * 3, -1)
    want = cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)[..., ::-1]
    assert jpeg2000.yuv_to_rgb_cv2(yuv).tobytes() == want.tobytes()


def test_ycbcr_to_rgb_as_pil():
    g = np.arange(256, dtype=np.uint8)
    ycc = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(4096,
                                                                    4096, 3)
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), ycc.tobytes())
                      .convert("RGB"))
    assert jpeg2000.ycbcr_to_rgb_pil(ycc).tobytes() == want.tobytes()
