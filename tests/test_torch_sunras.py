"""The port's Sun raster reader (``utils/sunras.py``,
``runtime/csrc/rle.cpp``) against cv2 (files) and PIL (bodies), and
against the JAX package's own readers; on the CPU, tolerance 0.

* Every fixture of ``tests/data/sunras/`` on both paths: ``digests.json``
  recomputed from the committed files with ``cv2.imread`` of the file and
  PIL's ``convert("RGB")`` of the bytes; the port's RGB has the same
  sha256, or raises a ``ValueError`` with the reason recorded where the
  oracle returns None or raises (OpenCV 5 reads types 0 and 1 only).
* The same bytes through the JAX package's ``imread`` and its server's
  ``_png_to_uint8``.
* 240 seeded random Sun rasters (depths 1-32 and 16, types 0-6, colour
  maps of every kind, runs, 0x80 bytes, cut or longer data, widths of 1)
  on both paths.
"""

import importlib.util
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import sunras
from tests.cv2_files import (assert_fixture, assert_fixture_like_jax,
                             assert_like_cv2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "sunras")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "sunras_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_as_cv2_and_pil_read_it(name):
    assert_fixture(os.path.join(FIXTURES, name), DIGESTS[name])


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_through_the_jax_package(name):
    assert_fixture_like_jax(os.path.join(FIXTURES, name), DIGESTS[name])


def _random_sun(rng) -> bytes:
    depth = int(rng.choice([1, 4, 8, 24, 32, 16]))
    kind = int(rng.choice([0, 1, 2, 3, 4, 6]))
    h, w = int(rng.integers(1, 7)), int(rng.integers(1, 23))
    if rng.random() < 0.1:
        w = 1
    levels = {1: 2, 4: 16}.get(depth, 256)
    img = rng.integers(0, levels, (h, w) if depth <= 8 else
                       (h, w, depth // 8)).astype(np.uint8)
    if rng.random() < 0.5:
        img[:] = img[:, :1]
    if rng.random() < 0.3 and depth > 4:
        img[img < 40] = 0x80
    mt = int(rng.choice([0, 1, 1, 2]))
    n = int(rng.choice([0, 1, 2, 10, 16, 256, 267]))
    cmap = make.cmap(n, int(rng.integers(0, 1000))) if mt or \
        rng.random() < 0.2 else b""
    data = make.sun(img, depth, kind, cmap, maptype=mt,
                    length=int(rng.choice([1, 4])) if rng.random() < 0.3
                    else None, pad=kind != 2 or rng.random() < 0.3)
    r = rng.random()
    if r < 0.15:
        data = data[:len(data) - int(rng.integers(1, 6))]
    elif r < 0.25:
        data = data + rng.integers(0, 256, 5, np.uint8).tobytes()
    return data


@pytest.mark.parametrize("chunk", range(4))
def test_random_files_as_cv2_and_pil_read_them(tmp_path, chunk):
    rng = np.random.default_rng(4200 + chunk)
    for i in range(60):
        data = _random_sun(rng)
        assert_like_cv2(tmp_path, data, ".ras", i)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # noqa: BLE001 - PIL raises several types
            with pytest.raises(ValueError, match="^random: "):
                sunras.decode_sunras(data, "random")
            continue
        got = sunras.decode_sunras(data, "random")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i
