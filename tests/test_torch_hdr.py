"""The port's Radiance HDR reader (``utils/hdr.py``,
``runtime/csrc/rle.cpp``) against ``cv2.imread`` of a file, and against
the JAX package's own readers; on the CPU, tolerance 0.

* Every fixture of ``tests/data/hdr/``: ``digests.json`` recomputed from
  the committed files with ``cv2.imread``; the port's RGB has the same
  sha256, or raises a ``ValueError`` with the reason recorded where cv2
  returns None.  PIL cannot identify a Radiance file, so each body raises
  on both.
* The same bytes through the JAX package's ``imread`` and its server's
  ``_png_to_uint8``.
* Every RGBE value (256 mantissas x 256 exponents) against cv2's
  conversion to 8 bits, and 120 seeded random files (run-length, flat and
  mixed scanlines, header variants, cut data) against ``cv2.imread``,
  where cv2 reads its pixels to their end (past it cv2 returns its
  uninitialised buffer, which the port refuses).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from crdr_tpu_torch.utils import hdr
from tests.cv2_files import (assert_fixture, assert_fixture_like_jax,
                             assert_like_cv2, cv2_rgb)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "hdr")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "hdr_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_as_cv2_and_pil_read_it(name):
    assert_fixture(os.path.join(FIXTURES, name), DIGESTS[name])


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_through_the_jax_package(name):
    assert_fixture_like_jax(os.path.join(FIXTURES, name), DIGESTS[name])


def test_every_rgbe_value_as_cv2(tmp_path):
    m, e = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([m, m, 255 - m, e], -1).astype(np.uint8)
    data = make.header(256, 256) + make.rgbe(px)
    path = tmp_path / "all.hdr"
    path.write_bytes(data)
    assert hdr.rgbe_to_uint8(px).tobytes() == cv2_rgb(str(path)).tobytes()


def _random_hdr(rng) -> bytes:
    w, h = int(rng.choice([1, 3, 7, 8, 9, 17, 40])), int(rng.integers(1, 5))
    px = make.pixels(h, w, int(rng.integers(0, 10000)))
    kind = rng.choice(["rle", "flat", "mixed"]) if w >= 8 else "flat"
    if kind == "rle":
        body = make.rle(px)
    elif kind == "flat":
        if w >= 8 and rng.random() < 0.3:
            px[0, 0, :3] = 1
        body = make.rgbe(px)
    else:
        px[1:, 0, :2] = 9
        body = make.rle(px[:1]) + make.rgbe(px[1:])
    lines = [[], [b"# c"], [b"EXPOSURE=1.0"], [b"X" * 200]][
        int(rng.integers(0, 4))]
    magic = [b"#?RADIANCE", b"#?RGBE"][int(rng.integers(0, 2))]
    fmt = b"FORMAT=32-bit_rle_xyze" if rng.random() < 0.1 else \
        b"FORMAT=32-bit_rle_rgbe"
    res = [None, f"-Y{h}+X{w}".encode(), f"+Y {h} +X {w}".encode(),
           f"-Y  {h}   +X {w} ".encode()][int(rng.choice([0, 0, 0, 1, 2,
                                                          3]))]
    data = make.header(h, w, lines, magic, fmt, res) + body
    r = rng.random()
    if r < 0.1:
        data = data[:-int(rng.integers(1, 5))]
    elif r < 0.15:
        data = data + b"\0\0"
    return data


@pytest.mark.parametrize("chunk", range(2))
def test_random_files_as_cv2_reads_them(tmp_path, chunk):
    rng = np.random.default_rng(4300 + chunk)
    for i in range(60):
        data = _random_hdr(rng)
        try:
            hdr.decode_hdr(data, "random", file_path=True)
        except ValueError as e:
            if "uninitialised" in str(e):
                continue  # cv2 returns what its buffer held
        assert_like_cv2(tmp_path, data, ".hdr", i)
