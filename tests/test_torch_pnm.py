"""The port's PNM reader (``utils/pnm.py``) against PIL, on the CPU;
tolerance 0.

* Every fixture of ``tests/data/pnm/``: ``digests.json`` recomputed from
  the committed files with PIL, so it cannot drift; the port's RGB has the
  same digest through ``img_utils.decode_image`` on the body path.  The
  files PIL refuses raise with their reason.  On the file path, each
  equals its ``cv2`` digest (``cv2.imread`` of the file, recomputed), or
  raises where cv2 returns None (OpenCV's ``grfmt_pxm.cpp``: raw samples
  as they are, a 16-bit one's high byte, plain ones clipped to the maxval
  and scaled by ``255 // maxval``; colour PFM by its scale).
* 240 seeded random PNMs (P1 to P6, maxvals 1-65535, whitespace and
  comments in the header and the plain data, truncated data, samples past
  the maxval): equal to PIL's ``convert("RGB")``, or refused where PIL
  refuses; 120 more as files, equal to ``cv2.imread``.
"""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import img_utils, pnm
from tests.cv2_files import assert_fixture_file, assert_like_cv2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "pnm")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "pnm_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
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


def _random_pnm(rng, i: int) -> bytes:
    def ws():
        return [b" ", b"\n", b"\t", b"  ", b"\r\n", b" #c x\n",
                b"\n# hi\r"][int(rng.integers(0, 7))]

    magic = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6")[i % 6]
    h, w = int(rng.integers(1, 12)), int(rng.integers(1, 12))
    maxval = int(rng.choice([1, 7, 15, 255, 256, 1000, 65535]))
    bands = 3 if magic in (b"P3", b"P6") else 1
    head = magic + ws() + str(w).encode() + ws() + str(h).encode()
    if magic not in (b"P1", b"P4"):
        head += ws() + str(maxval).encode()
    head += [b" ", b"\n", b"\t"][int(rng.integers(0, 3))]
    n = w * h * bands
    if magic == b"P1":
        body = b"".join([b"0", b"1"][int(rng.integers(0, 2))]
                        + [b"", b" ", b"\n", b" # c\n"][int(rng.integers(0, 4))]
                        for _ in range(n))
    elif magic == b"P4":
        body = rng.integers(0, 256, ((w + 7) // 8) * h).astype(
            np.uint8).tobytes()
    else:
        past = 3 if i % 11 == 0 else 0  # now and then a sample past maxval
        vals = rng.integers(0, maxval + 1 + past, n)
        if magic in (b"P2", b"P3"):
            body = b"".join(str(int(v)).encode() + ws() for v in vals)
        else:
            body = vals.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    if i % 13 == 0:
        body = body[:len(body) // 2]
    return head + body + (b"\n" if i % 3 else b"")


@pytest.mark.parametrize("chunk", range(4))
def test_random_pnms_equal_to_pil(chunk):
    rng = np.random.default_rng(3000 + chunk)
    for i in range(60):
        data = _random_pnm(rng, i)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # noqa: BLE001 - PIL raises several types
            with pytest.raises(ValueError, match="^random: "):
                pnm.decode_pnm(data, "random")
            continue
        got = pnm.decode_pnm(data, "random")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


@pytest.mark.parametrize("chunk", range(2))
def test_random_pnm_files_as_cv2_reads_them(tmp_path, chunk):
    rng = np.random.default_rng(3100 + chunk)
    for i in range(60):
        data = _random_pnm(rng, i)
        if i % 7 == 0:  # the last number ends the data
            data = data.rstrip()
        assert_like_cv2(tmp_path, data, ".pnm", i)
