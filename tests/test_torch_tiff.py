"""The port's TIFF reader (``utils/tiff.py``, LZW in
``runtime/csrc/lzw.cpp``) against PIL + libtiff, on the CPU; tolerance 0.

* Every fixture of ``tests/data/tiff/``: ``digests.json`` recomputed from
  the committed files with PIL, so it cannot drift; the port's RGB has the
  same digest through ``img_utils.decode_image`` on the body path (turned
  by the Orientation tag, as PIL turns it).  The files PIL refuses raise
  with their reason, and so does each variant the port refuses by name
  where PIL reads it (CCITT and ZSTD compression, float samples,
  uncompressed 16-bit planes).  On the file path, each equals its ``cv2``
  digest (``cv2.imread`` of the file, recomputed), or raises where cv2
  returns None; CCITT, which cv2 reads, raises by name.
* 160 seeded random TIFFs from the fixture script's writer (min-is-white /
  min-is-black gray at 1-16 bits, RGB at 8 / 16 bits with each kind of
  extra sample, palettes, every compression read, ``II`` / ``MM``, strips
  of any height, tiles, planar 2, the predictor): equal to PIL's
  ``convert("RGB")``, or refused where PIL refuses (or misreads
  uncompressed 16-bit planes).
* 120 seeded random TIFFs as files (the layouts above, CMYK, 8-bit
  colour maps, the Orientation tag 1-8): equal to ``cv2.imread`` (libtiff's
  ``TIFFRGBAImage``), refused where it returns None, and refused by name
  where OpenCV assembles tiles out of place.
"""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest

from PIL import Image

from crdr_tpu_torch.utils import img_utils, tiff
from tests.cv2_files import assert_fixture_file, cv2_rgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "tiff")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "tiff_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
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
    assert_fixture_file(os.path.join(FIXTURES, name), want,
                        want.get("file_refused", ""))
    if "pil" in want:  # PIL refuses it
        with pytest.raises(Exception) as e:
            Image.open(io.BytesIO(data)).convert("RGB")
        assert make._gif.pil_message(e.value) == want["pil"]
    else:
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert {k: want[k] for k in ("body", "body_shape")} == {
            "body": _sha(pil), "body_shape": list(pil.shape)}
    if "refused" in want:
        with pytest.raises(ValueError, match=f"^{name}: .*{want['refused']}"):
            img_utils.decode_image(data, name, file_path=False)
        return
    mine = img_utils.decode_image(data, name, file_path=False)
    assert list(mine.shape) == want["body_shape"]
    assert _sha(mine) == want["body"]


def _random_tiff(rng) -> bytes:
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    photo = int(rng.choice([0, 1, 2, 3]))
    extra = ()
    if photo == 2:
        bits = int(rng.choice([8, 16]))
        extra = [(), (0,), (1,), (2,)][int(rng.integers(0, 4))]
    elif photo == 3:
        bits = int(rng.choice([1, 2, 4, 8]))
    else:
        bits = int(rng.choice([1, 2, 4, 8, 16]))
        if bits == 8 and photo == 1 and rng.random() < 0.3:
            extra = (2,)
    spp = (3 if photo == 2 else 1) + len(extra)
    smp = rng.integers(0, 1 << bits, (h, w, spp))
    if photo == 2 and extra == (1,):  # premultiplied
        smp[..., :3] = np.minimum(smp[..., :3], smp[..., 3:4])
    comp = int(rng.choice([1, 5, 8, 32946, 32773]))
    planar = 2 if (spp > 1 and rng.random() < 0.4) else 1
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3 else None)
    rows = int(rng.integers(1, h + 1)) if rng.random() < 0.5 else None
    pred = 2 if (bits >= 8 and comp in (5, 8, 32946)
                 and rng.random() < 0.5) else 1
    cmap = rng.integers(0, 65536, 3 << bits) if photo == 3 else None
    return make.write_tiff(smp, bits, photo, comp,
                           "MM" if rng.random() < 0.4 else "II", planar,
                           rows, tile, pred, extra, cmap)


@pytest.mark.parametrize("chunk", range(4))
def test_random_tiffs_equal_to_pil(chunk):
    rng = np.random.default_rng(4000 + chunk)
    for i in range(40):
        data = _random_tiff(rng)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:  # noqa: BLE001 - PIL raises several types
            want = None
        if want is None or _uncompressed_16bit(data):
            with pytest.raises(ValueError, match="^random: "):
                tiff.decode_tiff(data, "random")
            continue
        got = tiff.decode_tiff(data, "random")
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), i


def _uncompressed_16bit(data: bytes) -> bool:
    """An uncompressed planar file of 16-bit samples, which PIL misreads
    (so the port refuses it)."""
    tags = tiff._ifd0(data, "random")
    return tags.get(259, [1])[0] == 1 and tags.get(258, [1])[0] == 16 \
        and tags.get(284, [1])[0] == 2 and tags.get(277, [1])[0] > 1


def _random_tiff_file(rng) -> bytes:
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
    photo = int(rng.choice([0, 1, 2, 3, 5]))
    extra, bits = (), 8
    if photo == 2:
        bits = int(rng.choice([8, 16]))
        extra = [(), (0,), (1,), (2,)][int(rng.integers(0, 4))]
    elif photo == 3:
        bits = int(rng.choice([1, 2, 4, 8]))
    elif photo in (0, 1):
        bits = int(rng.choice([1, 2, 4, 8, 16]))
        if bits >= 8 and rng.random() < 0.4:
            extra = [(0,), (1,), (2,)][int(rng.integers(0, 3))]
    spp = (3 if photo == 2 else 4 if photo == 5 else 1) + len(extra)
    smp = rng.integers(0, 1 << bits, (h, w, spp))
    comp = int(rng.choice([1, 5, 8, 32946, 32773]))
    planar = 2 if (spp > 1 and rng.random() < 0.4) else 1
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3 else None)
    rows = int(rng.integers(1, h + 1)) if rng.random() < 0.5 else None
    pred = 2 if (bits >= 8 and comp in (5, 8, 32946)
                 and rng.random() < 0.5) else 1
    cmap = None
    if photo == 3:  # libtiff reads a map of values under 256 as 8-bit
        top = 65536 if rng.random() < 0.7 else 256
        cmap = rng.integers(0, top, 3 << bits)
    o = int(rng.integers(1, 9)) if rng.random() < 0.4 else None
    return make.write_tiff(smp, bits, photo, comp,
                           "MM" if rng.random() < 0.4 else "II", planar,
                           rows, tile, pred, extra, cmap,
                           more_tags=[(274, 3, [o])] if o else ())


@pytest.mark.parametrize("chunk", range(4))
def test_random_tiff_files_as_cv2_reads_them(tmp_path, chunk):
    rng = np.random.default_rng(4100 + chunk)
    path = str(tmp_path / "random.tif")
    for i in range(30):
        data = _random_tiff_file(rng)
        with open(path, "wb") as f:
            f.write(data)
        want = cv2_rgb(path)
        try:
            got = img_utils.decode_image(data, "random", file_path=True)
        except ValueError as e:
            assert str(e).startswith("random: ")
            assert want is None or "assembles out of place" in str(e), i
            continue
        assert want is not None and got.shape == want.shape \
            and got.tobytes() == want.tobytes(), i
