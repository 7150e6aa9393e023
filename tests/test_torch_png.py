"""The port's PNG reader (``utils/png.py``, ``runtime/csrc/png.cpp``)
against cv2 and PIL, on the CPU; tolerance 0 throughout.

* Every fixture of ``tests/data/png/``: ``digests.json`` recomputed from
  the committed files with ``cv2.imread`` (the file path, EXIF orientation
  applied) and PIL's ``convert("RGB")`` (the body path), so it cannot
  drift; the port's pixels have the same digests on each path, through the
  C++ decoder and through its numpy twin.  The refused fixtures raise with
  the file's name and their reason, and cv2 refuses them too.
* 240 seeded random PNGs (colour type, bit depth, interlacing, each row's
  filter, palette size, tRNS drawn at random) equal to ``cv2.imread`` of
  the file and to PIL's read of the bytes, and the twin equal to the C++.
* The refusals, each path against its oracle.
* The EXIF orientation of a PNG file: the port's ``imread`` equals the JAX
  package's at orientations 1-8.
* No reader falls back to the twin when the C++ library fails; decoding in
  several threads.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import cv2
from PIL import Image

from crdr_tpu.utils.img_utils import imread as jax_imread
from crdr_tpu_torch.utils import img_utils, png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "png")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
_spec = importlib.util.spec_from_file_location(
    "png_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


def _sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def _cv2_file(tmp_path, data: bytes):
    """``cv2.imread`` of ``data`` written to a file, RGB (None if it
    refuses): the JAX package's reader of files.  ``cv2.imdecode`` of the
    bytes is not the same reader: it gives an APNG's first frame."""
    path = str(tmp_path / "oracle.png")
    with open(path, "wb") as f:
        f.write(data)
    try:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:  # e.g. past CV_IO_MAX_IMAGE_PIXELS
        return None
    return None if bgr is None else bgr[..., ::-1]


def _pil_body(data: bytes):
    """PIL's ``convert("RGB")`` of ``data`` (the exception if it
    refuses): the JAX package's reader of request bodies."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - PIL raises several types
        return e


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests(name):
    path = os.path.join(FIXTURES, name)
    want = DIGESTS[name]
    with open(path, "rb") as f:
        data = f.read()
    if "raises" in want:
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match=want["raises"]) as e:
            img_utils.read_image(path)
        assert path in str(e.value)
        for file_path in (True, False):
            with pytest.raises(ValueError, match=want["raises"]):
                png.decode_png_plain(data, name, file_path)
        return
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert want == {"file": _sha(bgr[..., ::-1]),
                    "file_shape": list(bgr.shape),
                    "body": _sha(pil), "body_shape": list(pil.shape)}
    for file_path, key in ((True, "file"), (False, "body")):
        mine = png.decode_png(data, name, file_path)
        assert list(mine.shape) == want[f"{key}_shape"], key
        assert _sha(mine) == want[key], key
        np.testing.assert_array_equal(
            png.decode_png_plain(data, name, file_path), mine)
    np.testing.assert_array_equal(img_utils.read_image(path), bgr[..., ::-1])
    np.testing.assert_array_equal(
        img_utils.decode_image(data, name, file_path=False), pil)


def _random_png(rng) -> bytes:
    """One seeded PNG of a random colour type, depth, interlacing, size,
    row filters, palette and tRNS."""
    color = int(rng.choice([0, 2, 3, 4, 6]))
    depth = int(rng.choice(make.DEPTHS[color]))
    interlace = int(rng.random() < 0.5)
    h, w = (int(v) for v in rng.integers(1, 41, 2))
    top = (1 << depth) - 1
    ch = make.CHANNELS[color]
    samples = rng.integers(0, top + 1, (h, w, ch))
    if depth == 16 and rng.random() < 0.5:  # values below 256 too
        samples = samples >> int(rng.integers(1, 16))
    palette = trns = None
    if color == 3:  # a palette shorter than the indexes now and then
        n = int(rng.integers(1, top + 2))
        palette = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        if rng.random() < 0.5:
            trns = rng.integers(0, 256, int(rng.integers(1, n + 1)),
                                dtype=np.uint8).tobytes()
    elif color in (0, 2) and rng.random() < 0.3:
        trns = struct.pack(f">{ch}H", *(int(v) for v in samples[0, 0]))
    filters = rng.integers(0, 5, (7, h))
    return make.write_png(samples, depth, color, interlace,
                          lambda p, r: int(filters[p, r]), palette, trns,
                          idat_parts=int(rng.integers(1, 4)))


@pytest.mark.parametrize("chunk", range(8))
def test_random_pngs_equal_cv2_and_pil(chunk, tmp_path):
    rng = np.random.default_rng(2000 + chunk)
    for i in range(30):
        data = _random_png(rng)
        ref_file, ref_body = _cv2_file(tmp_path, data), _pil_body(data)
        for file_path, ref in ((True, ref_file), (False, ref_body)):
            got = png.decode_png(data, f"case {chunk}/{i}", file_path)
            assert got.shape == ref.shape, (chunk, i, file_path)
            assert got.tobytes() == ref.tobytes(), (chunk, i, file_path)
            np.testing.assert_array_equal(
                png.decode_png_plain(data, "twin", file_path), got)


def _variant(kind: str) -> bytes:
    """A PNG with one fault (``test_refusals``)."""
    s, _ = make.samples_for(2, 8, 6, 9, 5)
    good = make.write_png(s, 8, 2)
    ihdr = good[8:33]
    idat = good[33:-12]
    iend = good[-12:]

    def bad_crc(c: bytes) -> bytes:
        return c[:-1] + bytes([c[-1] ^ 1])

    text = make.chunk(b"tEXt", b"a\0b")
    z = zlib.compress(make.image_data(s, 8, 2, 0, lambda p, r: 0))
    return {
        "crc_ihdr": make.SIGNATURE + bad_crc(ihdr) + idat + iend,
        "crc_idat": make.SIGNATURE + ihdr + bad_crc(idat) + iend,
        "crc_iend": make.SIGNATURE + ihdr + idat + bad_crc(iend),
        "crc_ancillary_before": make.SIGNATURE + ihdr + bad_crc(text)
        + idat + iend,
        "crc_ancillary_after": make.SIGNATURE + ihdr + idat + bad_crc(text)
        + iend,
        "no_iend": make.SIGNATURE + ihdr + idat,
        "no_ihdr": make.SIGNATURE + idat + iend,
        "unknown_critical": make.SIGNATURE + ihdr
        + make.chunk(b"ABCD", b"") + idat + iend,
        "unknown_ancillary": make.SIGNATURE + ihdr
        + make.chunk(b"abCD", b"x") + idat + iend,
        "bad_depth": make.SIGNATURE + make.chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 9, 6, 4, 2, 0, 0, 0)) + idat + iend,
        "corrupt_zlib": make.SIGNATURE + ihdr + make.chunk(
            b"IDAT", z[:10] + bytes(20) + z[30:]) + iend,
        "extra_data": make.SIGNATURE + ihdr + make.chunk(
            b"IDAT", zlib.compress(zlib.decompress(z) + bytes(9))) + iend,
        "extra_compressed": make.SIGNATURE + ihdr + make.chunk(
            b"IDAT", z + b"junk") + iend,
        "truncated_chunk": good[:50],
        "signature_only": make.SIGNATURE,
        "too_many_pixels": make.SIGNATURE + make.chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 1 << 16, 1 << 15, 8, 2, 0, 0, 0)) + idat + iend,
    }[kind]


# kind -> (the port's file refusal, its body refusal); None reads the
# image.  Each path is held to its oracle where the port mirrors it; the
# body path is stricter than PIL on an IDAT CRC (PIL skips IDAT CRCs).
REFUSALS = {
    "crc_ihdr": ("CRC mismatch in PNG chunk b'IHDR'",) * 2,
    "crc_idat": ("CRC mismatch in PNG chunk b'IDAT'",) * 2,
    "crc_iend": (None, None),
    "crc_ancillary_before": (None, "CRC mismatch in PNG chunk b'tEXt'"),
    "crc_ancillary_after": (None, None),
    "no_iend": ("PNG without IEND", None),
    "no_ihdr": ("PNG without IHDR",) * 2,
    "unknown_critical": ("unknown critical PNG chunk b'ABCD'", None),
    "unknown_ancillary": (None, None),
    "bad_depth": ("invalid PNG header",) * 2,
    "corrupt_zlib": ("corrupt PNG image data",) * 2,
    "extra_data": (None, None),
    "extra_compressed": (None, None),
    "truncated_chunk": ("truncated PNG chunk b'IDAT'",) * 2,
    "signature_only": ("PNG without IEND", "PNG without IHDR"),
    "too_many_pixels": ("invalid PNG header",) * 2,
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals(kind, tmp_path):
    data = _variant(kind)
    oracles = (_cv2_file(tmp_path, data), _pil_body(data))
    for file_path, why, ref in zip((True, False), REFUSALS[kind], oracles):
        if why is None:
            np.testing.assert_array_equal(
                png.decode_png(data, kind, file_path), ref)
            continue
        if file_path:
            assert ref is None, kind
        elif kind != "crc_idat":
            assert isinstance(ref, Exception), kind
        for decode in (png.decode_png, png.decode_png_plain):
            with pytest.raises(ValueError, match=f"^{kind}: {why}"):
                decode(data, kind, file_path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_as_the_jax_package_reads_it(orientation):
    """The parent read every PNG upright as stored; cv2 (and so the JAX
    package's ``imread``) applies the ``eXIf`` orientation of a file."""
    path = os.path.join(FIXTURES, f"exif_orientation_{orientation}.png")
    want = jax_imread(path)
    got = img_utils.imread(path)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:  # a request body is read as stored
        body = img_utils.decode_image(f.read(), "body", file_path=False)
    assert body.shape == (21, 34, 3)


def test_no_fallback_to_the_twin_and_threads(monkeypatch):
    paths = [os.path.join(FIXTURES, n) for n in sorted(DIGESTS)
             if "raises" not in DIGESTS[n] and not n.startswith("photo")] * 2
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(img_utils.read_image, paths))
    for p, g in zip(paths, got):
        assert _sha(g) == DIGESTS[os.path.basename(p)]["file"]

    def broken():
        raise RuntimeError("building crdr_png failed")

    monkeypatch.setattr(png, "_get_lib", broken)
    with pytest.raises(RuntimeError, match="crdr_png"):
        img_utils.read_image(paths[0])
