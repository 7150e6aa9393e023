"""Image files read by their bytes as ``cv2.imread`` reads them, and TIFF
bodies turned as PIL turns them; on the CPU, tolerance 0.

* F1: PIL applies a TIFF's Orientation tag (274) when it loads a body;
  the port's body path does too: orientations 1-8, raw, LZW and Deflate,
  against ``Image.open(...).convert("RGB")``.
* F2: ``cv2.imread`` picks its decoder by a file's content, so a WebP, a
  GIF, a PNM, a TIFF, a JPEG 2000, a Sun raster or a Radiance HDR named
  ``*.jpg`` is read by the JAX package's ``imread`` and its
  ``OpenImageImageDataset``; the port's ``read_image`` and its dataset
  give the same pixels, exactly (JAX's own ``imread`` the oracle).
* libjpeg's block smoothing and arithmetic decoding on seeded random
  files at small sizes: progressive files with their scans cut (Huffman
  and arithmetic, each against ``cv2.imread`` of a file and PIL), and
  cut at random points (the file path against ``cv2.imread``).
"""

import importlib.util
import io
import os

import numpy as np
import pytest

import cv2
from PIL import Image

from crdr_tpu.data import build_dataset as jax_dataset
from crdr_tpu.utils.img_utils import imread as jax_imread
from crdr_tpu_torch.data import build_dataset
from crdr_tpu_torch.utils import img_utils, tiff
from crdr_tpu_torch.utils.jpeg import decode_jpeg
from tests.cv2_files import cv2_rgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _maker(fmt: str):
    spec = importlib.util.spec_from_file_location(
        f"{fmt}_fixtures", os.path.join(ROOT, "tests", "data", fmt,
                                        "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TIFF = _maker("tiff")
JPEG = _maker("jpeg")
SUN = _maker("sunras")


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("comp", [1, 5, 8])
def test_f1_tiff_body_turned_by_orientation_as_pil(comp, orientation):
    img = TIFF.synthetic(48, 64, 3, 8, orientation).astype(np.uint8)
    data = TIFF.write_tiff(img, 8, 2, comp, more_tags=[(274, 3,
                                                        [orientation])])
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = img_utils.decode_image(data, "body", file_path=False)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    if orientation >= 5:
        assert got.shape == (64, 48, 3)


def _misnamed(folder, seed: int) -> dict:
    """A WebP, a GIF, a PNM, a TIFF, a JPEG 2000, a Sun raster and a
    Radiance HDR, each named ``*.jpg``: {name: format}."""
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)

    def img(h, w):
        return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                                (0, 0), 1.5)

    out = {}
    for i, (fmt, kw) in enumerate([("WEBP", {"quality": 80}),
                                   ("GIF", {}), ("PPM", {}),
                                   ("TIFF", {"compression": "tiff_lzw"})]):
        im = Image.fromarray(img(44 + 3 * i, 58 - 2 * i))
        if fmt == "GIF":
            im = im.quantize(64)
        name = f"img_{i}.jpg"
        im.save(str(folder / name), fmt, **kw)
        out[name] = fmt
    out["img_4.jpg"] = "JPEG2000"
    Image.fromarray(img(41, 51)).save(str(folder / "img_4.jpg"), "JPEG2000",
                                      irreversible=True)
    out["img_5.jpg"] = "SUN"
    (folder / "img_5.jpg").write_bytes(SUN.sun(img(39, 45)[..., ::-1], 24))
    out["img_6.jpg"] = "HDR"
    cv2.imwrite(str(folder / "img_6.hdr"), img(37, 49).astype(np.float32)
                / 180)
    (folder / "img_6.hdr").rename(folder / "img_6.jpg")
    return out


@pytest.mark.parametrize("fmt", ["WEBP", "GIF", "PPM", "TIFF", "JPEG2000",
                                 "SUN", "HDR"])
def test_f2_misnamed_files_read_by_content_as_jax(tmp_path, fmt):
    files = _misnamed(tmp_path, 7)
    name = next(n for n, f in files.items() if f == fmt)
    path = str(tmp_path / name)
    want = jax_imread(path)
    got = img_utils.imread(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_f2_openimage_tree_of_misnamed_files_as_jax(tmp_path):
    _misnamed(tmp_path / "oi" / "train_0", 1)
    _misnamed(tmp_path / "oi" / "validation", 2)
    opt = {"name": "", "type": "OpenImageImageDataset",
           "root_dir": str(tmp_path / "oi"), "subset_list": [0],
           "image_size": 32, "seed": 3}
    for is_train in (True, False):
        mine, ref = build_dataset(opt, is_train), jax_dataset(opt, is_train)
        assert len(mine) == len(ref) == 7
        for i in range(7):
            a, b = mine[i]["real_images"], ref[i]["real_images"]
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _image(rng, h: int, w: int, gray: bool) -> Image.Image:
    yy, xx = np.mgrid[0:h, 0:w]
    f = rng.uniform(0.02, 0.3, 3)
    a = np.stack([128 + 100 * np.sin(f[0] * xx + 0.05 * yy),
                  128 + 90 * np.cos(f[1] * yy),
                  128 + 80 * np.sin(f[2] * (xx - yy))], -1)
    a = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)
    return Image.fromarray(a[..., 0] if gray else a)


def _cv2_file(tmp_path, data: bytes, name: str = "cut.jpg"):
    """``cv2.imread``'s RGB of ``data`` written as a file, or None."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return cv2_rgb(path)


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # noqa: BLE001 - PIL raises several types
        return None


def _check(want, data: bytes, file_path: bool, what: str) -> None:
    if want is None:
        with pytest.raises(ValueError, match="^cut: "):
            decode_jpeg(data, "cut", file_path=file_path)
        return
    got = decode_jpeg(data, "cut", file_path=file_path)
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), what


def _random_progressive(rng, arith: bool) -> bytes:
    gray = rng.random() < 0.25
    h, w = (int(v) for v in rng.integers(8, 60, 2))
    b = io.BytesIO()
    kw = {} if gray else {"subsampling": int(rng.integers(0, 3))}
    if arith:
        _image(rng, h, w, gray).save(b, "JPEG", quality=int(
            rng.integers(30, 95)), **kw)
        script = JPEG.SCRIPT1 if gray else JPEG.SCRIPT3
        return JPEG.arith_jpeg(JPEG.huffman_coefficients(b.getvalue()),
                               script=script,
                               restart=int(rng.choice([0, 0, 2, 5])))
    _image(rng, h, w, gray).save(b, "JPEG", quality=int(rng.integers(
        30, 95)), progressive=True, **kw)
    return b.getvalue()


@pytest.mark.parametrize("arith", [False, True])
@pytest.mark.parametrize("chunk", range(3))
def test_smoothing_with_scans_cut_out(tmp_path, chunk, arith):
    """Scans cut out of a progressive file (and the later ones that
    refine what they carried): libjpeg smooths the blocks; both paths."""
    rng = np.random.default_rng(7000 + 10 * chunk + arith)
    for i in range(12):
        data = _random_progressive(rng, arith)
        n = sum(p[:2] == b"\xff\xda" for p in JPEG.scans(data)[1])
        drop = set(rng.choice(np.arange(1, n), int(rng.integers(
            1, min(n, 4))), replace=False).tolist())
        cut = JPEG.without_scans(data, drop)
        _check(_cv2_file(tmp_path, cut), cut, True, (i, "file"))
        _check(_pil(cut), cut, False, (i, "body"))


@pytest.mark.parametrize("arith", [False, True])
@pytest.mark.parametrize("chunk", range(3))
def test_random_cuts_as_cv2_reads_a_file(tmp_path, chunk, arith):
    """Progressive (and sequential arithmetic) files cut at seeded random
    points: the file path against ``cv2.imread`` (libjpeg's partial image,
    smoothed where the scans read so far leave coefficients unrefined, or
    None), the body path refuses as PIL does."""
    rng = np.random.default_rng(8000 + 10 * chunk + arith)
    for i in range(40):
        data = _random_progressive(rng, arith)
        if arith and i % 3 == 0:  # a sequential arithmetic file
            b = io.BytesIO()
            _image(rng, 37, 29, False).save(b, "JPEG", quality=80)
            data = JPEG.arith_jpeg(JPEG.huffman_coefficients(b.getvalue()),
                                   restart=int(rng.choice([0, 3])))
        cut = data[:int(rng.integers(len(data) // 8, len(data)))]
        _check(_cv2_file(tmp_path, cut), cut, True, (i, len(cut)))
        if _pil(cut) is None:
            with pytest.raises(ValueError, match="^cut: "):
                decode_jpeg(cut, "cut", file_path=False)


def test_tiff_tiles_cv2_assembles_out_of_place_are_refused(tmp_path):
    """Tiled TIFFs that OpenCV's reader assembles out of place (gray with
    an extra sample or at 16 bits; mirrored by orientation 2, 3, 6 or 7
    across more than one column of tiles): cv2.imread returns rows of
    zeros and of other tiles' bytes; the port's file path refuses them by
    name and reads the layouts OpenCV places."""
    rng = np.random.default_rng(3)
    for bits, extra, o in ((16, (), 1), (8, (2,), 1), (8, (), 2)):
        s = rng.integers(0, 1 << bits, (20, 20, 1 + len(extra)))
        data = TIFF.write_tiff(s, bits, 1, 1, tile=(16, 16), extra=extra,
                               more_tags=[(274, 3, [o])])
        with pytest.raises(ValueError, match="assembles out of place"):
            tiff.decode_tiff(data, "tiles", file_path=True)
        want = _cv2_file(tmp_path, data, "t.tif")
        assert want is not None
        ok = tiff.decode_tiff(data, "tiles", file_path=False)  # PIL's way
        assert ok.shape == want.shape and not np.array_equal(ok, want)
    s = rng.integers(0, 256, (20, 20, 3))
    for o, tile in ((4, (16, 16)), (2, (32, 16)), (6, (32, 32))):
        data = TIFF.write_tiff(s, 8, 2, 5, tile=tile,
                               more_tags=[(274, 3, [o])])
        got = tiff.decode_tiff(data, "tiles", file_path=True)
        assert got.tobytes() == _cv2_file(tmp_path, data, "t.tif").tobytes()
