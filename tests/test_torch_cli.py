"""The port's compress CLI (``python -m crdr_tpu_torch.cli.compress``), its
``.bin`` container and its PNG I/O, on the CPU.

* PNG: ``read_png`` / ``imread`` against cv2 on random RGB, RGBA and gray
  images written by cv2 with its adaptive row filters, and on RGB with each
  of the five filters forced; ``write_png`` read back by cv2; a damaged
  chunk and a ``.jpg`` raise.
* ``.bin``: byte-identical to the JAX package's container, both ways.
* The CLI on a tiny config at ``-d cpu``: each ``.bin`` holds exactly
  ``compress_batch``'s streams, ``_bitrates.csv`` has the JAX CLI's columns
  in its order, ``_avg_bitrate.json`` is the mean real bpp, each decoded
  ``.png`` is ``decompress_batch``'s image, ``--batch 2`` writes the
  streams ``--batch 1`` writes, on both wires.
"""

import csv
import json
import os
import zlib

import numpy as np
import pytest
import yaml

import cv2
import torch

from crdr_tpu.utils import codec_utils as jax_codec_utils
from crdr_tpu_torch.cli import compress as cli
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.utils import codec_utils, img_utils
from crdr_tpu_torch.utils.config import Config
from tests.torch_pairs import (BETA, images,  # noqa: F401
                               one_torch_thread, tiny_config)

JAX_COLUMNS = ["name", "header_bit", "z_bit", "y_bit", "real_bit", "real_bpp",
               "pred_y_bpp", "pred_z_bpp", "pred_bpp", "enc_time", "dec_time"]


# ---------------- PNG -----------------------------------------------------------

def _filters_used(path):
    """The row filter bytes of a PNG's image data (8-bit, any channels)."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            header = data[pos + 8:pos + 8 + n]
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = int.from_bytes(header[:4], "big"), int.from_bytes(header[4:8],
                                                             "big")
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[header[9]]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert raw.shape[1] == w * ch + 1
    return set(raw[:, 0].tolist())


def _textured(h, w, ch, seed):
    """Smooth ramps (which cv2 filters with Sub / Up / Average / Paeth)
    beside noise (filter None)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 3 + yy * 2)[..., None] + np.arange(ch) * 40
    img = np.where((xx < w // 2)[..., None], smooth,
                   rng.integers(0, 256, (h, w, ch)))
    return (img % 256).astype(np.uint8)


_ADAPTIVE = cv2.IMWRITE_PNG_ALL_FILTERS
_ONE_FILTER = {cv2.IMWRITE_PNG_FILTER_NONE: 0, cv2.IMWRITE_PNG_FILTER_SUB: 1,
               cv2.IMWRITE_PNG_FILTER_UP: 2, cv2.IMWRITE_PNG_FILTER_AVG: 3,
               cv2.IMWRITE_PNG_FILTER_PAETH: 4}


@pytest.mark.parametrize("ch,filters", [(3, _ADAPTIVE), (4, _ADAPTIVE),
                                        (1, _ADAPTIVE)]
                         + [(3, f) for f in _ONE_FILTER])
def test_read_png_matches_cv2(ch, filters, tmp_path):
    img = _textured(37, 53, ch, seed=ch)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img if ch > 1 else img[..., 0],
                       [cv2.IMWRITE_PNG_FILTER, filters])
    used = _filters_used(path)
    if filters == _ADAPTIVE:
        assert len(used) >= 3, used  # libpng picks a filter a row
    else:
        assert _ONE_FILTER[filters] in used
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    got = img_utils.read_png(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(img_utils.imread(path),
                                  img_utils.uint8_to_tensor(want))


def test_write_png_reads_back_in_cv2_and_imwrite_rounds(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (29, 41, 3), np.uint8)
    path = str(tmp_path / "sub" / "y.png")
    img_utils.write_png(path, img)
    assert _filters_used(path) == {0}
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    img_utils.imwrite(path, img_utils.uint8_to_tensor(img)[None])
    np.testing.assert_array_equal(img_utils.read_png(path), img)


def test_png_errors(tmp_path):
    path = str(tmp_path / "x.png")
    img_utils.write_png(path, np.zeros((4, 4, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF  # inside IDAT
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        img_utils.read_png(bad)
    jpg = str(tmp_path / "photo.jpg")
    assert cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="photo.jpg"):
        img_utils.imread(jpg)
    with pytest.raises(ValueError, match="out.jpeg"):
        img_utils.imwrite(str(tmp_path / "out.jpeg"), np.zeros((4, 4, 3)))


# ---------------- .bin container --------------------------------------------------

def test_bin_container_matches_jax(tmp_path):
    strings = [b"\x01\x02", b"", bytes(range(256)) * 3]
    blob = codec_utils.pack_byte_strings(strings)
    assert blob == jax_codec_utils.pack_byte_strings(strings)
    assert codec_utils.unpack_byte_strings(blob) == strings
    path = str(tmp_path / "a.bin")
    codec_utils.save_byte_strings(path, strings)
    assert jax_codec_utils.load_byte_strings(path) == strings
    jax_codec_utils.save_byte_strings(path, strings[::-1])
    assert codec_utils.load_byte_strings(path) == strings[::-1]
    with pytest.raises(ValueError, match="truncated"):
        codec_utils.unpack_byte_strings(blob[:-1])


# ---------------- the CLI -------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny flagship-family config (a YAML file) and 5 PNGs: 3 of 64x96,
    then 2 of 80x64."""
    root = tmp_path_factory.mktemp("cli")
    img_dir = root / "img"
    for i, (h, w) in enumerate([(64, 96)] * 3 + [(80, 64)] * 2):
        img_utils.write_png(str(img_dir / f"im{i}.png"),
                            images(1, h, w, seed=i)[0])
    cfg = tiny_config("InterpCaHyperpriorCharmModel", seed=3).to_dict()
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return root


def _run(workdir, out, *flags):
    return cli.main([str(workdir / "tiny.yaml"), "--img_dir",
                     str(workdir / "img"), "--save_dir", str(out), "-q",
                     "1.5", "-b", str(BETA), "-d", "cpu", *flags])


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_cli_outputs_equal_the_model_api(workdir, wire, tmp_path):
    avg = _run(workdir, tmp_path / "b2", "--decompress", "--batch", "2",
               "--wire", wire)
    _run(workdir, tmp_path / "b1", "--wire", wire)

    cfg = Config.from_file(str(workdir / "tiny.yaml"))
    cfg.update(wire_format=wire, device_wire_encoder="host")
    model = build_comp_model(cfg, device="cpu")
    model.codec_setup()
    names = [f"im{i}" for i in range(5)]
    groups = [names[:2], names[2:3], names[3:]]  # --batch 2 by size
    real_bpps = []
    for group in groups:
        imgs = np.stack([img_utils.imread(str(workdir / "img" / f"{n}.png"))
                         for n in group])
        encs = model.compress_batch(imgs, rate_ind=1.5)
        fake, _, _ = model.decompress_batch([e["string_list"] for e in encs],
                                            beta=BETA)
        for j, (name, enc) in enumerate(zip(group, encs)):
            for sub in ("b2", "b1"):
                assert codec_utils.load_byte_strings(
                    str(tmp_path / sub / f"{name}.bin")) == enc["string_list"]
            size = len(codec_utils.pack_byte_strings(enc["string_list"]))
            real_bpps.append(size * 8 / (imgs.shape[1] * imgs.shape[2]))
            np.testing.assert_array_equal(
                img_utils.read_png(str(tmp_path / "b2" / f"{name}.png")),
                img_utils.tensor_to_uint8(fake[j]))
    assert avg == pytest.approx(np.mean(real_bpps), rel=1e-12)
    with open(tmp_path / "b2" / "_avg_bitrate.json") as f:
        assert json.load(f) == {"avg_bpp": avg}
    with open(tmp_path / "b2" / "_bitrates.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == JAX_COLUMNS
    assert [r["name"] for r in rows] == names
    for r, bpp in zip(rows, real_bpps):
        assert float(r["real_bpp"]) == pytest.approx(bpp, rel=1e-12)
        assert int(r["real_bit"]) == int(r["header_bit"]) + int(r["z_bit"]) \
            + int(r["y_bit"]) + 3 * 32
        assert float(r["pred_bpp"]) == pytest.approx(
            float(r["pred_y_bpp"]) + float(r["pred_z_bpp"]))
    with open(tmp_path / "b1" / "_bitrates.csv") as f:
        assert list(next(csv.DictReader(f))) == JAX_COLUMNS[:-1]
    assert not os.path.exists(tmp_path / "b1" / "im0.png")


def test_cli_refuses_what_is_not_ported(workdir, tmp_path):
    with pytest.raises(NotImplementedError, match="serving_devices"):
        _run(workdir, tmp_path, "--serving_devices", "2")
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([str(workdir / "tiny.yaml"), "--img_dir",
                      str(workdir / "img"), "--save_dir", str(tmp_path)])
