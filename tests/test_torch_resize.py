"""The train transform's ``resize_range`` in the port, on the CPU.

* ``data/resize.py::resize_linear_u8`` against ``cv2.resize(...,
  INTER_LINEAR)`` on uint8 images: byte-equal (tolerance 0) down and up,
  odd sizes, one axis only, an exact 0.5 scale (cv2's area fast path), a
  1-pixel source or output edge, and 400 seeded random shapes.
* ``resize_cubic_u8``, ``resize_linear_f32`` and ``resize_cubic_f32``
  against ``cv2.resize`` (cv2 with Intel IPP) over 250 seeded sources of
  64-400 pixels a side at scales in [0.5, 1.3], held to the contract of
  ``data/resize.py``'s docstring: bicubic uint8 at most 1e-4 of the bytes
  apart, none by more than one level; float32 within 6e-5.
* The bicubic uint8 and the float32 pairs (``interpolation: bicubic`` /
  ``bilinear``, ``uint8_io`` on / off), once refused, run through the
  dataset and the shuffling loader against the JAX package's loader (which
  calls cv2), under the same contract.
* Batches with bilinear ``resize_range`` on uint8, byte-equal to the JAX
  package's loader, for two epochs.
"""

import numpy as np
import pytest
import torch

import cv2

from crdr_tpu.data import DataLoader as JaxLoader
from crdr_tpu.data import build_dataset as jax_dataset
from crdr_tpu_torch.data import DataLoader, build_dataset
from crdr_tpu_torch.data.resize import (resize_cubic_f32, resize_cubic_u8,
                                        resize_linear_f32, resize_linear_u8)
from crdr_tpu_torch.utils.img_utils import write_png


def _cv2(img, w, h):
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("src,dst", [
    ((37, 53), (23, 31)),      # odd, down
    ((40, 60), (79, 119)),     # odd, up
    ((64, 96), (32, 48)),      # exact 0.5: cv2's area fast path
    ((63, 95), (31, 47)),      # just off 0.5: the generic path
    ((64, 96), (64, 48)),      # one axis halved only
    ((512, 768), (300, 450)),  # the recipe's scale range at full size
    ((1, 9), (1, 5)),          # 1-pixel source row
    ((7, 1), (3, 4)),          # 1-pixel source column
    ((9, 13), (1, 1)),         # 1-pixel output
    ((5, 5), (5, 5)),          # same size: a copy
])
def test_linear_u8_matches_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    got = resize_linear_u8(img, (dst[1], dst[0]))
    ref = _cv2(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def test_linear_u8_matches_cv2_on_random_shapes():
    rng = np.random.default_rng(1)
    for _ in range(400):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        if rng.random() < 0.3:  # the train transform's own draws
            s = rng.uniform(0.5, 1.0)
            dh, dw = max(int(h * s), 1), max(int(w * s), 1)
        else:
            dh, dw = (int(v) for v in rng.integers(1, 120, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert resize_linear_u8(img, (dw, dh)).tobytes() == \
            _cv2(img, dw, dh).tobytes(), (h, w, dh, dw)


def test_linear_u8_smooth_image_and_bad_inputs():
    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1).astype(np.uint8)
    for dw, dh in [(45, 33), (100, 77), (32, 24)]:
        assert resize_linear_u8(img, (dw, dh)).tobytes() == \
            _cv2(img, dw, dh).tobytes()
    with pytest.raises(ValueError, match="uint8 HWC"):
        resize_linear_u8(img.astype(np.float32), (10, 10))
    with pytest.raises(ValueError, match="bad output size"):
        resize_linear_u8(img, (0, 10))


def _contract_sources(n: int, seed: int):
    """Seeded (image, dst width, dst height): sources of 64-400 pixels a
    side, half of them smoothed, at scales uniform in [0.5, 1.3]."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(64, 401, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if rng.random() < 0.5:
            img = cv2.GaussianBlur(img, (0, 0), 2.0)
        s = rng.uniform(0.5, 1.3)
        yield img, max(int(w * s), 1), max(int(h * s), 1)


def _assert_u8_contract(got_ref_pairs) -> float:
    """At most 1e-4 of the bytes apart, none by more than one level;
    returns the fraction apart."""
    apart = total = 0
    for got, ref in got_ref_pairs:
        assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
        d = np.abs(got.astype(np.int16) - ref)
        assert int(d.max()) <= 1
        apart += int(np.count_nonzero(d))
        total += d.size
    assert apart <= 1e-4 * total, (apart, total)
    return apart / total


def test_cubic_u8_within_contract_on_250_sources():
    pairs = ((resize_cubic_u8(img, (dw, dh)),
              cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC))
             for img, dw, dh in _contract_sources(250, 16))
    _assert_u8_contract(pairs)


@pytest.mark.parametrize("fn,flag", [(resize_linear_f32, cv2.INTER_LINEAR),
                                     (resize_cubic_f32, cv2.INTER_CUBIC)])
def test_float32_within_6e5_on_250_sources(fn, flag):
    worst = 0.0
    for img, dw, dh in _contract_sources(250, 17):
        x = (img.astype(np.float32) / 255.0 - 0.5) * 2.0  # uint8_to_tensor
        got, ref = fn(x, (dw, dh)), cv2.resize(x, (dw, dh),
                                                interpolation=flag)
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst <= 6e-5


def test_resize_refuses_bad_inputs():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="uint8 HWC"):
        resize_cubic_u8(img.astype(np.float32), (4, 4))
    with pytest.raises(ValueError, match="float32 HWC"):
        resize_cubic_f32(img, (4, 4))
    with pytest.raises(ValueError, match="bad output size"):
        resize_linear_f32(img.astype(np.float32), (0, 4))
    np.testing.assert_array_equal(resize_cubic_u8(img, (8, 8)), img)


def _folder(tmp_path, rng):
    for i, (h, w) in enumerate([(96, 120), (128, 96), (80, 160), (150, 100),
                                (100, 100)]):
        write_png(str(tmp_path / f"img_{i}.png"), cv2.GaussianBlur(
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 1.5))


@pytest.mark.parametrize("interp,uint8_io", [("bicubic", True),
                                             ("bicubic", False),
                                             ("bilinear", False)])
def test_unreproduced_pairs_are_refused(tmp_path, interp, uint8_io):
    """The pairs once refused (ROADMAP.md, Queue 3) now run: batches through
    the shuffling loader against the JAX package's, for two epochs, within
    ``data/resize.py``'s contract (uint8: 1e-4 of the bytes one level
    apart at most; float32: 6e-5)."""
    _folder(tmp_path, np.random.default_rng(3))
    opt = {"name": "", "type": "FolderImageDataset",
           "root_dir": str(tmp_path), "image_size": 48, "seed": 9,
           "uint8_io": uint8_io, "interpolation": interp,
           "resize_range": [0.5, 1.0], "repeat": 2}
    mine = DataLoader(build_dataset(opt, is_train=True), 4, shuffle=True,
                      drop_last=True, seed=4, num_workers=2)
    ref = JaxLoader(jax_dataset(opt, is_train=True), 4, shuffle=True,
                    drop_last=True, seed=4, num_workers=2)
    a = [b["real_images"] for _ in range(2) for b in mine]
    b = [b["real_images"] for _ in range(2) for b in ref]
    assert len(a) == len(b) == 4
    if uint8_io:
        _assert_u8_contract(zip(a, b))
    else:
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
            assert float(np.abs(x - y).max()) <= 6e-5


def test_resize_range_batches_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(48, 72), (64, 64), (40, 80), (96, 64),
                                (50, 50)]):
        write_png(str(tmp_path / f"img_{i}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    opt = {"name": "", "type": "FolderImageDataset",
           "root_dir": str(tmp_path), "image_size": 32, "seed": 9,
           "uint8_io": True, "interpolation": "bilinear",
           "resize_range": [0.5, 1.0], "repeat": 2}
    mine = DataLoader(build_dataset(opt, is_train=True), 4, shuffle=True,
                      drop_last=True, seed=4, num_workers=2)
    ref = JaxLoader(jax_dataset(opt, is_train=True), 4, shuffle=True,
                    drop_last=True, seed=4, num_workers=2)
    a = [b["real_images"] for _ in range(2) for b in mine]
    b = [b["real_images"] for _ in range(2) for b in ref]
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint8 and x.shape == (4, 32, 32, 3)
        assert x.tobytes() == y.tobytes()


def test_endurance_r4_stage1_runs_as_written_bicubic(tmp_path):
    """config/endurance_r4_stage1.yaml with its dataset as written
    (FolderImageDataset, resize_range [0.5, 1.0], the default bicubic,
    uint8 samples) at tiny widths on the CPU: 2 steps, finite losses."""
    from crdr_tpu_torch.trainer import build_trainer
    from crdr_tpu_torch.utils.config import Config, fill_paths
    from tests.torch_pairs import tiny_config

    (tmp_path / "src").mkdir()
    _folder(tmp_path / "src", np.random.default_rng(5))
    cfg = Config.from_file("config/endurance_r4_stage1.yaml")
    train = cfg.dataset.train_dataset
    assert train.get("interpolation", "bicubic") == "bicubic"
    assert train.resize_range == [0.5, 1.0] and train.uint8_io
    cfg.update({"ckpt_root": str(tmp_path), "exp": "r4", "total_iter": 2,
                "log_step": 1, "eval_step": 10 ** 9, "save_step": 10 ** 9,
                "time_step": 10 ** 9, "keep_step": [], "num_workers": 1,
                "mixed_precision": False})
    # the tiny widths replace the recipe's subnet whole (update would merge)
    cfg.subnet = type(cfg.subnet)(
        tiny_config("HyperpriorCharmModel").to_dict()["subnet"])
    cfg.dataset.update(batch_size=2)
    train.update(root_dir=str(tmp_path / "src"), image_size=64)
    cfg.dataset.eval_dataset.update(root_dir=str(tmp_path / "src"))
    fill_paths(cfg)
    tr = build_trainer(cfg, device="cpu")
    assert tr.train_loader.dataset.interpolation == "bicubic"
    logs = []
    step = tr.optimize_parameters_device
    tr.optimize_parameters_device = lambda i, d: logs.append(step(i, d)) \
        or logs[-1]
    tr.train_loop()
    assert len(logs) == 2
    for log in logs:
        assert all(bool(torch.isfinite(v).all()) for v in log.values())
