"""The train transform's ``resize_range`` in the port, on the CPU.

* ``data/resize.py::resize_linear_u8`` against ``cv2.resize(...,
  INTER_LINEAR)`` on uint8 images: byte-equal (tolerance 0) down and up,
  odd sizes, one axis only, an exact 0.5 scale (cv2's area fast path), a
  1-pixel source or output edge, and 400 seeded random shapes.
* The pairs the port does not reproduce (bicubic on uint8, both
  interpolations on float32) are refused by the dataset, by name.
* Batches with ``resize_range`` through the shuffling loader, byte-equal to
  the JAX package's loader (which calls cv2), for two epochs.
"""

import numpy as np
import pytest

import cv2

from crdr_tpu.data import DataLoader as JaxLoader
from crdr_tpu.data import build_dataset as jax_dataset
from crdr_tpu_torch.data import DataLoader, build_dataset
from crdr_tpu_torch.data.resize import resize_linear_u8
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


@pytest.mark.parametrize("interp,uint8_io", [("bicubic", True),
                                             ("bicubic", False),
                                             ("bilinear", False)])
def test_unreproduced_pairs_are_refused(interp, uint8_io):
    """cv2's bicubic uint8 and float32 resizes are not its generic
    fixed-point code; those pairs raise instead of giving other crops than
    JAX (ROADMAP.md, Queue 3)."""
    with pytest.raises(NotImplementedError, match=interp):
        build_dataset({"type": "FolderImageDataset", "root_dir": "x",
                       "resize_range": [0.5, 1.0], "interpolation": interp,
                       "uint8_io": uint8_io}, is_train=True)


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
