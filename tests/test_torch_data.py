"""The port's data pipeline against the JAX package's, on the CPU: for the
same seed, ``SyntheticImageDataset`` and ``FolderImageDataset`` (PNGs in
``tmp_path``; JAX reads them with cv2, the port with its own PNG reader)
give byte-equal batches in the same order through the shuffling,
``drop_last`` loader, for two epochs, as float and as uint8 samples.
``resize_range`` raises, and a sample that fails to load raises in the
consumer."""

import numpy as np
import pytest

from crdr_tpu.data import DataLoader as JaxLoader
from crdr_tpu.data import build_dataset as jax_dataset
from crdr_tpu_torch.data import DataLoader, build_dataset, cycle
from crdr_tpu_torch.utils.img_utils import write_png


def _epochs(loader, n=2):
    return [b["real_images"] for _ in range(n) for b in loader]


def _assert_same_batches(opt, batch_size=3, workers=2):
    mine = DataLoader(build_dataset(opt, is_train=True), batch_size,
                      shuffle=True, drop_last=True, seed=11,
                      num_workers=workers)
    ref = JaxLoader(jax_dataset(opt, is_train=True), batch_size,
                    shuffle=True, drop_last=True, seed=11,
                    num_workers=workers)
    a, b = _epochs(mine), _epochs(ref)
    assert len(a) == len(b) == 2 * (len(mine.dataset) // batch_size)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    return a


@pytest.mark.parametrize("uint8_io", [False, True])
def test_synthetic_batches_byte_equal_to_jax(uint8_io):
    opt = {"name": "synthetic", "type": "SyntheticImageDataset",
           "num_images": 7, "image_size": 48, "base_size": 64, "seed": 5,
           "uint8_io": uint8_io}
    batches = _assert_same_batches(opt)
    assert batches[0].dtype == (np.uint8 if uint8_io else np.float32)
    assert batches[0].shape == (3, 48, 48, 3)
    # the two epochs differ: fresh crops and another order
    assert batches[0].tobytes() != batches[2].tobytes()


@pytest.mark.parametrize("uint8_io", [False, True])
def test_folder_batches_byte_equal_to_jax(tmp_path, uint8_io):
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 56), (64, 48), (30, 30), (50, 70),
                                (45, 45)]):  # (30, 30): reflect-padded
        write_png(str(tmp_path / f"img_{i}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    opt = {"name": "", "type": "FolderImageDataset",
           "root_dir": str(tmp_path), "image_size": 36, "seed": 3,
           "uint8_io": uint8_io, "repeat": 2}
    _assert_same_batches(opt, batch_size=4)
    # eval: the whole image, no transform
    mine = build_dataset(opt, is_train=False)[1]["real_images"]
    ref = jax_dataset(opt, is_train=False)[1]["real_images"]
    assert mine.shape == (64, 48, 3) and mine.tobytes() == ref.tobytes()


def test_resize_range_raises_and_load_errors_reach_the_consumer(tmp_path):
    opt = {"name": "synthetic", "type": "SyntheticImageDataset",
           "num_images": 4, "image_size": 32, "base_size": 40}
    with pytest.raises(NotImplementedError, match="resize_range"):
        build_dataset({"type": "FolderImageDataset", "root_dir": "x",
                       "resize_range": [0.5, 1.0]}, is_train=True)
    (tmp_path / "a.png").write_bytes(b"not a png")
    bad = build_dataset({"type": "FolderImageDataset",
                         "root_dir": str(tmp_path)}, is_train=False)
    with pytest.raises(ValueError, match="not a PNG"):
        list(DataLoader(bad, batch_size=1))
    with pytest.raises(ValueError, match="empty loader"):
        list(DataLoader(build_dataset(opt), batch_size=5, drop_last=True))
    with pytest.raises(KeyError):
        build_dataset({"type": "NoSuchDataset"})
    loader = DataLoader(build_dataset(opt, is_train=True), batch_size=2,
                        shuffle=True, drop_last=True, seed=1)
    iters = [i for i, _ in cycle(loader, 3, 8)]
    assert iters == [4, 5, 6, 7, 8]  # cycles past the 2-batch epoch
