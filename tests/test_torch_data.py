"""The port's data pipeline against the JAX package's, on the CPU: for the
same seed, ``SyntheticImageDataset`` and ``FolderImageDataset`` (PNGs in
``tmp_path``; JAX reads them with cv2, the port with its own PNG reader)
give byte-equal batches in the same order through the shuffling,
``drop_last`` loader, for two epochs, as float and as uint8 samples.  So do
a folder of JPEGs (4:2:0, 4:4:4, progressive, grayscale, an EXIF-rotated
one) and an ``OpenImageImageDataset`` tree of JPEGs (``train_{i}/*.jpg``),
read by the port's own decoder; with bicubic ``resize_range`` on top they
stay within ``data/resize.py``'s contract (uint8: at most 1e-4 of the bytes
one level apart; float32: 6e-5).  Bicubic ``resize_range`` runs, and a
sample that fails to load raises in the consumer."""

import numpy as np
import pytest

from crdr_tpu.data import DataLoader as JaxLoader
from crdr_tpu.data import build_dataset as jax_dataset
from crdr_tpu_torch.data import DataLoader, build_dataset, cycle
from crdr_tpu_torch.utils.img_utils import write_png

import cv2
from PIL import Image


def _epochs(loader, n=2):
    return [b["real_images"] for _ in range(n) for b in loader]


def _assert_same_batches(opt, batch_size=3, workers=2, contract=False):
    """Byte-equal batches, or with ``contract`` within data/resize.py's
    (uint8: at most 1e-4 of the bytes, one level each; float32: 6e-5)."""
    mine = DataLoader(build_dataset(opt, is_train=True), batch_size,
                      shuffle=True, drop_last=True, seed=11,
                      num_workers=workers)
    ref = JaxLoader(jax_dataset(opt, is_train=True), batch_size,
                    shuffle=True, drop_last=True, seed=11,
                    num_workers=workers)
    a, b = _epochs(mine), _epochs(ref)
    assert len(a) == len(b) == 2 * (len(mine.dataset) // batch_size)
    apart = total = 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if not contract:
            assert x.tobytes() == y.tobytes()
        elif x.dtype == np.uint8:
            d = np.abs(x.astype(np.int16) - y)
            assert int(d.max()) <= 1
            apart, total = apart + int(np.count_nonzero(d)), total + d.size
        else:
            assert float(np.abs(x - y).max()) <= 6e-5
    assert apart <= 1e-4 * max(total, 1)
    return a


def _jpeg_files(folder, seed: int) -> None:
    """Seeded JPEGs as a photo folder holds them: cv2 4:2:0 and 4:4:4,
    progressive, grayscale, and one PIL file with EXIF orientation 6."""
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)

    def img(h, w):
        return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                                (0, 0), 1.5)

    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    for i, (params, hw) in enumerate([
            ([sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420], (64, 88)),
            ([sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], (72, 60)),
            ([cv2.IMWRITE_JPEG_PROGRESSIVE, 1], (57, 81))]):
        assert cv2.imwrite(str(folder / f"img_{i}.jpg"), img(*hw),
                           [cv2.IMWRITE_JPEG_QUALITY, 85] + params)
    assert cv2.imwrite(str(folder / "img_3.jpg"), img(50, 66)[..., 0])
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(img(48, 70)).save(str(folder / "img_4.jpg"), "JPEG",
                                      quality=88, exif=exif.tobytes())


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
    # a folder of JPEGs, then an OpenImage tree of them; plain, then with
    # the recipes' bicubic resize_range
    _jpeg_files(tmp_path / "jpg", 1)
    _jpeg_files(tmp_path / "oi" / "train_0", 2)
    _jpeg_files(tmp_path / "oi" / "train_1", 3)
    for extra in ({}, {"resize_range": [0.5, 1.0],
                       "interpolation": "bicubic"}):
        jpg = dict(opt, root_dir=str(tmp_path / "jpg"), **extra)
        _assert_same_batches(jpg, batch_size=4, contract=bool(extra))
        oi = dict(jpg, type="OpenImageImageDataset",
                  root_dir=str(tmp_path / "oi"), subset_list=[0, 1])
        _assert_same_batches(oi, batch_size=4, contract=bool(extra))
    mine = build_dataset(jpg, is_train=False)
    ref = jax_dataset(jpg, is_train=False)
    assert len(mine) == len(ref) == 10  # 5 files, repeat 2
    for i in range(5):  # eval: the decode alone (img_4 rotated upright)
        assert mine[i]["real_images"].tobytes() == \
            ref[i]["real_images"].tobytes()
    assert mine[4]["real_images"].shape == (70, 48, 3)


def test_resize_range_raises_and_load_errors_reach_the_consumer(tmp_path):
    opt = {"name": "synthetic", "type": "SyntheticImageDataset",
           "num_images": 4, "image_size": 32, "base_size": 40}
    # bicubic resize_range (the default interpolation) runs
    write_png(str(tmp_path / "b.png"), np.full((40, 50, 3), 7, np.uint8))
    ds = build_dataset({"type": "FolderImageDataset",
                        "root_dir": str(tmp_path), "image_size": 16,
                        "seed": 0, "resize_range": [0.5, 1.0]},
                       is_train=True)
    assert ds.interpolation == "bicubic"
    sample = ds[0]["real_images"]
    assert sample.shape == (16, 16, 3) and sample.dtype == np.float32
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
