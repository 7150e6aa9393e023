"""Image datasets (counterpart of ``crdr_tpu/data/datasets.py``; reference
src/dataset/*): NHWC samples, float32 in [-1, 1] or, with ``uint8_io``,
uint8 pixels that the trainer converts on the device.

The numpy path is the JAX package's, so the same seed gives the same bytes:
per-index generators seeded ``[seed, index, k]`` (k counts the index's
draws), the random crop (reflect pad if needed) and horizontal flip of the
train transform, ``SyntheticImageDataset``'s procedural images.  Images are
read with the port's own readers (``utils/img_utils.py::read_image``: PNG,
JPEG and BMP by their magic bytes, as ``cv2.imread`` reads them, EXIF
orientation applied): the machines the port runs on have no cv2.  The
train transform's scale jitter (``resize_range``, a ``cv2.resize`` in the
JAX package) runs ``data/resize.py``'s numpy copies of cv2: the uint8
bilinear path byte for byte, bicubic uint8 and float32 samples (``uint8_io``
off) within that module's stated contract.
"""

from __future__ import annotations

import os
import threading
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.img_utils import read_image, uint8_to_tensor
from .resize import resize
from ..utils.registry import DATASET_REGISTRY


class BaseImageDataset:
    def __init__(self, img_path_list: List[str], is_train: bool = True,
                 image_size: int = 256,
                 resize_range: Optional[Tuple[float, float]] = None,
                 interpolation: str = "bicubic", seed: Optional[int] = None,
                 uint8_io: bool = False, repeat: int = 1):
        self.img_path_list = img_path_list
        self.is_train = is_train
        self.image_size = image_size
        self.resize_range = resize_range
        self.interpolation = interpolation
        # repeat: virtually oversample a small source set; each virtual
        # index draws its own generator, so crops and flips differ
        self.repeat = max(int(repeat), 1)
        self.uint8_io = uint8_io
        self._seed = seed
        self._lock = threading.Lock()
        self._draws: Dict[int, int] = {}

    def _sample_rng(self, index: int) -> np.random.Generator:
        """A generator per sample, seeded (dataset seed, index, draws of
        the index so far): crops and flips are reproducible whatever the
        loader's worker count and thread interleaving, and still differ
        across epochs."""
        if self._seed is None:
            return np.random.default_rng()
        with self._lock:
            k = self._draws.get(index, 0)
            self._draws[index] = k + 1
        return np.random.default_rng([self._seed, index, k])

    def skip(self, index: int) -> None:
        """Count a draw of ``index`` that another rank of a data-parallel
        run loads, so the next draw of it here is the one a single process
        would make."""
        if self._seed is not None and self.is_train:
            with self._lock:
                self._draws[index] = self._draws.get(index, 0) + 1

    def __len__(self) -> int:
        return len(self.img_path_list) * self.repeat

    def _load(self, index: int) -> np.ndarray:
        u8 = read_image(self.img_path_list[index % len(self.img_path_list)])
        return u8 if self.uint8_io else uint8_to_tensor(u8)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img = self._load(index)
        if self.is_train:
            img = self._train_transform(img, self._sample_rng(index))
        return {"real_images": img}

    def _train_transform(self, img: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
        size = self.image_size
        h, w = img.shape[:2]
        if self.resize_range is not None:
            fmin, fmax = self.resize_range
            lo = max(size / min(h, w), fmin)
            scale = rng.uniform(lo, max(lo, fmax))
            img = resize(img, (int(w * scale), int(h * scale)),
                         self.interpolation)
            h, w = img.shape[:2]
        # reflect pad if needed, then a random crop and a random flip
        pad_h = max(size - h, 0)
        pad_w = max(size - w, 0)
        if pad_h or pad_w:
            img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
            h, w = img.shape[:2]
        top = int(rng.integers(0, h - size + 1))
        left = int(rng.integers(0, w - size + 1))
        img = img[top:top + size, left:left + size]
        if rng.random() < 0.5:
            img = img[:, ::-1]
        if img.dtype == np.uint8:
            return np.ascontiguousarray(img)
        return np.ascontiguousarray(img, np.float32)


@DATASET_REGISTRY.register()
class OpenImageImageDataset(BaseImageDataset):
    """train: {root}/train_{i}/*.jpg over subset_list; eval:
    validation/*.jpg (reference openimage_dataset.py:20-30)."""

    def __init__(self, root_dir: str, subset_list: List[int] = (),
                 is_train: bool = False, image_size: int = 256, **kwargs):
        if is_train:
            paths = []
            for sid in subset_list:
                subset_dir = os.path.join(root_dir, f"train_{sid}")
                if not os.path.exists(subset_dir):
                    raise FileNotFoundError(
                        f'openimage subset "train_{sid}" does not exist')
                paths.extend(glob(os.path.join(subset_dir, "*.jpg")))
        else:
            paths = glob(os.path.join(root_dir, "validation", "*.jpg"))
        paths.sort()
        kwargs.pop("name", None)
        super().__init__(paths, is_train, image_size, **kwargs)


@DATASET_REGISTRY.register()
class KodakImageDataset(BaseImageDataset):
    def __init__(self, root_dir: str, is_train: bool = False,
                 image_size: int = 256, **kwargs):
        if is_train:
            raise ValueError("Kodak is eval-only")
        paths = sorted(glob(os.path.join(root_dir, "*.png")))
        super().__init__(paths, is_train, image_size)


@DATASET_REGISTRY.register()
class FolderImageDataset(BaseImageDataset):
    """A folder of images (png / jpg / jpeg / bmp), train or eval."""

    def __init__(self, root_dir: str, is_train: bool = False,
                 image_size: int = 256, **kwargs):
        paths = []
        for ext in ("*.png", "*.jpg", "*.jpeg", "*.bmp"):
            paths.extend(glob(os.path.join(root_dir, ext)))
        paths.sort()
        kwargs.pop("name", None)
        super().__init__(paths, is_train, image_size, **kwargs)


@DATASET_REGISTRY.register()
class SyntheticImageDataset(BaseImageDataset):
    """Deterministic procedural images: smooth gradients + texture, so they
    are compressible and drive the whole pipeline without external data."""

    def __init__(self, num_images: int = 32, is_train: bool = True,
                 image_size: int = 256, base_size: int = 320, **kwargs):
        super().__init__([str(i) for i in range(num_images)], is_train,
                         image_size, seed=kwargs.get("seed", 0),
                         uint8_io=kwargs.get("uint8_io", False))
        self.base_size = base_size

    def _load(self, index: int) -> np.ndarray:
        s = self.base_size
        rng = np.random.default_rng(index)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.stack([
            np.sin(2 * np.pi * (yy * rng.uniform(0.5, 3) + rng.random())),
            np.cos(2 * np.pi * (xx * rng.uniform(0.5, 3) + rng.random())),
            np.sin(2 * np.pi * ((xx + yy) * rng.uniform(0.5, 2))),
        ], axis=-1)
        img = 0.7 * img + 0.3 * rng.standard_normal((s, s, 3)).astype(
            np.float32)
        u8 = np.clip((img * 0.25 + 0.5) * 255, 0, 255).astype(np.uint8)
        return u8 if self.uint8_io else uint8_to_tensor(u8)
