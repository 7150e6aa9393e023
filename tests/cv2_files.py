"""The file path's oracle for the reader tests: ``cv2.imread`` of a file
on disk (not ``imdecode``, which parts from it on APNG and on truncated
JPEG), against ``img_utils.decode_image(..., file_path=True)``."""

import hashlib
import os
from typing import Optional

import numpy as np
import pytest

import cv2

from crdr_tpu_torch.utils import img_utils


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.uint8)
                          .tobytes()).hexdigest()


def cv2_rgb(path: str) -> Optional[np.ndarray]:
    """``cv2.imread``'s RGB of a file, None where it returns None."""
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


def assert_fixture_file(path: str, want: dict, refused: str = "") -> None:
    """A committed fixture on the file path: its ``cv2`` digest recomputed
    (so it cannot drift), then the port's pixels equal to it, or a
    ``ValueError`` naming the file where cv2 returns None (or, with
    ``refused``, where the port refuses a file cv2 reads, by that
    reason)."""
    name = os.path.basename(path)
    rgb = cv2_rgb(path)
    assert want["cv2"] == (None if rgb is None else sha(rgb))
    with open(path, "rb") as f:
        data = f.read()
    if rgb is None or refused:
        with pytest.raises(ValueError, match=f"^{name}: .*{refused}"):
            img_utils.decode_image(data, name, file_path=True)
        return
    mine = img_utils.decode_image(data, name, file_path=True)
    assert mine.shape == rgb.shape and sha(mine) == want["cv2"]


def assert_like_cv2(folder, data: bytes, suffix: str, what) -> None:
    """Bytes written as a file: the port's file path equal to
    ``cv2.imread`` of it, or refused where cv2 returns None."""
    path = os.path.join(str(folder), "random" + suffix)
    with open(path, "wb") as f:
        f.write(data)
    rgb = cv2_rgb(path)
    if rgb is None:
        with pytest.raises(ValueError, match="^random: "):
            img_utils.decode_image(data, "random", file_path=True)
        return
    mine = img_utils.decode_image(data, "random", file_path=True)
    assert mine.shape == rgb.shape and mine.tobytes() == rgb.tobytes(), what
