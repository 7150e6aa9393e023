"""The file path's oracle for the reader tests: ``cv2.imread`` of a file
on disk (not ``imdecode``, which parts from it on APNG and on truncated
JPEG), against ``img_utils.decode_image(..., file_path=True)``; and, for
fixtures whose ``digests.json`` ``tests/data/jpeg2000/make_fixtures.py``'s
``write`` makes, the body path against PIL and both paths against the JAX
package's own readers."""

import hashlib
import io
import os
import re
from typing import Optional

import numpy as np
import pytest

import cv2
from PIL import Image

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


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def pil_message(e: Exception) -> str:
    """PIL's error message without the reprs of its objects."""
    return re.sub(r" <[^>]*>", "", str(e))


def assert_fixture(path: str, want: dict) -> None:
    """A committed fixture on both paths: the file as ``cv2.imread`` reads
    it (``assert_fixture_file``; where cv2 returns None, the port's reason
    ``file_refused``), the body as PIL's ``convert("RGB")`` reads it,
    recomputed (where PIL raises, its message ``pil`` and the port's reason
    ``refused``)."""
    name, data = os.path.basename(path), _read(path)
    assert_fixture_file(path, want)
    if want["cv2"] is None:
        with pytest.raises(ValueError, match=want["file_refused"]):
            img_utils.decode_image(data, name, file_path=True)
    if "refused" in want:
        with pytest.raises(Exception) as e:
            Image.open(io.BytesIO(data)).convert("RGB")
        assert pil_message(e.value) == want["pil"]
        with pytest.raises(ValueError, match=f"^{name}: .*{want['refused']}"):
            img_utils.decode_image(data, name, file_path=False)
        return
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert (sha(pil), list(pil.shape)) == (want["body"], want["body_shape"])
    mine = img_utils.decode_image(data, name, file_path=False)
    assert list(mine.shape) == want["body_shape"] and sha(mine) == want["body"]


def assert_fixture_like_jax(path: str, want: dict) -> None:
    """The same bytes through the JAX package: its ``imread`` (cv2) against
    the port's (equal float32, or both raise) and its server's
    ``_png_to_uint8`` (PIL) against the port's body path (equal uint8, or
    both raise)."""
    from crdr_tpu.serving.http_server import _png_to_uint8 as jax_body
    from crdr_tpu.utils.img_utils import imread as jax_imread
    name, data = os.path.basename(path), _read(path)
    if want["cv2"] is None:
        with pytest.raises(FileNotFoundError):
            jax_imread(path)
        with pytest.raises(ValueError):
            img_utils.imread(path)
    else:
        ref, mine = jax_imread(path), img_utils.imread(path)
        assert mine.dtype == ref.dtype == np.float32
        assert mine.shape == ref.shape and mine.tobytes() == ref.tobytes()
    if "refused" in want:
        with pytest.raises(Exception):
            jax_body(data)
        with pytest.raises(ValueError):
            img_utils.decode_image(data, name, file_path=False)
        return
    ref = jax_body(data)
    mine = img_utils.decode_image(data, name, file_path=False)
    assert mine.dtype == ref.dtype == np.uint8
    assert mine.shape == ref.shape and mine.tobytes() == ref.tobytes()
