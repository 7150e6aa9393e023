"""``cv2.resize(..., interpolation=cv2.INTER_LINEAR)`` on uint8 images, in
numpy, byte for byte (the JAX package's train transform calls cv2; the
machines the port runs on have no cv2).

cv2's uint8 bilinear path, as its bytes show:

* source coordinate per output pixel ``f = float32((d + 0.5) * scale - 0.5)``
  with ``scale = 1 / (dst / src)`` in double, ``s = floor(f)``, ``f -= s``;
  columns left of 0 or right of the last take the edge pixel with weight 1
  (rows are clamped only: their weights stay as drawn);
* weights in 11-bit fixed point, ``rint(w * 2048)``, each rounded on its own
  (the two need not sum to 2048);
* horizontal pass exact in integers (``S0 * a0 + S1 * a1``);
* vertical pass as its SIMD kernel computes it: each row term
  ``((S >> 4) * b) >> 16`` (a high multiply on int16 lanes), the two added
  with int16 saturation, then ``(t + 2) >> 2`` packed to uint8 with
  saturation.  The scalar formula, ``(S0*b0 + S1*b1 + 2**21) >> 22``, is
  one level off on about one pixel in ten and is not what cv2 returns;
* an exact 2x downscale on both axes takes cv2's area fast path instead:
  ``(a + b + c + d + 2) >> 2`` over each 2x2 block.

cv2's bicubic uint8 path and its float32 paths are not reproduced: in
cv2's builds with Intel IPP they run IPP's own float code (for sources of
4 pixels a side or more), whose summation order was not pinned down.  The
closest numpy formulation found (double-precision coordinates, float32
weights and sums) leaves about 2e-5 of the bicubic uint8 bytes one level
off (ties at x.5), so ``data/datasets.py`` refuses ``resize_range`` with
those pairs (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_COEF_SCALE = np.float32(2048.0)


def _taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index, weight of the first tap, of the second) per
    output index; indices not yet clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    return s, f


def _fixed(w: np.ndarray) -> np.ndarray:
    return np.rint(w * _COEF_SCALE).astype(np.int32)


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for a uint8
    HWC image; ``size`` is (width, height), as cv2 takes it."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"uint8 HWC image expected, got {img.dtype} "
                         f"{img.shape}")
    dw, dh = int(size[0]), int(size[1])
    h, w, c = img.shape
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad output size {size}")
    if (dw, dh) == (w, h):
        return img.copy()
    if w == 2 * dw and h == 2 * dh:
        a = img.astype(np.uint16)
        s = a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    one = np.float32(1.0)
    sx, fx = _taps(dw, w)
    left = sx < 0
    fx[left], sx[left] = 0, 0
    right = sx >= w - 1
    fx[right], sx[right] = 0, w - 1
    a0, a1 = _fixed(one - fx), _fixed(fx)
    src = img.astype(np.int32)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None])
    sy, fy = _taps(dh, h)
    b0, b1 = _fixed(one - fy), _fixed(fy)

    def term(r: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (np.clip(r >> 4, -32768, 32767) * b[:, None, None]) >> 16

    t = (term(rows[np.clip(sy, 0, h - 1)], b0)
         + term(rows[np.clip(sy + 1, 0, h - 1)], b1))
    t = np.clip(t, -32768, 32767)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)
