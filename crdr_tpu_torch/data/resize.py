"""``cv2.resize`` in numpy, as the JAX package's train transform calls it
(the machines the port runs on have no cv2): bilinear on uint8 byte for
byte, bicubic on uint8 and both on float32 within a stated contract.

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

cv2's bicubic uint8 path and its float32 paths (``resize_cubic_u8``,
``resize_linear_f32``, ``resize_cubic_f32``) run, in cv2's builds with Intel
IPP (sources of 4 pixels a side or more), IPP's own float code, whose order
of operations is not published.  The formulation here: source coordinates
``(d + 0.5) * src / dst - 0.5`` in double, edge pixels repeated past the
border; Keys' cubic with ``a = -0.75`` (or the two linear weights) in double,
rounded to float32; the horizontal pass, then the vertical one, each summing
its taps in order in float32; uint8 rounds half to even and saturates.
Trying IPP's other plausible choices (float32 coordinates, the weights'
polynomial evaluated in float32 in cv2's or Keys' form, taps summed in
pairs, backwards or with fused multiply-adds, the vertical pass first,
rounding half up) only moved further from it.  Its contract, against
``cv2.resize`` of cv2 5.0.0 with IPP 2026.0.0 over 250 seeded sources of
64-400 pixels a side and scales uniform in [0.5, 1.3]
(``tests/test_torch_resize.py``):

* bicubic uint8: at most 1e-4 of the bytes differ (about 7e-6 measured;
  each one a value within 2e-5 of a half, rounded the other way), none by
  more than one level;
* float32, bilinear and bicubic: within 6e-5 absolute (under 1e-6
  measured).

cv2 itself is not stable here: the same cv2 without IPP
(``cv2.ipp.setUseIPP(False)``, its own fixed-point bicubic) differs from cv2
with IPP on about 4.3% of the bicubic uint8 bytes, by one level, and by up
to 5.02e-5 on float32; so the JAX package's bicubic crops depend on how its
cv2 was built.  Sources under 4 pixels a side, where cv2 skips IPP, are
outside the contract.
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


def _keys_cubic(t: np.ndarray) -> list:
    """Keys' cubic weights (a = -0.75) of the taps at -1, 0, 1, 2 around a
    fractional position ``t`` (float64), as float32."""
    def inner(u):
        return (1.25 * u - 2.25) * u * u + 1.0

    def outer(u):
        return ((-0.75 * u + 3.75) * u - 6.0) * u + 3.0

    return [w.astype(np.float32)
            for w in (outer(t + 1.0), inner(t), inner(1.0 - t), outer(2.0 - t))]


def _float_pass(img: np.ndarray, axis: int, dst: int, cubic: bool
                ) -> np.ndarray:
    """One axis of the separable float resize (module doc): float32 taps,
    edge pixels repeated, summed in tap order."""
    src = img.shape[axis]
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    t = f - s
    s = s.astype(np.int64)
    if cubic:
        first, weights = s - 1, _keys_cubic(t)
    else:
        first, weights = s, [(1.0 - t).astype(np.float32),
                             t.astype(np.float32)]
    shape = [1] * img.ndim
    shape[axis] = dst
    acc = None
    for k, w in enumerate(weights):
        term = np.take(img, np.clip(first + k, 0, src - 1), axis=axis) \
            * w.reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def _resize_float(img: np.ndarray, size: Tuple[int, int], cubic: bool
                  ) -> np.ndarray:
    if img.ndim != 3:
        raise ValueError(f"HWC image expected, got {img.shape}")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad output size {size}")
    x = img.astype(np.float32)
    if (dw, dh) == (img.shape[1], img.shape[0]):
        return x.copy()
    return _float_pass(_float_pass(x, 1, dw, cubic), 0, dh, cubic)


def resize_cubic_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)`` for a uint8
    HWC image, within the module doc's contract; ``size`` is (width,
    height)."""
    if img.dtype != np.uint8:
        raise ValueError(f"uint8 HWC image expected, got {img.dtype} "
                         f"{img.shape}")
    out = _resize_float(img, size, cubic=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_linear_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for a
    float32 HWC image, within 6e-5 (module doc)."""
    return _resize_float(_check_f32(img), size, cubic=False)


def resize_cubic_f32(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)`` for a
    float32 HWC image, within 6e-5 (module doc)."""
    return _resize_float(_check_f32(img), size, cubic=True)


def _check_f32(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.float32:
        raise ValueError(f"float32 HWC image expected, got {img.dtype} "
                         f"{img.shape}")
    return img


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: str
           ) -> np.ndarray:
    """The train transform's ``cv2.resize``: ``interpolation`` "bicubic"
    (``INTER_CUBIC``) or anything else (``INTER_LINEAR``, as the JAX
    package reads it), on uint8 or float32 HWC images."""
    cubic = interpolation == "bicubic"
    if img.dtype == np.uint8:
        return (resize_cubic_u8 if cubic else resize_linear_u8)(img, size)
    return (resize_cubic_f32 if cubic else resize_linear_f32)(img, size)
