"""Sun raster reading on the host, as ``cv2.imread`` reads a file and as
PIL's ``SunImagePlugin`` and ``convert("RGB")`` read a request body (no
JAX counterpart: the JAX package's files go through cv2 and its server
through PIL, and the machines the port runs on have neither).  The
run-length data are decoded by ``runtime/csrc/rle.cpp`` (plain C ABI,
standard headers only, built with ``g++`` at first use into
``build/crdr_tpu_torch/`` and called through ctypes, which releases the
GIL); the rest is numpy.

The header: eight big-endian 32-bit words (the magic ``59 A6 6A 95``, the
width, the height, the depth, the data length, the type, the colour map's
type and its length), then the colour map (its reds, then its greens, then
its blues, a third of its length each), then the rows, each padded to 16
bits.

A file, as OpenCV's ``grfmt_sunras.cpp`` reads it: depths 1, 8, 24 and
32; types 0 (old) and 1 (standard) only (OpenCV 5 returns None for the
run-length type 2 and the RGB type 3); no colour map (its length 0), or an
RGB one (type 1) of 1-768 bytes for depths 1 and 8, its missing entries
black; a bit of 1 white without a map; 24 bits BGR, 32 bits XBGR (the
first byte dropped); every row's padding present.

A body, as PIL reads it: depths 1 (a bit of 1 black; no colour map), 4
(gray times 17, or a palette), 8 (gray or a palette), 24 (BGR, RGB for
type 3) and 32 (BGRX, RGBX for type 3; no colour map for either);
types 0, 1, 3, 4 and 5 raw, the last row's padding not needed, and 2
run-length coded (``crdr_sun_rle``: rows unpadded, runs across rows); a
colour map of type 1 of at most 768 bytes, its missing entries black.
PIL tries its GIMP brush reader first: a file one pixel wide whose height
and depth are not 0 and whose data length field is 1 or 4 is a brush
there, which runs out of data.

Each path raises a ``ValueError`` naming the source and the reason where
its oracle returns None or raises; more than ``MAX_PIXELS`` pixels raise
on both.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

import numpy as np

from .device import build_library, package_path
from .png import MAX_PIXELS

SUN_MAGIC = b"\x59\xa6\x6a\x95"

_SRC = package_path("runtime", "csrc", "rle.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the run-length decoders (no-op when up to date)."""
    return build_library(
        "crdr_rle", [_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC])


def rle_lib() -> ctypes.CDLL:
    """``rle.cpp``'s library, shared with ``utils/hdr.py``."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i, p, n = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
                c = ctypes.c_char_p
                lib.crdr_sun_rle.argtypes = [c, n, n, n, p, c, i]
                lib.crdr_sun_rle.restype = n
                lib.crdr_hdr_rle.argtypes = [c, n, i, i, p, c, i]
                lib.crdr_hdr_rle.restype = i
                _lib = lib
    return _lib


def is_sunras(data: bytes) -> bool:
    return data.startswith(SUN_MAGIC)


def _rows(body: bytes, w: int, h: int, depth: int, stride: int
          ) -> np.ndarray:
    """[h, w, depth // 8] bytes, or [h, w] samples of depth 1 / 4."""
    rows = np.frombuffer(body, np.uint8, h * stride).reshape(h, stride)
    if depth == 1:
        return np.unpackbits(rows, axis=1)[:, :w]
    if depth == 4:
        return np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
    if depth == 8:
        return rows[:, :w]
    return rows[:, :w * depth // 8].reshape(h, w, depth // 8)


def _palette(cmap: bytes) -> np.ndarray:
    """[256, 3] uint8: the map's reds, greens and blues, the rest black."""
    n = len(cmap) // 3
    pal = np.zeros((256, 3), np.uint8)
    pal[:n] = np.frombuffer(cmap, np.uint8, 3 * n).reshape(3, n).T
    return pal


def decode_sunras(data: bytes, name: str = "Sun raster data",
                  file_path: bool = False) -> np.ndarray:
    """Sun raster bytes -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")``
    reads a request body or, with ``file_path``, as ``cv2.imread`` reads a
    file (module doc).  Raises ``ValueError`` starting with ``name``."""
    if len(data) < 32 or not is_sunras(data):
        raise ValueError(f"{name}: not a Sun raster file")
    w, h, depth, _, kind, maptype, maplen = struct.unpack_from(">7I", data,
                                                               4)
    what = f"{name}: Sun raster of depth {depth}, type {kind}, colour map " \
           f"{maptype} of {maplen} bytes"
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: Sun raster of {w}x{h} pixels")
    cmap = data[32:32 + maplen]
    if len(cmap) < maplen:
        raise ValueError(f"{name}: truncated Sun raster colour map")
    body = data[32 + maplen:]
    if file_path:
        if w >= 1 << 31 or h >= 1 << 31 or depth not in (1, 8, 24, 32) \
                or kind not in (0, 1) \
                or not ((maptype == 0 and maplen == 0) or (
                    maptype == 1 and 0 < maplen <= 3 << depth and depth <= 8)):
            raise ValueError(f"{what} (cv2.imread returns None)")
        stride = ((w * depth + 7) // 8 + 1) & ~1
        if len(body) < h * stride:
            raise ValueError(f"{name}: truncated Sun raster data (cv2.imread "
                             "returns None)")
        px = _rows(body, w, h, depth, stride)
        if depth <= 8:
            if maplen:
                return _palette(cmap)[px]
            v = px * 255 if depth == 1 else px
            return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
        return np.ascontiguousarray(px[..., 3:0:-1] if depth == 32
                                    else px[..., ::-1])
    if w == 1 and h and depth and struct.unpack_from(">I", data, 16)[0] in (
            1, 4):
        # PIL's GIMP brush reader claims it first (its header size, version
        # 1, width, height and colour depth) and runs out of data
        raise ValueError(f"{name}: Sun raster that PIL opens as a GIMP brush "
                         "(not enough image data)")
    if depth not in (1, 4, 8, 24, 32) or kind > 5 or (
            maplen and (maplen > 768 or maptype != 1 or depth in (1, 24,
                                                                  32))):
        raise ValueError(f"{what} (PIL does not read it)")
    line = (w * depth + 7) // 8
    if kind == 2:
        raw = np.empty(h * line, np.uint8)
        err = ctypes.create_string_buffer(256)
        if rle_lib().crdr_sun_rle(body, len(body), line, h, raw.ctypes.data,
                                  err, len(err)) < 0:
            raise ValueError(f"{name}: {err.value.decode()}")
        body, stride = raw.tobytes(), line
    else:
        stride = ((w * depth + 15) // 16) * 2
        if len(body) < (h - 1) * stride + line:
            raise ValueError(f"{name}: truncated Sun raster data")
        body = body + bytes(h * stride - len(body)) if len(body) < \
            h * stride else body
    px = _rows(body, w, h, depth, stride)
    if depth <= 8:
        if maplen:
            return _palette(cmap)[px]
        v = {1: (1 - px) * 255, 4: px * 17}.get(depth, px)
        return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)
    rgb = px[..., :3] if kind == 3 else px[..., 2::-1]
    return np.ascontiguousarray(rgb)
