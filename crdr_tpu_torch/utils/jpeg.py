"""JPEG decoding and encoding on the host, byte-equal to libjpeg-turbo as
cv2 and PIL run it (no JAX counterpart: the JAX package calls cv2 and PIL,
which the machines the port runs on do not have).

The decoder is ``runtime/csrc/jpeg.cpp`` and the encoder
``runtime/csrc/jpeg_encode.cpp``, plain C ABI, built together with ``g++``
at first use into ``build/crdr_tpu_torch/`` and called through ctypes
(which releases the GIL, so the data loader's threads decode in parallel).

``encode_jpeg(rgb, quality=95)`` writes what ``cv2.imencode('.jpg',
rgb[..., ::-1])`` writes at its defaults, byte for byte: baseline JFIF,
YCbCr 4:2:0, the islow DCT, the standard tables scaled to the quality, the
standard Huffman tables (JAX's ``imwrite`` of a ``.jpg`` through
``img_utils.imwrite``).

The decoder
decodes baseline and progressive Huffman JPEG (restart intervals, any
sampling factors libjpeg takes) with libjpeg-turbo's default
decompression: the islow IDCT, fancy upsampling, jdcolor.c's fixed-point
YCbCr -> RGB, and the colour space chosen as ``jdapimin.c`` chooses it.

Two callers, two behaviours, after the JAX package's two readers:

* ``decode_jpeg(data, name, file_path=True)`` (``cv2.imread``: the
  datasets and the CLIs, through ``img_utils.read_image``): EXIF
  orientation applied; CMYK / YCCK as cv2 converts libjpeg's CMYK;
* ``decode_jpeg(data, name, file_path=False)`` (``PIL.Image.open(...)
  .convert("RGB")``, the HTTP server's request bodies): no orientation;
  CMYK as PIL converts its Adobe-inverted CMYK.

What raises a ``ValueError`` naming the file and the reason: 12-bit
samples, lossless (SOF3), hierarchical and arithmetic-coded (SOF9-11)
JPEG, truncated or corrupt entropy data and a missing EOI (where cv2 would
return libjpeg's partial image), and progressive files whose scans leave a
low coefficient unrefined (libjpeg smooths those blocks).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from .device import build_library, package_path

JPEG_MAGIC = b"\xff\xd8\xff"

_SRC = package_path("runtime", "csrc", "jpeg.cpp")
_ENC_SRC = package_path("runtime", "csrc", "jpeg_encode.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the decoder and the encoder (no-op when the built library is
    up to date)."""
    return build_library(
        "crdr_jpeg", [_SRC, _ENC_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC, _ENC_SRC])


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                ip = ctypes.POINTER(ctypes.c_int)
                lib.crdr_jpeg_decode.restype = ctypes.c_void_p
                lib.crdr_jpeg_decode.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int, ip, ip, ip, ctypes.c_char_p, ctypes.c_int]
                lib.crdr_jpeg_encode.restype = ctypes.c_void_p
                lib.crdr_jpeg_encode.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
                    ctypes.c_int]
                lib.crdr_jpeg_free.restype = None
                lib.crdr_jpeg_free.argtypes = [ctypes.c_void_p]
                _lib = lib
    return _lib


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ExifTransform``: EXIF orientation 2-8 -> the upright image."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = "JPEG data",
                file_path: bool = False) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB: as ``cv2.imread`` gives a file
    (``file_path``: EXIF orientation applied, cv2's CMYK) or as PIL's
    ``convert("RGB")`` gives a body (neither).  Raises ``ValueError``
    starting with ``name``."""
    lib = _get_lib()
    w, h, orientation = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    ptr = lib.crdr_jpeg_decode(data, len(data), 0 if file_path else 1,
                               int(file_path), ctypes.byref(w), ctypes.byref(h),
                               ctypes.byref(orientation), err, len(err))
    if not ptr:
        raise ValueError(f"{name}: {err.value.decode()}")
    try:
        img = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            (h.value, w.value, 3)).copy()
    finally:
        lib.crdr_jpeg_free(ptr)
    return orient(img, orientation.value) if file_path else img



def encode_jpeg(rgb_u8: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes ``cv2.imencode('.jpg', rgb[...,
    ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])`` gives (cv2's default
    quality is 95).  Raises ``ValueError`` on another shape or dtype."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg: expected uint8 [H, W, 3] RGB, got "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    lib = _get_lib()
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    ptr = lib.crdr_jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0],
                               int(quality), ctypes.byref(n), err, len(err))
    if not ptr:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.crdr_jpeg_free(ptr)
