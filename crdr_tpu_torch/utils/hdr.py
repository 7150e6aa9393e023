"""Radiance HDR (RGBE) reading on the host, as ``cv2.imread`` reads a file
with ``IMREAD_COLOR`` (no JAX counterpart: the JAX package's files go
through cv2, and the machines the port runs on do not have it).  PIL does
not open Radiance files, so a request body of one is refused as PIL
refuses it.  The run-length scanlines are decoded by
``runtime/csrc/rle.cpp`` (``crdr_hdr_rle``, built and loaded with the Sun
raster reader's); the rest is numpy.

As OpenCV's ``rgbe.cpp`` reads it: a file starting ``#?RGBE`` or
``#?RADIANCE`` (cv2's signatures); header lines as ``fgets`` reads them
into 128 bytes (a longer line is read in pieces), up to an empty line,
one of them exactly ``FORMAT=32-bit_rle_rgbe`` (other formats, XYZE among
them, are refused); then the next line as ``sscanf("-Y %d +X %d")`` (other
orientations are refused), both at least 1 and at most 2^20 (cv2's
limits).  The pixels follow: run-length scanlines (``2 2`` and the width,
then each channel as runs and literals) for widths 8-32767, flat RGBE
quadruples otherwise or from the first scanline that does not start so;
the old-style runs (``1 1 1 n``) are not understood by OpenCV and are read
as the flat quadruples they are.  RGBE to float: ``m * 2^(e - 136)`` in
float32, 0 for an exponent of 0; then cv2's ``convertTo`` to 8 bits:
times 255 in float32, rounded half to even, saturated (2^31 and past
overflow ``cvRound``'s int32 and saturate to 0).

cv2 ignores the pixel reader's failures and returns whatever its
uninitialised buffer held for the pixels not read; the port refuses such
files instead (pixels that end early, a run of 0 or past its scanline, a
scanline of another width).
"""

from __future__ import annotations

import ctypes
import re
from typing import Optional, Tuple

import numpy as np

from .png import MAX_PIXELS
from .sunras import rle_lib

HDR_MAGICS = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y[ \t\n\x0b\x0c\r]*([+-]?[0-9]+)[ \t\n\x0b\x0c\r]*\+X"
                   rb"[ \t\n\x0b\x0c\r]*([+-]?[0-9]+)")
_MAX_SIDE = 1 << 20  # cv2's CV_IO_MAX_IMAGE_WIDTH / HEIGHT


def is_hdr(data: bytes) -> bool:
    return data.startswith(HDR_MAGICS)


def _fgets(data: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """The line ``fgets(buf, 128, fp)`` returns at pos (None at the end)
    and the position after it."""
    if pos >= len(data):
        return None, pos
    nl = data.find(b"\n", pos, pos + 127)
    end = nl + 1 if nl >= 0 else min(len(data), pos + 127)
    return data[pos:end], end


def _cstr(line: bytes) -> bytes:
    return line.split(b"\0", 1)[0]


def rgbe_to_uint8(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] RGBE bytes -> [..., 3] uint8 as cv2 gives them: float32
    ``m * 2^(e - 136)``, then times 255, rounded half to even, saturated
    (module doc)."""
    e = rgbe[..., 3:].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1), e - 136), np.float32(0))
    with np.errstate(over="ignore"):
        f = rgbe[..., :3].astype(np.float32) * scale.astype(np.float32) \
            * np.float32(255)
    # cvRound's int32 overflows to INT_MIN at 2^31 and more: saturated to 0
    return np.where(f >= 2.0 ** 31, 0, np.clip(np.rint(f), 0, 255)).astype(
        np.uint8)


def decode_hdr(data: bytes, name: str = "Radiance data",
               file_path: bool = False) -> np.ndarray:
    """Radiance bytes -> uint8 [H, W, 3] RGB as ``cv2.imread`` reads a file
    (module doc); a request body (``file_path`` False) raises, as PIL
    cannot identify one.  Raises ``ValueError`` starting with ``name``."""
    if not file_path:
        raise ValueError(f"{name}: a Radiance HDR body (PIL cannot identify "
                         "it)")
    if not is_hdr(data):
        raise ValueError(f"{name}: not a Radiance HDR file")
    found, pos = False, 0
    while True:
        line, pos = _fgets(data, pos)
        if line is None:
            raise ValueError(f"{name}: Radiance header without its end "
                             "(cv2.imread returns None)")
        if line[:1] in (b"\0", b"\n"):
            break
        found = found or _cstr(line) == _FORMAT
    if not found:
        raise ValueError(f"{name}: Radiance header without "
                         "FORMAT=32-bit_rle_rgbe (cv2.imread returns None)")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(_cstr(line)) if line is not None else None
    h, w = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    if not (0 < h <= _MAX_SIDE and 0 < w <= _MAX_SIDE) or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: Radiance resolution line "
                         f"{_cstr(line or b'')[:40]!r} (cv2 reads -Y h +X w, "
                         "each 1 to 2^20; cv2.imread returns None)")
    body = data[pos:]
    rgbe = np.empty((h, w, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    if rle_lib().crdr_hdr_rle(body, len(body), w, h, rgbe.ctypes.data, err,
                              len(err)):
        raise ValueError(f"{name}: {err.value.decode()} (cv2 returns "
                         "uninitialised pixels)")
    return rgbe_to_uint8(rgbe)
