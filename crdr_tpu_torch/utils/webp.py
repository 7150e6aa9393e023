"""WebP reading on the host, as PIL reads a request body or as
``cv2.imread`` reads a file (no JAX counterpart: the JAX server calls
``Image.open(...).convert("RGB")``, PIL decodes every WebP through
libwebp's ``WebPAnimDecoder``, the JAX package's files go through cv2, and
the machines the port runs on have neither).

The RIFF container is parsed here; the bitstreams are decoded by
``runtime/csrc/webp.cpp`` (plain C ABI, standard headers only, built with
``g++`` at first use into ``build/crdr_tpu_torch/`` and called through
ctypes, which releases the GIL): VP8 (lossy) with libwebp's fancy chroma
upsampling and fixed-point YUV -> RGB, VP8L (lossless), and ``ALPH``
(raw or VP8L-coded, filtered or not).

Read: a simple file (``VP8 `` or ``VP8L``), an extended one (``VP8X``
with ``ALPH`` before a ``VP8 `` image), and the first frame of an
animation (``ANIM`` / ``ANMF``) placed on its canvas as the animation
decoder places it: a canvas of transparent black, the frame at its
offset, not blended.  The RGBA is straight (not premultiplied), so the RGB
PIL's ``convert("RGB")`` keeps does not depend on the alpha.

What raises a ``ValueError`` naming the source and the reason: a RIFF
size past the data, a chunk past the RIFF, a frame past its canvas or of
another size than its header says, ``ALPH`` beside a ``VP8L`` image, a VP8
inter frame, bad or truncated bitstreams, more than ``MAX_PIXELS`` pixels.
A file is read as cv2 reads it: the same pixels, but an ``ALPH`` beside a
``VP8L`` is dropped (libwebp's ``WebPDecode``), and the EXIF chunk's
orientation (2-8) is applied.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import NamedTuple, Optional

import numpy as np

from .device import build_library, package_path
from .jpeg import orient
from .png import MAX_PIXELS, exif_orientation

_SRC = package_path("runtime", "csrc", "webp.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def is_webp(data: bytes) -> bool:
    """``RIFF....WEBP``."""
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def build() -> str:
    """Compile the decoder (no-op when the built library is up to date)."""
    return build_library(
        "crdr_webp", [_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC])


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i, p, n = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
                c = ctypes.c_char_p
                lib.crdr_webp_vp8.argtypes = [c, n, i, i, p, c, i]
                lib.crdr_webp_vp8l.argtypes = [c, n, i, i, i, p, c, i]
                lib.crdr_webp_alpha.argtypes = [c, n, i, i, p, c, i]
                for f in (lib.crdr_webp_vp8, lib.crdr_webp_vp8l,
                          lib.crdr_webp_alpha):
                    f.restype = i
                _lib = lib
    return _lib


class WebpFrame(NamedTuple):
    """The first frame of a WebP and where it lies on its canvas."""
    canvas: tuple        # (width, height)
    offset: tuple        # (x, y)
    size: tuple          # (width, height)
    kind: bytes          # b"VP8 " or b"VP8L"
    image: bytes         # the bitstream chunk's payload
    alpha: Optional[bytes]  # the ALPH chunk's payload of a VP8 frame
    has_alpha: bool      # libwebp's feature flag: PIL's RGBA, else RGBX


def _chunks(data: bytes, start: int, end: int, name: str):
    """(fourcc, payload) of each chunk in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data,
                                                           pos + 4)[0]
        if pos + 8 + size > end:
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


def _bitstream_size(kind: bytes, payload: bytes, name: str) -> tuple:
    if kind == b"VP8 ":
        if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
            raise ValueError(f"{name}: bad VP8 frame header")
        w, h = struct.unpack_from("<HH", payload, 6)
        return w & 0x3FFF, h & 0x3FFF
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError(f"{name}: bad VP8L signature")
    v = struct.unpack_from("<I", payload, 1)[0]
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def _frame(chunks, name: str, alph_vp8l_ok: bool = False):
    """(kind, image, alpha) of the image chunks of one frame."""
    alpha = None
    for kind, payload in chunks:
        if kind == b"ALPH":
            if alpha is None:
                alpha = payload
        elif kind in (b"VP8 ", b"VP8L"):
            if kind == b"VP8L" and alpha is not None:
                if alph_vp8l_ok:
                    return kind, payload, None  # libwebp's WebPDecode drops it
                raise ValueError(f"{name}: WebP ALPH chunk beside a VP8L "
                                 "image")
            return kind, payload, alpha
    raise ValueError(f"{name}: WebP without an image chunk")


def parse_webp(data: bytes, name: str = "WebP data",
               file_path: bool = False) -> WebpFrame:
    """The RIFF container of a WebP -> its first frame (module doc);
    ``file_path``: as cv2 reads a file, an ``ALPH`` beside a ``VP8L`` is
    dropped."""
    if not is_webp(data):
        raise ValueError(f"{name}: not a WebP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 4 or riff + 8 > len(data):
        raise ValueError(f"{name}: truncated WebP file (RIFF size {riff}, "
                         f"{len(data) - 8} bytes)")
    chunks = _chunks(data, 12, 8 + riff, name)
    first = next(chunks, None)
    if first is None:
        raise ValueError(f"{name}: WebP without chunks")
    kind, payload = first
    if kind in (b"VP8 ", b"VP8L"):
        size = _bitstream_size(kind, payload, name)
        has_alpha = kind == b"VP8L" and bool(payload[4] & 0x10)
        return WebpFrame(size, (0, 0), size, kind, payload, None, has_alpha)
    if kind != b"VP8X" or len(payload) < 10:
        raise ValueError(f"{name}: WebP starting with chunk {kind!r}")
    flags = payload[0]
    has_alpha = bool(flags & 0x10)
    cw = int.from_bytes(payload[4:7], "little") + 1
    ch = int.from_bytes(payload[7:10], "little") + 1
    if cw * ch > MAX_PIXELS:
        raise ValueError(f"{name}: WebP canvas of {cw}x{ch} pixels")
    if flags & 0x02:  # an animation: its first ANMF frame
        for kind, payload in chunks:
            if kind != b"ANMF":
                continue
            if len(payload) < 16:
                raise ValueError(f"{name}: truncated WebP ANMF chunk")
            fields = [int.from_bytes(payload[i:i + 3], "little")
                      for i in range(0, 15, 3)]
            x, y = 2 * fields[0], 2 * fields[1]
            fw, fh = fields[2] + 1, fields[3] + 1
            if x + fw > cw or y + fh > ch:
                raise ValueError(f"{name}: WebP frame {fw}x{fh} at ({x}, "
                                 f"{y}) past its {cw}x{ch} canvas")
            kind, image, alpha = _frame(
                _chunks(payload, 16, len(payload), name), name, file_path)
            if _bitstream_size(kind, image, name) != (fw, fh):
                raise ValueError(f"{name}: WebP frame of another size than "
                                 "its ANMF header")
            return WebpFrame((cw, ch), (x, y), (fw, fh), kind, image, alpha,
                             has_alpha)
        raise ValueError(f"{name}: animated WebP without frames")
    kind, image, alpha = _frame(chunks, name, file_path)
    if _bitstream_size(kind, image, name) != (cw, ch):
        raise ValueError(f"{name}: WebP image of another size than its "
                         "canvas")
    return WebpFrame((cw, ch), (0, 0), (cw, ch), kind, image, alpha,
                     has_alpha)


def _call(fn, name: str, *args) -> None:
    err = ctypes.create_string_buffer(256)
    if fn(*args, err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")


def frame_rgba(frame: WebpFrame, name: str = "WebP data") -> np.ndarray:
    """The frame's own pixels -> uint8 [h, w, 4] straight RGBA, in C++."""
    lib = _get_lib()
    w, h = frame.size
    out = np.empty((h, w, 4), np.uint8)
    if frame.kind == b"VP8 ":
        _call(lib.crdr_webp_vp8, name, frame.image, len(frame.image), w, h,
              out.ctypes.data)
        if frame.alpha is not None:
            a = np.empty((h, w), np.uint8)
            _call(lib.crdr_webp_alpha, name, frame.alpha, len(frame.alpha),
                  w, h, a.ctypes.data)
            out[..., 3] = a
    else:
        _call(lib.crdr_webp_vp8l, name, frame.image, len(frame.image), w, h,
              0, out.ctypes.data)
    return out


def orientation(data: bytes) -> int:
    """The EXIF orientation of an extended WebP's ``EXIF`` chunk (its
    payload with or without the ``Exif\\0\\0`` prefix), 1 without one."""
    riff = min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    pos = 12
    while pos + 8 <= riff:
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data,
                                                           pos + 4)[0]
        if kind == b"EXIF":
            exif = data[pos + 8:pos + 8 + size]
            return exif_orientation(exif[6:] if exif.startswith(
                b"Exif\0\0") else exif)
        pos += 8 + size + (size & 1)
    return 1


def decode_webp_rgba(data: bytes, name: str = "WebP data",
                     file_path: bool = False) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 4] straight RGBA of the first frame on its
    canvas, as libwebp's animation decoder gives it to PIL; a file without
    the alpha feature is opaque (PIL's ``RGBX``).  ``file_path``: the
    frame as cv2 reads a file (``parse_webp``), before its orientation."""
    frame = parse_webp(data, name, file_path)
    rgba = frame_rgba(frame, name)
    if frame.size != frame.canvas:
        (cw, ch), (x, y), (w, h) = frame.canvas, frame.offset, frame.size
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[y:y + h, x:x + w] = rgba
        rgba = canvas
    if not frame.has_alpha:
        rgba[..., 3] = 255
    return rgba


def decode_webp(data: bytes, name: str = "WebP data",
                file_path: bool = False) -> np.ndarray:
    """WebP bytes -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")`` reads
    a request body or, with ``file_path``, as ``cv2.imread`` reads a file
    (the EXIF orientation applied; module doc).  Raises ``ValueError``
    starting with ``name``."""
    rgb = np.ascontiguousarray(decode_webp_rgba(data, name, file_path)
                               [..., :3])
    return orient(rgb, orientation(data)) if file_path else rgb
