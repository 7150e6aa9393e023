"""GIF reading on the host: the first frame, as PIL reads a request body
(no JAX counterpart: the JAX server calls ``Image.open(...).convert("RGB")``,
which the machines the port runs on cannot).

The blocks are parsed here as PIL's ``GifImagePlugin`` parses them; the
LZW data is decoded by ``runtime/csrc/lzw.cpp`` (plain C ABI, built with
``g++`` at first use into ``build/crdr_tpu_torch/`` and called through
ctypes) as PIL's ``GifDecode.c`` decodes it: minimum code sizes 1-8, the
clear code, a full table that adds nothing until the next clear, codes
over sub-blocks, interlaced rows.

PIL's first-frame rules: the frame's palette is its local one, else the
global one; a palette that is the gray ramp ``(i, i, i)`` counts as none,
and a frame without a palette is gray (its indexes are the levels); an
index past the palette is black.  A frame smaller than the logical screen
lies at its offset on a canvas filled with the transparency index where
the frame's graphic control extension sets one, else with index 0 (the
transparency itself is dropped by ``convert("RGB")``); a frame past the
screen widens the canvas.

What raises a ``ValueError`` naming the source and the reason (PIL raises
too): no image in the file, a minimum code size past 8 (PIL takes up to 11
and keeps each index's low byte), corrupt LZW data, an end code before
the frame is complete, data that ends first.  The file path
(``cv2.imread``'s globs) does not read GIF: ``img_utils.decode_image``
refuses it there.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import NamedTuple, Optional

import numpy as np

from .device import build_library, package_path
from .png import MAX_PIXELS

GIF_MAGICS = (b"GIF87a", b"GIF89a")

_SRC = package_path("runtime", "csrc", "lzw.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the LZW decoders (no-op when the built library is up to
    date)."""
    return build_library(
        "crdr_lzw", [_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC])


def get_lib() -> ctypes.CDLL:
    """The LZW library (GIF here, TIFF in ``utils/tiff.py``)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                i, n = ctypes.c_int, ctypes.c_int64
                c, p = ctypes.c_char_p, ctypes.c_void_p
                lib.crdr_gif_lzw.restype = i
                lib.crdr_gif_lzw.argtypes = [c, n, i, i, i, i, p, c, i]
                lib.crdr_tiff_lzw.restype = n
                lib.crdr_tiff_lzw.argtypes = [c, n, p, n, c, i]
                _lib = lib
    return _lib


class GifFrame(NamedTuple):
    """The first frame of a GIF and what its pixels need."""
    screen: tuple                 # the canvas (width, height)
    box: tuple                    # the frame's (x, y, width, height)
    interlace: bool
    bits: int                     # the LZW minimum code size
    data: bytes                   # from the first sub-block's length byte
    palette: Optional[bytes]      # RGB triples, None for a gray frame
    transparency: Optional[int]


def _palette(p: bytes) -> Optional[bytes]:
    """None for PIL's "no palette needed" (the gray ramp)."""
    for i in range(0, len(p), 3):
        if not i // 3 == p[i] == p[i + 1] == p[i + 2]:
            return p
    return None


def parse_gif(data: bytes, name: str = "GIF data") -> GifFrame:
    """The blocks of a GIF up to its first image (module doc)."""
    if data[:6] not in GIF_MAGICS or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    w, h, flags = struct.unpack_from("<HHB", data, 6)
    pos, palette = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = _palette(data[pos:pos + n])
        pos += n

    def sub_blocks(at: int):
        """(blocks, position past the terminator)."""
        out = []
        while at < len(data) and data[at]:
            out.append(data[at + 1:at + 1 + data[at]])
            at += 1 + data[at]
        return out, at + 1

    transparency = None
    while pos < len(data):
        tag = data[pos:pos + 1]
        pos += 1
        if tag == b";":
            break
        if tag == b"!":
            label = data[pos] if pos < len(data) else -1
            blocks, pos = sub_blocks(pos + 1)
            if label == 249 and blocks:
                if len(blocks[0]) < 4:
                    raise ValueError(f"{name}: short GIF graphic control "
                                     "extension")
                if blocks[0][0] & 1:
                    transparency = blocks[0][3]
        elif tag == b",":
            if pos + 10 > len(data):
                raise ValueError(f"{name}: truncated GIF image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                palette = _palette(data[pos:pos + n])
                pos += n
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF image data")
            screen = (max(w, x0 + fw), max(h, y0 + fh))
            if fw == 0 or fh == 0 or screen[0] * screen[1] > MAX_PIXELS:
                raise ValueError(f"{name}: GIF frame of {fw}x{fh} on a "
                                 f"{screen[0]}x{screen[1]} screen")
            return GifFrame(screen, (x0, y0, fw, fh), bool(fflags & 0x40),
                            data[pos], data[pos + 1:], palette,
                            transparency)
        # PIL skips any other byte
    raise ValueError(f"{name}: no image in the GIF file")


def frame_indexes(frame: GifFrame, name: str = "GIF data") -> np.ndarray:
    """The frame's LZW data -> uint8 [h, w] indexes, in C++."""
    _, _, fw, fh = frame.box
    out = np.zeros((fh, fw), np.uint8)
    err = ctypes.create_string_buffer(256)
    rc = get_lib().crdr_gif_lzw(frame.data, len(frame.data), frame.bits, fw,
                                fh, int(frame.interlace), out.ctypes.data,
                                err, len(err))
    if rc < 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    if rc == 1:
        raise ValueError(f"{name}: GIF LZW end code before the frame's last "
                         "row (PIL: image file is truncated)")
    if rc == 2:
        raise ValueError(f"{name}: truncated GIF image data")
    return out


def decode_gif(data: bytes, name: str = "GIF data") -> np.ndarray:
    """GIF bytes -> uint8 [H, W, 3] RGB of the first frame, as PIL's
    ``convert("RGB")`` reads a request body (module doc).  Raises
    ``ValueError`` starting with ``name``."""
    frame = parse_gif(data, name)
    (sw, sh), (x0, y0, fw, fh) = frame.screen, frame.box
    canvas = np.full((sh, sw), frame.transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame_indexes(frame, name)
    if frame.palette is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    pal = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(frame.palette, np.uint8)
    pal[:len(entries) // 3] = entries[:len(entries) // 3 * 3].reshape(-1, 3)
    return pal[canvas]
