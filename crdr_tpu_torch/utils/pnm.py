"""PNM reading on the host (PBM, PGM, PPM: P1 to P6, and PFM), as PIL's
``PpmImagePlugin`` reads a request body and ``convert("RGB")`` turns it to
RGB, or as ``cv2.imread`` reads a file (no JAX counterpart for bodies: the
JAX server calls PIL; the JAX package's files go through cv2; the machines
the port runs on have neither).  numpy only.

The header: the magic, then the width, the height and (but for P1 / P4)
the maxval or PFM's scale, each a token of at most 10 bytes after
whitespace; ``#`` starts a comment that runs to CR or LF, also inside a
token, whose two halves then join (PIL's ``_read_token``).  The data
starts after the single whitespace byte that ends the last token.

* P1 / P4: bilevel, 1 black; P4's rows padded to whole bytes.
* P2 / P3 (plain): each sample ``round(v / maxval * M)`` in Python's float
  rounding (half to even); M is 255, or 65535 for gray with a maxval past
  255 (PIL's mode ``I``).  PIL checks every byte of a 64 KiB block of P1
  data and every token it reads for P2 / P3.
* P5 / P6 (raw): a maxval of 255 as it is; gray at 65535 as 16-bit
  big-endian ``I`` values; any other maxval scaled as above (two
  big-endian bytes a sample past 255).
* ``I`` to RGB clips each value to 255 (so 16-bit gray is mostly white,
  where cv2 would scale it); ``Pf`` (32-bit floats, bottom-up rows,
  little-endian when the scale is negative) goes to RGB through ``L``,
  each value clipped to 0-255 and truncated.

What raises a ``ValueError`` naming the source and the reason (PIL raises
too): another magic (PIL's colour ``PF`` among them), a token past 10
bytes, a maxval outside 1-65535, a sample past the maxval, a P1 byte other
than 0 / 1, a scale of 0 or not finite, data that ends before the image,
more than ``MAX_PIXELS`` pixels.

A file follows OpenCV (``grfmt_pxm.cpp``, ``grfmt_pfm.cpp``): header
numbers after whitespace and ``#`` comments to CR or LF, any other byte
refused, the byte after the digits consumed (so a number must end before
the data does); P1 digits one at a time, any but 0 black; raw samples as
they are, past the maxval too, a 16-bit one's high byte; plain samples
clipped to the maxval and scaled by ``v * 255 // maxval`` (past 255: the
high byte); colour PFM (``PF``) divided by its scale's magnitude, rounded
and saturated, the gray ``Pf`` None (cv2's buffer of one channel).
"""

from __future__ import annotations

import math
import re

import numpy as np

from .png import MAX_PIXELS

WHITESPACE = b" \t\n\x0b\x0c\r"
_MAGIC = re.compile(rb"P[1-6fF][ \t\n\x0b\x0c\r]")
_BLOCK = 65536  # PIL's SAFEBLOCK: P1 / P2 / P3 data are read in blocks


def is_pnm(data: bytes) -> bool:
    """``P1`` to ``P6`` (or PFM's ``Pf`` / ``PF``) followed by
    whitespace."""
    return _MAGIC.match(data) is not None


class _Reader:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def fail(self, why: str):
        raise ValueError(f"{self.name}: {why}")

    def read(self, n: int = 1) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":  # b"" (the end) too
                    pass
                continue
            token += c
        if not token:
            self.fail("PNM header ends early")
        if len(token) > 10:
            self.fail(f"PNM header token too long ({token[:11]!r})")
        return token

    def number(self, kind=int):
        tok = self.token()
        try:
            return kind(tok)
        except ValueError:
            self.fail(f"PNM header token {tok!r} is not a number")


def _comment_end(block: bytes, start: int = 0) -> int:
    """PIL's ``_find_comment_end``, as written: the lower of the CR / LF
    found, but the higher when one of them is at index 0."""
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_blocks(data: bytes):
    """The data of a plain PNM in PIL's 64 KiB blocks with its comments
    removed (a comment may span blocks)."""
    spans = False
    for start in range(0, len(data), _BLOCK):
        block = data[start:start + _BLOCK]
        if spans:
            end = _comment_end(block)
            if end < 0:
                continue
            block, spans = block[end + 1:], False
        while True:
            at = block.find(b"#")
            if at < 0:
                break
            end = _comment_end(block, at)
            if end >= 0:
                block = block[:at] + block[end + 1:]
            else:
                block, spans = block[:at], True
                break
        yield block


def _plain_bitonal(data: bytes, total: int, name: str) -> np.ndarray:
    out = bytearray()
    for block in _plain_blocks(data):
        tokens = b"".join(block.split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"{name}: P1 data byte {bad[:1]!r} is not 0 or 1")
        out = (out + tokens)[:total]
        if len(out) == total:
            break
    if len(out) < total:
        raise ValueError(f"{name}: truncated PNM data")
    return np.frombuffer(bytes(out), np.uint8) == ord("0")


def _plain_values(data: bytes, total: int, maxval: int, out_max: int,
                  name: str) -> np.ndarray:
    values, half = [], b""
    blocks = _plain_blocks(data)
    while len(values) < total:
        block = next(blocks, None)
        if block is None:
            if not half:
                break
            block = b" "
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{name}: PNM data token too long")
        for tok in tokens:
            if len(tok) > 10:
                raise ValueError(f"{name}: PNM data token too long")
            try:
                v = int(tok)
            except ValueError:
                raise ValueError(f"{name}: PNM data token {tok!r} is not a "
                                 "number") from None
            if v < 0 or v > maxval:
                raise ValueError(f"{name}: PNM sample {v} outside 0-{maxval}")
            values.append(round(v / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError(f"{name}: truncated PNM data")
    return np.asarray(values, np.int64)


def _to_rgb(v: np.ndarray, h: int, w: int, bands: int) -> np.ndarray:
    """Values of mode L / RGB / I -> uint8 [h, w, 3] (``I`` clipped)."""
    v = np.clip(v, 0, 255).astype(np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(np.broadcast_to(v, (h, w, 3)))


class _Cv2Reader(_Reader):
    """OpenCV's ``ReadNumber`` (``grfmt_pxm.cpp``): whitespace and
    ``#`` comments (to CR or LF) skipped, any other byte that is not a
    digit refused; the byte after the digits is consumed."""

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("PNM data ends early (cv2.imread returns None)")
        self.pos += 1
        return self.data[self.pos - 1]

    def cv_number(self, maxdigits: int = 0) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#'
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in WHITESPACE:
                while c in WHITESPACE:
                    c = self.byte()
            else:
                self.fail(f"PNM byte 0x{c:02x} where cv2 wants a number "
                          "(cv2.imread returns None)")
        v, digits = 0, 0
        while True:
            v = v * 10 + c - 48
            if v > 0x7FFFFFFF:
                self.fail("PNM number too large (cv2.imread returns None)")
            digits += 1
            if maxdigits and digits >= maxdigits:
                return v
            c = self.byte()  # a number must end before the data does
            if not 48 <= c <= 57:
                return v


def _decode_pfm_cv2(data: bytes, name: str) -> np.ndarray:
    """OpenCV's PFM reader (``grfmt_pfm.cpp``): colour ``PF`` only (its
    gray ``Pf`` reaches ``imread`` as one channel, which returns None),
    each value times the reciprocal of the scale's magnitude in float32,
    then rounded half to even and saturated to 8 bits (no factor of 255:
    a value in 0-1 gives 0 or 1)."""
    if data[1:2] == b"f":
        raise ValueError(f"{name}: gray PFM (Pf) file (cv2.imread returns "
                         "None)")
    if data[2:3] != b"\n":
        raise ValueError(f"{name}: PFM magic without a line feed")
    pos, tokens = 3, []
    for _ in range(3):
        end = pos
        while end < len(data) and end - pos < 64 and \
                data[end] not in WHITESPACE:
            end += 1
        tokens.append(data[pos:end])
        pos = end + 1
    try:
        w, h, scale = int(tokens[0]), int(tokens[1]), float(tokens[2])
    except ValueError:
        raise ValueError(f"{name}: PFM header {tokens!r}") from None
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS or scale == 0.0:
        raise ValueError(f"{name}: PFM image of {w}x{h}, scale {scale}")
    n = 3 * w * h
    if len(data) - pos < 4 * n:
        raise ValueError(f"{name}: truncated PFM data (cv2.imread returns "
                         "None)")
    f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos)
    f = f.reshape(h, w, 3)[::-1].astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        v = f * np.float32(1.0 / abs(scale))
        v = np.where(np.isnan(v), 0, np.clip(np.rint(v), 0, 255))
    return v.astype(np.uint8)


def _decode_pnm_cv2(data: bytes, name: str) -> np.ndarray:
    """A PNM file as ``cv2.imread`` reads it (OpenCV's ``grfmt_pxm.cpp``,
    module doc)."""
    if data[1:2] in (b"f", b"F"):
        return _decode_pfm_cv2(data, name)
    magic = data[1] - 48
    r = _Cv2Reader(data, name)
    r.pos = 2
    w, h = r.cv_number(), r.cv_number()
    maxval = r.cv_number() if magic not in (1, 4) else 1
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise ValueError(f"{name}: PNM image of {w}x{h}, maxval {maxval} "
                         "(cv2.imread returns None)")
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: PNM image of {w}x{h} pixels")
    bands = 3 if magic in (3, 6) else 1
    n = w * h * bands
    if magic == 1:
        v = np.array([0 if r.cv_number(1) else 255 for _ in range(n)],
                     np.uint8)
    elif magic == 4:
        stride = (w + 7) // 8
        if len(data) - r.pos < stride * h:
            raise ValueError(f"{name}: truncated PNM data (cv2.imread "
                             "returns None)")
        raw = np.frombuffer(data, np.uint8, stride * h, r.pos)
        bits = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w]
        v = ((1 - bits) * 255).astype(np.uint8)
    elif magic in (2, 3):  # each sample clipped to the maxval, then scaled
        codes = np.minimum([r.cv_number() for _ in range(n)], maxval)
        v = (codes >> 8 if maxval > 255 else codes * 255 // maxval)
    else:  # raw samples as they are: 8 bits, or a 16-bit one's high byte
        size = 1 if maxval < 256 else 2
        if len(data) - r.pos < n * size:
            raise ValueError(f"{name}: truncated PNM data (cv2.imread "
                             "returns None)")
        v = np.frombuffer(data, np.uint8, n * size, r.pos)[::size]
    v = np.asarray(v, np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(np.broadcast_to(v, (h, w, 3)))


def decode_pnm(data: bytes, name: str = "PNM data",
               file_path: bool = False) -> np.ndarray:
    """PNM bytes -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")`` reads
    a request body or, with ``file_path``, as ``cv2.imread`` reads a file
    (module doc).  Raises ``ValueError`` starting with ``name``."""
    if not is_pnm(data):
        raise ValueError(f"{name}: not a PNM file (P1 to P6, Pf or PF)")
    if file_path:
        return _decode_pnm_cv2(data, name)
    if data[1:2] == b"F":
        raise ValueError(f"{name}: not a PNG, JPEG, BMP, WebP, GIF, PNM, "
                         "TIFF, JPEG 2000 or Sun raster file (PIL does not "
                         "read colour PFM)")
    magic = data[:2]
    r = _Reader(data, name)
    r.pos = 3
    w, h = r.number(), r.number()
    if w < 0 or h < 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: PNM image of {w}x{h} pixels")
    if w == 0 or h == 0:
        raise ValueError(f"{name}: PNM image of {w}x{h} pixels (empty)")
    total = w * h
    if magic in (b"P1", b"P4"):
        if magic == b"P1":
            white = _plain_bitonal(data[r.pos:], total, name)
        else:
            stride = (w + 7) // 8
            raw = np.frombuffer(data, np.uint8, count=max(
                0, min(stride * h, len(data) - r.pos)), offset=r.pos)
            if raw.size < stride * h:
                raise ValueError(f"{name}: truncated PNM data")
            white = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w] == 0
        return _to_rgb(white.astype(np.int64) * 255, h, w, 1)
    if magic == b"Pf":
        scale = r.number(float)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{name}: PFM scale {scale} (must be finite "
                             "and non-zero)")
        n = 4 * total
        if len(data) - r.pos < n:
            raise ValueError(f"{name}: truncated PNM data")
        f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", total, r.pos)
        f = f.reshape(h, w)[::-1].astype(np.float64)
        levels = np.where(f <= 0, 0, np.where(f >= 255, 255, np.nan_to_num(
            f, nan=0.0, posinf=255.0, neginf=0.0))).astype(np.int64)
        return _to_rgb(levels, h, w, 1)
    maxval = r.number()
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: PNM maxval {maxval} (must be 1-65535)")
    bands = 3 if magic in (b"P3", b"P6") else 1
    out_max = 65535 if bands == 1 and maxval > 255 else 255
    n = total * bands
    if magic in (b"P2", b"P3"):
        return _to_rgb(_plain_values(data[r.pos:], n, maxval, out_max, name),
                       h, w, bands)
    size = 1 if maxval < 256 else 2
    if len(data) - r.pos < n * size:
        raise ValueError(f"{name}: truncated PNM data")
    v = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, r.pos)
    v = v.astype(np.int64)
    if maxval != 255 and not (bands == 1 and maxval == 65535):
        v = np.minimum(out_max, np.round(v / maxval * out_max)).astype(
            np.int64)
    return _to_rgb(v, h, w, bands)
