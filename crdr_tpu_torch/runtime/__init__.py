"""Host-side native runtime: rANS entropy coder + CDF quantizer (C++ via ctypes).

The port's own copy of the JAX package's runtime (same ``csrc/rans.cpp``
wire formats: the CompressAI-compatible coder here, the lane-interleaved
rans32 coder of the device wire in ``lane_rans.py``).  The shared library is
built with ``g++`` at first use into ``build/crdr_tpu_torch/``; all
functions take and return numpy arrays.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..utils.device import build_library, package_path

_SRC = package_path("runtime", "csrc", "rans.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the coder (no-op when the built library is up to date)."""
    return build_library(
        "crdr_rans", [_SRC],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", _SRC])


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)

            lib.pmf_to_quantized_cdf_c.restype = ctypes.c_int
            lib.pmf_to_quantized_cdf_c.argtypes = [f32p, ctypes.c_int,
                                                   ctypes.c_int, i32p]
            lib.rans_encode_with_indexes.restype = ctypes.c_int64
            lib.rans_encode_with_indexes.argtypes = [
                i32p, i32p, ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int,
                i32p, i32p, u8p, ctypes.c_int64]
            lib.rans_decode_with_indexes.restype = ctypes.c_int64
            lib.rans_decode_with_indexes.argtypes = [
                u8p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, ctypes.c_int,
                ctypes.c_int, i32p, i32p, i32p]
            lib.rans_decoder_new.restype = ctypes.c_void_p
            lib.rans_decoder_new.argtypes = [u8p, ctypes.c_int64]
            lib.rans_decoder_decode.restype = None
            lib.rans_decoder_decode.argtypes = [
                ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int,
                ctypes.c_int, i32p, i32p, i32p]
            lib.rans_decoder_free.restype = None
            lib.rans_decoder_free.argtypes = [ctypes.c_void_p]

            # lane-interleaved rans32 (the device wire, see lane_rans.py)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.lane_rans_encode.restype = ctypes.c_int64
            lib.lane_rans_encode.argtypes = [
                i32p, i32p, ctypes.c_int64, i64p, ctypes.c_int, ctypes.c_int,
                i32p, ctypes.c_int, ctypes.c_int, i32p, i32p, u16p,
                ctypes.c_int64, i32p, i64p, i32p, ctypes.c_int64]
            lib.lane_decoder_new.restype = ctypes.c_void_p
            lib.lane_decoder_new.argtypes = [u16p, i32p, ctypes.c_int,
                                             ctypes.c_int64]
            lib.lane_decoder_decode.restype = None
            lib.lane_decoder_decode.argtypes = [
                ctypes.c_void_p, i32p, ctypes.c_int64, i32p, ctypes.c_int,
                ctypes.c_int, i32p, i32p, i32p]
            lib.lane_decoder_free.restype = None
            lib.lane_decoder_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


_I32P = ctypes.POINTER(ctypes.c_int32)


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = 16) -> np.ndarray:
    """PMF (tail mass as last entry) -> integer CDF of length n+1."""
    lib = _get_lib()
    pmf = np.ascontiguousarray(pmf, dtype=np.float32)
    out = np.zeros(pmf.size + 1, dtype=np.int32)
    rc = lib.pmf_to_quantized_cdf_c(
        pmf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pmf.size,
        precision, out.ctypes.data_as(_I32P))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed (code {rc})")
    return out


def rans_encode_with_indexes(symbols: np.ndarray, indexes: np.ndarray,
                             cdfs: np.ndarray, cdf_lengths: np.ndarray,
                             offsets: np.ndarray) -> bytes:
    lib = _get_lib()
    symbols = _i32(symbols).reshape(-1)
    indexes = _i32(indexes).reshape(-1)
    cdfs = _i32(cdfs)
    cdf_lengths = _i32(cdf_lengths)
    offsets = _i32(offsets)
    assert symbols.size == indexes.size
    # worst case: every symbol escapes with a ~32-bit bypass (~12 bytes/sym)
    cap = 16 * symbols.size + 64
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.rans_encode_with_indexes(
        symbols.ctypes.data_as(_I32P), indexes.ctypes.data_as(_I32P),
        symbols.size, cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
        cdf_lengths.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I32P),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"rans encode failed (code {n})")
    return out[:n].tobytes()


def rans_decode_with_indexes(stream: bytes, indexes: np.ndarray,
                             cdfs: np.ndarray, cdf_lengths: np.ndarray,
                             offsets: np.ndarray) -> np.ndarray:
    lib = _get_lib()
    indexes = _i32(indexes).reshape(-1)
    cdfs = _i32(cdfs)
    cdf_lengths = _i32(cdf_lengths)
    offsets = _i32(offsets)
    buf = np.frombuffer(stream, dtype=np.uint8)
    out = np.zeros(indexes.size, dtype=np.int32)
    rc = lib.rans_decode_with_indexes(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        indexes.ctypes.data_as(_I32P), indexes.size,
        cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
        cdf_lengths.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I32P),
        out.ctypes.data_as(_I32P))
    if rc < 0:
        raise RuntimeError(f"rans decode failed (code {rc})")
    return out


class RansStreamDecoder:
    """Streaming decoder for the Charm autoregressive decode loop: the
    bitstream is attached once, then slices are pulled out incrementally."""

    def __init__(self, stream: bytes):
        self._lib = _get_lib()
        buf = np.frombuffer(stream, dtype=np.uint8)
        self._buf = buf
        self._handle = self._lib.rans_decoder_new(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
        if not self._handle:
            raise RuntimeError("invalid rans stream")

    def decode(self, indexes: np.ndarray, cdfs: np.ndarray,
               cdf_lengths: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        indexes = _i32(indexes).reshape(-1)
        cdfs = _i32(cdfs)
        out = np.zeros(indexes.size, dtype=np.int32)
        self._lib.rans_decoder_decode(
            self._handle, indexes.ctypes.data_as(_I32P), indexes.size,
            cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
            _i32(cdf_lengths).ctypes.data_as(_I32P),
            _i32(offsets).ctypes.data_as(_I32P), out.ctypes.data_as(_I32P))
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rans_decoder_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
