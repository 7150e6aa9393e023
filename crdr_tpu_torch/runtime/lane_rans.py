"""Lane-interleaved rans32 host coder: the "device" wire format.

The port's own copy of ``crdr_tpu/runtime/lane_rans.py`` (same
``csrc/rans.cpp`` lane section, same container bytes).  K independent
32-bit rANS streams per image, 16-bit renorm words, symbols assigned to
lanes by ``flat_position % K`` (restarting at each round boundary), so the
GPU decodes all K lanes of an image in one kernel (``ops/lane_decode.py``)
with one CDF search and at most one stream word read per lane per step.

Out-of-range symbols are coded as the escape slot; their true values ride a
(position, value) fixup side channel in the container.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from . import _get_lib, _i32

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U16P = ctypes.POINTER(ctypes.c_uint16)

_FIXUP_OVERFLOW = -2   # lane_rans_encode's "fixup buffer too small"
_MAX_FIX_CAP = 1 << 20


def lane_encode(values: np.ndarray, indexes: np.ndarray,
                slice_offsets: Sequence[int], num_lanes: int,
                cdfs: np.ndarray, cdf_lengths: np.ndarray,
                offsets: np.ndarray, fix_cap: int = 4096
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Encode flat ``values``/``indexes`` into ``num_lanes`` rans32 streams.

    ``slice_offsets``: monotone boundaries (0 .. n) where the lane
    assignment restarts, one entry per autoregressive decode round.
    ``fix_cap`` is the first size of the fixup buffer; it grows 4x while the
    escapes overflow it, up to 2^20 (the codec's ``device_wire_fixup_cap``
    growth: the fixup count never changes the bytes).

    Returns ``(words [K, max_len] uint16, lens [K] int32,
    fix_pos [F] int64, fix_val [F] int32)``.
    """
    lib = _get_lib()
    values = _i32(values).reshape(-1)
    indexes = _i32(indexes).reshape(-1)
    n = values.size
    if indexes.size != n:
        raise ValueError(f"{n} values but {indexes.size} indexes")
    off = np.ascontiguousarray(slice_offsets, dtype=np.int64)
    if off[0] != 0 or off[-1] != n:
        raise ValueError(f"slice offsets must run from 0 to {n}")
    cdfs = _i32(cdfs)
    cdf_lengths = _i32(cdf_lengths)
    offsets = _i32(offsets)
    K = int(num_lanes)
    # worst case 2 words/symbol + 2 state words per lane
    lane_cap = 2 * ((n + K - 1) // K) + 4
    words = np.zeros((K, lane_cap), dtype=np.uint16)
    lens = np.zeros(K, dtype=np.int32)
    cap = int(fix_cap)
    while True:
        fix_pos = np.zeros(cap, dtype=np.int64)
        fix_val = np.zeros(cap, dtype=np.int32)
        rc = lib.lane_rans_encode(
            values.ctypes.data_as(_I32P), indexes.ctypes.data_as(_I32P), n,
            off.ctypes.data_as(_I64P), off.size - 1, K,
            cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
            cdf_lengths.ctypes.data_as(_I32P), offsets.ctypes.data_as(_I32P),
            words.ctypes.data_as(_U16P), lane_cap, lens.ctypes.data_as(_I32P),
            fix_pos.ctypes.data_as(_I64P), fix_val.ctypes.data_as(_I32P), cap)
        if rc == _FIXUP_OVERFLOW and cap * 4 <= _MAX_FIX_CAP:
            cap *= 4
            continue
        break
    if rc < 0:
        raise RuntimeError(f"lane_rans_encode failed (code {rc})")
    f = int(rc)
    max_len = int(lens.max()) if K else 2
    return words[:, :max_len].copy(), lens, fix_pos[:f].copy(), \
        fix_val[:f].copy()


class LaneStreamDecoder:
    """Streaming CPU decoder for the device wire (the oracle of K2).

    ``decode(indexes)`` pulls the next ``len(indexes)`` symbols, one
    autoregressive round, with the lane assignment restarting each call.
    Escape slots decode to the escape value; the caller overlays fixups.
    """

    def __init__(self, words: np.ndarray, lens: np.ndarray):
        self._lib = _get_lib()
        words = np.ascontiguousarray(words, dtype=np.uint16)
        lens = _i32(lens)
        self._keep = (words, lens)
        self._handle = self._lib.lane_decoder_new(
            words.ctypes.data_as(_U16P), lens.ctypes.data_as(_I32P),
            words.shape[0], words.shape[1])
        if not self._handle:
            raise RuntimeError("invalid lane stream")

    def decode(self, indexes: np.ndarray, cdfs: np.ndarray,
               cdf_lengths: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        indexes = _i32(indexes).reshape(-1)
        cdfs = _i32(cdfs)
        out = np.zeros(indexes.size, dtype=np.int32)
        self._lib.lane_decoder_decode(
            self._handle, indexes.ctypes.data_as(_I32P), indexes.size,
            cdfs.ctypes.data_as(_I32P), cdfs.shape[0], cdfs.shape[1],
            _i32(cdf_lengths).ctypes.data_as(_I32P),
            _i32(offsets).ctypes.data_as(_I32P),
            out.ctypes.data_as(_I32P))
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.lane_decoder_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# Device-wire y strings are self-describing: 4-byte magic + 1-byte version.
# The CompressAI wire cannot carry a marker (its byte layout is the
# reference contract), so the marker lives on the lane format and both
# decode paths check it: a config / bitstream wire mismatch fails loudly.
LANE_MAGIC = b"CRDW\x01"
_U16_MAX = 0xFFFF


def pack_lane_container(words: np.ndarray, lens: np.ndarray,
                        fix_pos: np.ndarray, fix_val: np.ndarray) -> bytes:
    """Serialize one image's lane streams + fixups to bytes.

    Layout (little-endian): magic ``CRDW`` + u8 version, u16 K, u16 n_fix,
    per-lane u16 length, per-fixup (u32 pos, i32 value), then each lane's
    words back to back (no padding on the wire; the decoder re-pads).
    Counts that do not fit their u16 field raise instead of wrapping.
    """
    K = int(words.shape[0])
    f = int(fix_pos.size)
    if K > _U16_MAX or f > _U16_MAX or (lens.size and lens.max() > _U16_MAX):
        raise ValueError(
            f"lane container overflow: {K} lanes, {f} fixups, longest lane "
            f"{int(lens.max()) if lens.size else 0} words (each at most "
            f"{_U16_MAX})")
    head = LANE_MAGIC + np.asarray([K, f], dtype=np.uint16).tobytes()
    lens16 = lens.astype(np.uint16).tobytes()
    fix = b""
    if f:
        fix = (fix_pos.astype(np.uint32).tobytes()
               + fix_val.astype(np.int32).tobytes())
    body = b"".join(words[j, :int(lens[j])].tobytes() for j in range(K))
    return head + lens16 + fix + body


def unpack_lane_container(blob: bytes
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_lane_container`; re-pads words to [K, max]."""
    if blob[:len(LANE_MAGIC)] != LANE_MAGIC:
        raise ValueError(
            "not a device-wire lane container (missing CRDW magic): this "
            "bitstream was written with the compressai wire format; set "
            "wire_format: compressai to decode it")
    o = len(LANE_MAGIC)
    K, f = np.frombuffer(blob, dtype=np.uint16, count=2, offset=o)
    K, f = int(K), int(f)
    o += 4
    lens = np.frombuffer(blob, dtype=np.uint16, count=K, offset=o) \
        .astype(np.int32)
    o += 2 * K
    fix_pos = np.frombuffer(blob, dtype=np.uint32, count=f, offset=o) \
        .astype(np.int64)
    o += 4 * f
    fix_val = np.frombuffer(blob, dtype=np.int32, count=f, offset=o).copy()
    o += 4 * f
    max_len = int(lens.max()) if K else 2
    words = np.zeros((K, max_len), dtype=np.uint16)
    for j in range(K):
        lj = int(lens[j])
        words[j, :lj] = np.frombuffer(blob, dtype=np.uint16, count=lj,
                                      offset=o)
        o += 2 * lj
    return words, lens, fix_pos, fix_val
