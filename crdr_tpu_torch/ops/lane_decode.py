"""K2: one lane-rans32 decode round — CUDA kernel wrapper and launch count.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_lane_decode.py::
pallas_lane_decode_round``.  ``lane_decode_round`` takes the arguments of the
plain twin ``ops/device_rans.lane_decode_round_instep`` and returns the same
values, ``(vals [N, m] int32, states [N, K] int64, ptrs [N, K] int32)``; the
states and ptrs carry from one round to the next.

* On a CUDA tensor it launches ``csrc/lane_decode.cu`` (built with nvcc for
  sm_90a into ``build/crdr_tpu_torch/`` at first use, loaded with ctypes) or
  raises, on a shape the kernel does not take or a failed launch; it never
  falls back to the twin, and no size or setting gates it.
* On a CPU tensor it runs the twin.
* ``lane_decode_round.launches`` counts kernel launches.

The source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..utils.device import build_library, nvcc_command, package_path
from .device_rans import lane_decode_round_instep

Tensor = torch.Tensor

_SRC = package_path("csrc", "lane_decode.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_MAX_LANES = 1024  # one thread per lane, one block per image


def build() -> str:
    """Compile the kernel library (no-op when up to date); the compiler's
    register / shared-memory report is kept beside it as ``.log``."""
    return build_library("crdr_lane_decode", [_SRC], nvcc_command(_SRC))


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.crdr_lane_decode_round.restype = i
                lib.crdr_lane_decode_round.argtypes = [
                    p, p, p, i, i, i, p, i, i, p, i, i, p, p, p, p, p, p]
                _lib = lib
    return _lib


def _expect(t: Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"lane_decode_round: {name} must be contiguous {dtype} {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def lane_decode_round(states: Tensor, ptrs: Tensor, words: Tensor,
                      idx: Tensor, cdf: Tensor, cdf_len: Tensor,
                      cdf_off: Tensor, m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Decode one round of ``m`` symbols per image (see the module doc).

    states [N, K] int64 (uint32 values), ptrs [N, K] int32, words [N, K, W]
    int32 (16-bit values), idx [N, M >= m] int32 (CDF rows in [0, R)),
    cdf [R, L] int32 with cdf_len <= L, cdf_len / cdf_off [R] int32."""
    if states.device.type == "cpu":
        return lane_decode_round_instep(states, ptrs, words, idx, cdf,
                                        cdf_len, cdf_off, m)
    if states.device.type != "cuda":
        raise ValueError(f"lane_decode_round: unsupported device "
                         f"{states.device}")
    dev = states.device
    n, k = states.shape
    if words.dim() != 3 or idx.dim() != 2 or cdf.dim() != 2:
        raise ValueError("lane_decode_round: words [N, K, W], idx [N, M] and "
                         "cdf [R, L] expected")
    w, r, big_l = words.shape[2], cdf.shape[0], cdf.shape[1]
    if not 0 < k <= _MAX_LANES or w < 1 or not 0 <= m <= idx.shape[1]:
        raise ValueError(f"lane_decode_round: K {k} (1..{_MAX_LANES}), W {w} "
                         f"(>= 1), m {m} (0..{idx.shape[1]}) out of range")
    _expect(states, "states", torch.int64, (n, k), dev)
    _expect(ptrs, "ptrs", torch.int32, (n, k), dev)
    _expect(words, "words", torch.int32, (n, k, w), dev)
    _expect(idx, "idx", torch.int32, (n, idx.shape[1]), dev)
    _expect(cdf, "cdf", torch.int32, (r, big_l), dev)
    _expect(cdf_len, "cdf_len", torch.int32, (r,), dev)
    _expect(cdf_off, "cdf_off", torch.int32, (r,), dev)
    vals = torch.empty((n, m), dtype=torch.int32, device=dev)
    st_out = torch.empty_like(states)
    pt_out = torch.empty_like(ptrs)
    with torch.cuda.device(dev):
        rc = _get_lib().crdr_lane_decode_round(
            states.data_ptr(), ptrs.data_ptr(), words.data_ptr(), n, k, w,
            idx.data_ptr(), idx.shape[1], m, cdf.data_ptr(), r, big_l,
            cdf_len.data_ptr(), cdf_off.data_ptr(), vals.data_ptr(),
            st_out.data_ptr(), pt_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_decode_round: kernel launch failed "
                           f"(cudaError {rc})")
    lane_decode_round.launches += 1
    return vals, st_out, pt_out


lane_decode_round.launches = 0
