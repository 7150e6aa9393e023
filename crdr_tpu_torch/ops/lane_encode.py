"""E1: the device wire's lane-rans32 encoder — CUDA kernel wrapper and its
launch count.

A port-only kernel: the JAX package encodes the device wire on the device
with ``crdr_tpu/ops/device_rans.py::lane_encode_rounds``, a reverse
``lax.scan`` (no Pallas kernel).  ``lane_encode_rounds`` here takes that
function's arguments and returns its values (``ops/device_rans.py::
lane_encode_rounds``, the plain twin, documents them), with the words as
int32 holding 16-bit values:

* the slot resolution (each symbol's low and freq, laid onto the [T, K]
  grid of ``encode_grid``) and the escape fixups are torch gathers and
  cumsums on the tensors' device (``lane_encode_operands``,
  ``lane_fixups``), shared with the twin;
* the serial walk of every lane, the registered op
  ``crdr::lane_encode_scan`` (one node of an exported program): on a CUDA
  tensor its CUDA implementation launches ``csrc/lane_encode.cu`` (built
  with nvcc for sm_90a into ``build/crdr_tpu_torch/`` at first use, loaded
  with ctypes), which raises on a shape it does not take or a failed launch
  and never falls back; on a CPU tensor its CPU implementation, the twin's
  ``lane_encode_scan``;
* ``lane_encode_rounds.launches`` counts kernel launches.

The source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..utils.device import (build_library, count_launch, nvcc_command,
                            package_path)
from .device_rans import lane_encode_operands, lane_encode_scan, lane_fixups

Tensor = torch.Tensor

_SRC = package_path("csrc", "lane_encode.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the kernel library (no-op when up to date); the compiler's
    register report is kept beside it as ``.log``."""
    return build_library("crdr_lane_encode", [_SRC], nvcc_command(_SRC))


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.crdr_lane_encode.restype = i
                lib.crdr_lane_encode.argtypes = [p, p, i, i, i, p, p, p]
                _lib = lib
    return _lib


def launch_scan(low_g: Tensor, freq_g: Tensor) -> Tuple[Tensor, Tensor]:
    """One launch of the kernel on CUDA tensors (not counted): low_g /
    freq_g [N, T, K] int32 from ``lane_encode_operands``.  Returns (words
    [N, K, T+2] int32, lens [N, K] int32), as ``lane_encode_scan``."""
    if low_g.device.type != "cuda":
        raise ValueError(f"lane_encode_rounds: unsupported device "
                         f"{low_g.device}")
    if low_g.dim() != 3 or freq_g.shape != low_g.shape:
        raise ValueError("lane_encode_rounds: low and freq [N, T, K] "
                         "expected")
    n, t_steps, k = low_g.shape
    for t, name in ((low_g, "low"), (freq_g, "freq")):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != low_g.device:
            raise ValueError(f"lane_encode_rounds: {name} must be a "
                             f"contiguous int32 tensor on {low_g.device}")
    if k < 1:
        raise ValueError("lane_encode_rounds: K must be >= 1")
    dev = low_g.device
    words = torch.empty((n, k, t_steps + 2), dtype=torch.int32, device=dev)
    lens = torch.empty((n, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _get_lib().crdr_lane_encode(
            low_g.data_ptr(), freq_g.data_ptr(), n, t_steps, k,
            words.data_ptr(), lens.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_encode_rounds: kernel launch failed "
                           f"(cudaError {rc})")
    return words, lens


def lane_encode_rounds(sym: Tensor, idx: Tensor, grid: Tensor, cdf: Tensor,
                       cdf_len: Tensor, offset: Tensor,
                       fix_cap: Optional[int]
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Lane-encode [N, M] symbols / CDF rows in consumption order over the
    [T, K] ``grid`` (see the module doc).  Returns (words [N, K, T+2],
    lens [N, K], fix_pos [N, F], fix_val [N, F], n_esc [N]), int32, F =
    ``fix_cap`` (M when None: every escape is kept).  Nothing syncs with
    the host."""
    low_g, freq_g, esc = lane_encode_operands(sym, idx, grid, cdf, cdf_len,
                                              offset)
    words, lens = torch.ops.crdr.lane_encode_scan(low_g, freq_g)
    return (words, lens) + lane_fixups(sym, esc, fix_cap)


lane_encode_rounds.launches = 0


@torch.library.custom_op("crdr::lane_encode_scan", mutates_args=(),
                         device_types="cuda")
def _lane_encode_scan_op(low_g: Tensor,
                         freq_g: Tensor) -> Tuple[Tensor, Tensor]:
    """The kernel: one counted launch (``launch_scan``)."""
    out = launch_scan(low_g, freq_g)
    count_launch(lane_encode_rounds)
    return out


@_lane_encode_scan_op.register_kernel("cpu")
def _lane_encode_scan_cpu(low_g, freq_g):
    return lane_encode_scan(low_g, freq_g)


@_lane_encode_scan_op.register_fake
def _lane_encode_scan_fake(low_g, freq_g):
    n, t_steps, k = low_g.shape
    return (low_g.new_empty((n, k, t_steps + 2)),
            low_g.new_empty((n, k)))
