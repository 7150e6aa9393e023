"""E1: the device wire's lane-rans32 encoder — CUDA kernel wrapper and its
launch count.

A port-only kernel: the JAX package encodes the device wire on the device
with ``crdr_tpu/ops/device_rans.py::lane_encode_rounds``, a reverse
``lax.scan`` (no Pallas kernel).  ``lane_encode_rounds`` here takes that
function's arguments and returns its values (``ops/device_rans.py::
lane_encode_rounds``, the plain twin, documents them), with the words as
int32 holding 16-bit values; the codec also hands it its precomputed
tables:

* ``perm`` (lane order -> the order the codec produced the symbols in) and
  ``pos`` (``device_rans.lane_positions``: the grid composed with ``perm``,
  built once per latent shape): the symbols are read where they lie, with
  no permuted copy;
* ``etab`` (``device_rans.encode_table``: per CDF row and slot, low, freq
  and freq's exact reciprocal, built once per table at ``codec_setup``);
* the slot resolution and the serial walk of every lane are one registered
  op, ``crdr::lane_encode`` (one node of an exported program): on a CUDA
  tensor its CUDA implementation launches ``csrc/lane_encode.cu`` (built
  with nvcc for sm_90a into ``build/crdr_tpu_torch/`` at first use, loaded
  with ctypes), which raises on a shape it does not take or a failed launch
  and never falls back; on a CPU tensor its CPU implementation, the twin's
  ``lane_encode_walk``.  It returns the words, the lane lengths and a
  per-symbol escape flag in lane order;
* the escape fixups from those flags are torch cumsums and scatters
  (``device_rans.lane_fixups``), shared with the twin;
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
from .device_rans import (encode_table, lane_encode_walk, lane_fixups,
                          lane_positions)

Tensor = torch.Tensor

_SRC = package_path("csrc", "lane_encode.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
MAX_ROWS = 4096  # CDF rows whose len / offset the kernel keeps in shared memory


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
                p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
                lib.crdr_lane_encode.restype = i
                lib.crdr_lane_encode.argtypes = [p, q, p, q, p, p, p, p, p,
                                                 i, i, i, i, i, i, p, p, p, p]
                _lib = lib
    return _lib


def _check_walk(sym: Tensor, idx: Tensor, grid: Tensor, pos: Tensor,
                etab: Tensor, cdf_len: Tensor, offset: Tensor) -> None:
    dev = sym.device
    if sym.dim() != 2 or idx.dim() != 2 or idx.shape[1] != sym.shape[1] \
            or idx.shape[0] not in (1, sym.shape[0]):
        raise ValueError("lane_encode_rounds: sym [N, M] and idx [N or 1, "
                         "M] expected")
    for t, name in ((sym, "sym"), (idx, "idx")):
        if t.dtype != torch.int32 or t.device != dev \
                or (t.shape[1] > 1 and t.stride(1) != 1):
            raise ValueError(f"lane_encode_rounds: {name} must be int32 on "
                             f"{dev} with unit stride along a row")
    if grid.dim() != 2 or pos.shape != grid.shape or grid.shape[1] < 1:
        raise ValueError("lane_encode_rounds: grid and pos [T, K >= 1] "
                         "expected")
    rows = cdf_len.shape[0]
    if etab.dim() != 3 or etab.shape[0] != rows or etab.shape[2] != 4 \
            or offset.shape != cdf_len.shape or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"lane_encode_rounds: etab [R, L, 4], cdf_len and "
                         f"offset [R] with 1 <= R <= {MAX_ROWS} expected")
    for t, name in ((grid, "grid"), (pos, "pos"), (etab, "etab"),
                    (cdf_len, "cdf_len"), (offset, "offset")):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"lane_encode_rounds: {name} must be a "
                             f"contiguous int32 tensor on {dev}")


def launch_walk(sym: Tensor, idx: Tensor, grid: Tensor, pos: Tensor,
                etab: Tensor, cdf_len: Tensor, offset: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch of the kernel on CUDA tensors (not counted), with the
    arguments and values of ``device_rans.lane_encode_walk``: (words
    [N, K, T+2] int32, lens [N, K] int32, esc [N, M] bool)."""
    if sym.device.type != "cuda":
        raise ValueError(f"lane_encode_rounds: unsupported device "
                         f"{sym.device}")
    _check_walk(sym, idx, grid, pos, etab, cdf_len, offset)
    n, m = sym.shape
    t_steps, k = grid.shape
    dev = sym.device
    words = torch.empty((n, k, t_steps + 2), dtype=torch.int32, device=dev)
    lens = torch.empty((n, k), dtype=torch.int32, device=dev)
    esc = torch.empty((n, m), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _get_lib().crdr_lane_encode(
            sym.data_ptr(), sym.stride(0), idx.data_ptr(),
            idx.stride(0) if idx.shape[0] == n else 0, grid.data_ptr(),
            pos.data_ptr(), etab.data_ptr(), cdf_len.data_ptr(),
            offset.data_ptr(), etab.shape[0], etab.shape[1], n, m, t_steps,
            k, words.data_ptr(), lens.data_ptr(), esc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_encode_rounds: kernel launch failed "
                           f"(cudaError {rc})")
    return words, lens, esc


def lane_encode_rounds(sym: Tensor, idx: Tensor, grid: Tensor, cdf: Tensor,
                       cdf_len: Tensor, offset: Tensor,
                       fix_cap: Optional[int], perm: Optional[Tensor] = None,
                       pos: Optional[Tensor] = None,
                       etab: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Lane-encode [N, M] symbols / CDF rows over the [T, K] ``grid`` (see
    the module doc): in lane consumption order, or with ``perm`` in the
    order the codec produced them; ``pos`` / ``etab`` are made here when not
    given.  idx may be [1, M] or a broadcast [N, M] view.  Returns (words
    [N, K, T+2], lens [N, K], fix_pos [N, F], fix_val [N, F], n_esc [N]),
    int32, F = ``fix_cap`` (M when None: every escape is kept).  Nothing
    syncs with the host when ``etab`` is given."""
    if pos is None:
        pos = lane_positions(grid, perm)
    if etab is None:
        etab = encode_table(cdf, cdf_len, offset)
    sym = sym.to(torch.int32)
    words, lens, esc = torch.ops.crdr.lane_encode(
        sym, idx.to(torch.int32), grid, pos, etab, cdf_len, offset)
    sym_l = sym if perm is None else sym.index_select(1, perm)
    return (words, lens) + lane_fixups(sym_l, esc, fix_cap)


lane_encode_rounds.launches = 0


@torch.library.custom_op("crdr::lane_encode", mutates_args=(),
                         device_types="cuda")
def _lane_encode_op(sym: Tensor, idx: Tensor, grid: Tensor, pos: Tensor,
                    etab: Tensor, cdf_len: Tensor,
                    offset: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel: one counted launch (``launch_walk``)."""
    out = launch_walk(sym, idx, grid, pos, etab, cdf_len, offset)
    count_launch(lane_encode_rounds)
    return out


@_lane_encode_op.register_kernel("cpu")
def _lane_encode_cpu(sym, idx, grid, pos, etab, cdf_len, offset):
    return lane_encode_walk(sym, idx, grid, pos, etab, cdf_len, offset)


@_lane_encode_op.register_fake
def _lane_encode_fake(sym, idx, grid, pos, etab, cdf_len, offset):
    n, m = sym.shape
    t_steps, k = grid.shape
    return (sym.new_empty((n, k, t_steps + 2)), sym.new_empty((n, k)),
            sym.new_empty((n, m), dtype=torch.bool))
