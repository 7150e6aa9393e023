"""K2: one lane-rans32 decode round — CUDA kernel wrapper, its kernel-ready
table, its plan and launch count.

Replaces the Pallas TPU kernel ``crdr_tpu/ops/pallas_lane_decode.py::
pallas_lane_decode_round``.  ``lane_decode_round`` takes the arguments of the
plain twin ``ops/device_rans.lane_decode_round_instep``, with the CDF table
as one ``LaneTable``, and returns the same values, ``(vals [N, m] int32,
states [N, K] int64, ptrs [N, K] int32)``; the states and ptrs carry from
one round to the next.

* ``prepare_lane_table(cdf, cdf_len, cdf_off)`` builds the ``LaneTable``
  once, on the host (the codec does it at ``codec_setup``): the dense
  tables the twin reads and the kernel-ready buffer, one contiguous int32
  buffer of per-row headers, a per-row coarse lookup over the 16-bit slot
  and the used CDF entries packed by rows (layout in ``LaneTable``).
* ``lane_plan`` picks, from the shapes and the card's shared-memory limit
  alone, whether the table goes to shared memory or stays in global
  memory.
* ``lane_decode_round`` runs the registered op ``crdr::lane_decode_round``
  (one node of an exported program).  On a CUDA tensor its CUDA
  implementation launches ``csrc/lane_decode.cu`` (built with nvcc for
  sm_90a into ``build/crdr_tpu_torch/`` at first use, loaded with ctypes)
  or raises, on a shape the kernel does not take or a failed launch; it
  never falls back to the twin, and no size or setting gates it.
* On a CPU tensor the op's CPU implementation runs the twin on the dense
  tables.
* ``lane_decode_round.launches`` counts kernel launches.

The source note in the .cu file states the bound and the design.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import (build_library, count_launch, nvcc_command,
                            package_path)
from .device_rans import encode_table, lane_decode_round_instep

Tensor = torch.Tensor

_SRC = package_path("csrc", "lane_decode.cu")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_MAX_LANES = 1024  # one thread per lane, one block per image
LOOKUP_BITS = 8    # 256 buckets of 256 slots a row (the .cu's kLookupBits)
RING = 8           # steps of words and rows a lane stages (the .cu's kRing)
_smem_cap: dict = {}  # {device index: bytes a block may opt in to}


class LaneTable(NamedTuple):
    """A codec's CDF table in the forms the lane coder's paths read
    (``prepare_lane_table``): the dense int32 tensors the twins take
    (``cdf`` [R, L], ``cdf_len`` / ``cdf_off`` [R]), K2's kernel-ready
    buffer and E1's per-slot table ``etab`` (``device_rans.encode_table``).

    ``buf`` int32 [n_ints] (n_ints a multiple of 4), in int32 units:
    ``[R][4]`` headers (start of the row's entries in ``buf``, len, offset,
    0); the lookup, ``[R][2^bits + 1]`` u16 packed two to an int32, entry u
    of a row = #{q < len-1 : cdf[q] <= u * 2^(16-bits)}, the last len - 1
    (a count, so a row of length < 2 fits too); then each row's
    max(len, 1) entries cdf[r, :len]; zero padding to 16 bytes.  The
    kernel takes ``bits`` = LOOKUP_BITS only; the plain emulation
    (``lane_decode_round_lookup``) takes any."""
    cdf: Tensor
    cdf_len: Tensor
    cdf_off: Tensor
    buf: Tensor
    bits: int
    etab: Tensor

    @property
    def rows(self) -> int:
        return self.cdf.shape[0]


def prepare_lane_table(cdf, cdf_len, cdf_off, bits: int = LOOKUP_BITS,
                       device=None) -> LaneTable:
    """The ``LaneTable`` of dense CDF tables (``cdf`` [R, L], ``cdf_len`` /
    ``cdf_off`` [R]; arrays or tensors).  Runs on the host, once per table;
    the tensors go to ``device`` (default: the device of ``cdf`` when it is
    a tensor, else the CPU).  Raises on a row that is not non-decreasing
    over its ``len`` entries, ``len`` outside [0, L] or over 65,536 (the
    lookup holds u16 counts), or ``bits`` outside [0, 16]."""
    if device is None:
        device = cdf.device if torch.is_tensor(cdf) else "cpu"

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    cdf = host(cdf).astype(np.int64)
    ln = host(cdf_len).astype(np.int64).reshape(-1)
    off = host(cdf_off).astype(np.int64).reshape(-1)
    if cdf.ndim != 2 or cdf.shape[1] < 1 or ln.shape != (cdf.shape[0],) \
            or off.shape != ln.shape:
        raise ValueError("prepare_lane_table: cdf [R, L >= 1], cdf_len and "
                         "cdf_off [R] expected")
    if not 0 <= bits <= 16:
        raise ValueError(f"prepare_lane_table: bits {bits} not in [0, 16]")
    rows, big_l = cdf.shape
    if (ln < 0).any() or (ln > min(big_l, 1 << 16)).any():
        raise ValueError(f"prepare_lane_table: cdf_len outside [0, "
                         f"{min(big_l, 1 << 16)}]")
    nb = 1 << bits
    lk = np.empty((rows, nb + 1), np.int64)
    slots = np.arange(nb, dtype=np.int64) << (16 - bits)
    for r in range(rows):
        e = cdf[r, :ln[r]]
        if (np.diff(e) < 0).any():
            raise ValueError(f"prepare_lane_table: row {r} decreases")
        lk[r, :nb] = np.searchsorted(e[:max(ln[r] - 1, 0)], slots,
                                     side="right")
        lk[r, nb] = max(ln[r] - 1, 0)
    lk_ints = -(-(rows * (nb + 1)) // 2)
    head = 4 * rows + -(-lk_ints // 4) * 4
    n_ent = np.maximum(ln, 1)
    starts = head + np.concatenate([[0], np.cumsum(n_ent)[:-1]])
    total = -(-(head + int(n_ent.sum())) // 4) * 4
    buf = np.zeros(total, np.int32)
    hdr = np.stack([starts, ln, off, np.zeros_like(ln)], 1)
    buf[:4 * rows] = hdr.reshape(-1)
    lk16 = np.zeros(2 * lk_ints, np.uint16)
    lk16[:lk.size] = lk.reshape(-1)
    buf[4 * rows:4 * rows + lk_ints] = lk16.view(np.int32)
    for r in range(rows):
        buf[starts[r]:starts[r] + n_ent[r]] = cdf[r, :n_ent[r]]
    dense = (np.ascontiguousarray(cdf, np.int32), ln.astype(np.int32),
             off.astype(np.int32), buf)
    return LaneTable(*(torch.from_numpy(a).to(device) for a in dense), bits,
                     encode_table(cdf, ln, off).to(device))


def lane_plan(k: int, table_ints: int, smem_cap: int) -> dict:
    """The kernel's instantiation for ``k`` lanes and a table of
    ``table_ints`` int32 on a card whose blocks may take ``smem_cap`` bytes
    of shared memory: the table in shared memory when it fits beside the
    rings (mbarrier, then two rings of RING x K int32), else in global
    memory (L2).  Returns {"in_smem": bool, "smem_bytes": bytes a
    block}."""
    rings = 16 + 8 * RING * (-(-max(k, 1) // 32) * 32)
    for in_smem in (True, False):
        smem = rings + (4 * table_ints if in_smem else 0)
        if smem <= smem_cap:
            return {"in_smem": in_smem, "smem_bytes": smem}
    raise ValueError(f"lane_plan: {k} lanes do not fit a block's shared "
                     f"memory ({smem_cap} B)")


def smem_cap(device: torch.device) -> int:
    """The shared memory a block may opt in to on ``device`` (227 KB on an
    H100), read once per device."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _smem_cap:
        _smem_cap[i] = int(torch.cuda.get_device_properties(i)
                           .shared_memory_per_block_optin)
    return _smem_cap[i]


def lane_decode_round_lookup(states: Tensor, ptrs: Tensor, words: Tensor,
                             idx: Tensor, table: LaneTable, m: int,
                             levels: bool = False):
    """The kernel's algorithm in plain PyTorch, reading only ``table.buf``:
    per step and lane the row header, the bucket's bounds from the lookup,
    the binary search inside the bucket, low and freq, the update and the
    renorm, with the twin's masking.  It returns what the twin returns (the
    CPU tests hold it to the twin); with ``levels`` also the search levels
    each symbol took, [N, m] int32 (a warp waits for its deepest lane:
    ``chip_smoke.py`` counts the chain's dependent loads from them)."""
    n, k = states.shape
    dev = states.device
    buf = table.buf.to(torch.int64)
    rows, bits = table.rows, table.bits
    nb = 1 << bits
    hdr = buf[:4 * rows].reshape(rows, 4)
    lk32 = buf[4 * rows:4 * rows + -(-(rows * (nb + 1)) // 2)]
    lk = torch.stack([lk32 & 0xFFFF, (lk32 >> 16) & 0xFFFF], 1).reshape(-1)
    t_steps = -(-m // k)
    idx_p = torch.nn.functional.pad(idx[:, :m].to(torch.int64),
                                    (0, t_steps * k - m))
    idx_t = idx_p.reshape(n, t_steps, k)
    lane = torch.arange(k, device=dev)
    words = words.to(torch.int64)
    w_max = words.shape[-1] - 1
    x, pt = states.to(torch.int64), ptrs.to(torch.int64)
    vals, lvls = [], []
    for t in range(t_steps):
        act = t * k + lane < m
        r = idx_t[:, t]
        start, off = hdr[r, 0], hdr[r, 2]
        mod = x & 0xFFFF
        u = r * (nb + 1) + (mod >> (16 - bits))
        lo, hi = lk[u], lk[u + 1]
        lv = torch.zeros_like(lo)
        while bool((lo < hi).any()):
            live = lo < hi
            mid = (lo + hi) >> 1
            go = buf[torch.where(live, start + mid, 0)] <= mod
            lo = torch.where(live & go, mid + 1, lo)
            hi = torch.where(live & ~go, mid, hi)
            lv = lv + live.to(torch.int64)
        low = torch.where(lo > 0, buf[(start + lo - 1).clamp(min=0)], 0)
        freq = buf[start + lo] - low
        x_new = (freq * (x >> 16) + mod - low) & 0xFFFFFFFF
        need = x_new < (1 << 16)
        word = words.gather(-1, pt.clamp(max=w_max)[..., None])[..., 0]
        x_ren = torch.where(need, ((x_new << 16) | word) & 0xFFFFFFFF, x_new)
        x = torch.where(act, x_ren, x)
        pt = torch.where(act & need, pt + 1, pt)
        vals.append(lo - 1 + off)
        lvls.append(lv)
    if t_steps:
        out = torch.stack(vals, 1).reshape(n, -1)[:, :m].to(torch.int32)
        lv_out = torch.stack(lvls, 1).reshape(n, -1)[:, :m].to(torch.int32)
    else:
        out = lv_out = torch.zeros((n, 0), dtype=torch.int32, device=dev)
    res = (out, x, pt.to(torch.int32))
    return res + (lv_out,) if levels else res


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
                    p, p, p, i, i, i, p, i, i, p, i, i, i, p, p, p, p]
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
                      idx: Tensor, table: LaneTable, m: int
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Decode one round of ``m`` symbols per image (see the module doc).

    states [N, K] int64 (uint32 values), ptrs [N, K] int32, words [N, K, W]
    int32 (16-bit values), idx [N, M >= m] int32 (CDF rows in [0, R)),
    ``table`` the ``prepare_lane_table`` of the codec's CDF table, on the
    same device.  The twin reads its dense tensors, the kernel only its
    buffer.  Nothing is built or copied per call, and nothing syncs with the
    host.  Runs the op ``crdr::lane_decode_round``, the table passed as its
    tensors and lookup width."""
    return torch.ops.crdr.lane_decode_round(
        states, ptrs, words, idx, table.cdf, table.cdf_len, table.cdf_off,
        table.buf, table.bits, m)


lane_decode_round.launches = 0


@torch.library.custom_op("crdr::lane_decode_round", mutates_args=(),
                         device_types="cuda")
def _lane_decode_round_op(states: Tensor, ptrs: Tensor, words: Tensor,
                          idx: Tensor, cdf: Tensor, cdf_len: Tensor,
                          cdf_off: Tensor, buf: Tensor, bits: int,
                          m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel: one counted launch (``launch_round``); it writes fresh
    outputs and mutates none of its arguments."""
    out = launch_round(states, ptrs, words, idx,  # K2 reads no etab
                       LaneTable(cdf, cdf_len, cdf_off, buf, bits, None), m)
    count_launch(lane_decode_round)
    return out


@_lane_decode_round_op.register_kernel("cpu")
def _lane_decode_round_cpu(states, ptrs, words, idx, cdf, cdf_len, cdf_off,
                           buf, bits, m):
    vals, st, pt = lane_decode_round_instep(states, ptrs, words, idx, cdf,
                                            cdf_len, cdf_off, m)
    # with no step (m = 0) the twin hands its inputs back: an op's outputs
    # may not alias them
    return (vals, st.clone() if st is states else st,
            pt.clone() if pt is ptrs else pt)


@_lane_decode_round_op.register_fake
def _lane_decode_round_fake(states, ptrs, words, idx, cdf, cdf_len, cdf_off,
                            buf, bits, m):
    return (idx.new_empty((states.shape[0], m), dtype=torch.int32),
            torch.empty_like(states), torch.empty_like(ptrs))


def launch_round(states: Tensor, ptrs: Tensor, words: Tensor, idx: Tensor,
                 table: LaneTable, m: int, plan: Optional[dict] = None
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch of the kernel on CUDA tensors, with ``lane_decode_round``'s
    arguments and checks, and not counted: ``plan`` (default ``lane_plan``'s
    for these shapes on this card) picks the instantiation.  Raises on a
    shape the kernel does not take or a failed launch."""
    if states.device.type != "cuda":
        raise ValueError(f"lane_decode_round: unsupported device "
                         f"{states.device}")
    dev = states.device
    n, k = states.shape
    if words.dim() != 3 or idx.dim() != 2:
        raise ValueError("lane_decode_round: words [N, K, W] and idx [N, M] "
                         "expected")
    w = words.shape[2]
    if not 0 < k <= _MAX_LANES or w < 1 or not 0 <= m <= idx.shape[1]:
        raise ValueError(f"lane_decode_round: K {k} (1..{_MAX_LANES}), W {w} "
                         f"(>= 1), m {m} (0..{idx.shape[1]}) out of range")
    if table.bits != LOOKUP_BITS:
        raise ValueError(f"lane_decode_round: the kernel reads a "
                         f"{LOOKUP_BITS}-bit lookup, table has {table.bits}")
    _expect(states, "states", torch.int64, (n, k), dev)
    _expect(ptrs, "ptrs", torch.int32, (n, k), dev)
    _expect(words, "words", torch.int32, (n, k, w), dev)
    _expect(idx, "idx", torch.int32, (n, idx.shape[1]), dev)
    buf = table.buf
    _expect(buf, "table.buf", torch.int32, (buf.numel(),), dev)
    if plan is None:
        plan = lane_plan(k, buf.numel(), smem_cap(dev))
    vals = torch.empty((n, m), dtype=torch.int32, device=dev)
    st_out = torch.empty_like(states)
    pt_out = torch.empty_like(ptrs)
    with torch.cuda.device(dev):
        rc = _get_lib().crdr_lane_decode_round(
            states.data_ptr(), ptrs.data_ptr(), words.data_ptr(), n, k, w,
            idx.data_ptr(), idx.shape[1], m, buf.data_ptr(), buf.numel(),
            table.rows, int(plan["in_smem"]), vals.data_ptr(),
            st_out.data_ptr(), pt_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane_decode_round: kernel launch failed "
                           f"(cudaError {rc})")
    return vals, st_out, pt_out
