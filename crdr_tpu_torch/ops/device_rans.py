"""The lane-rans32 decoder of the device wire in plain PyTorch: K2's twin.

Counterpart of the decode half of ``crdr_tpu/ops/device_rans.py``
(``init_lane_state``, ``expand_tables``, ``_decode_step_core``,
``lane_decode_round_instep``, ``apply_fixups``).  It decodes the streams of
``runtime/lane_rans.py``: all K lanes of every image advance one symbol per
step, with the same count-based CDF search and the same masking as JAX.

Tensors: states [N, K] int64 holding uint32 values (torch has no general
uint32 arithmetic: every product and shift is masked with ``& 0xFFFFFFFF``,
which equals uint32 wrap-around), ptrs [N, K] int32, words [N, K, W] int32
holding 16-bit values, idx [N, M >= m] int32, cdf [R, L] int32, cdf_len /
cdf_off [R] int32.  Everything is integer, so the twin, the CUDA kernel
(``ops/lane_decode.py``), JAX and the host C++ lane decoder agree exactly.

The device-wire encoder (``encode_grid``, ``lane_encode_rounds``) is not
ported: the port encodes the device wire on the host.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_U32 = 0xFFFFFFFF


def init_lane_state(words: Tensor) -> Tuple[Tensor, Tensor]:
    """words [..., K, W] (16-bit values) -> (states int64, ptrs int32): each
    lane's state from its first two words, read cursor at 2."""
    w = words.to(torch.int64)
    states = (w[..., 0] << 16) | w[..., 1]
    ptrs = torch.full(words.shape[:-1], 2, dtype=torch.int32,
                      device=words.device)
    return states, ptrs


def expand_tables(idx: Tensor, cdf: Tensor, cdf_len: Tensor, cdf_off: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-symbol table rows: idx [...] in [0, R) -> (rows [..., L],
    lens [...], offs [...]), int32 (a gather: JAX's one-hot matmul computes
    the same integers)."""
    i = idx.to(torch.int64)
    return cdf[i], cdf_len[i], cdf_off[i]


def _pick(rows: Tensor, q: Tensor) -> Tensor:
    """rows[..., q], 0 where q is outside the row (JAX's one-hot select)."""
    big_l = rows.shape[-1]
    got = rows.gather(-1, q.clamp(0, big_l - 1)[..., None])[..., 0]
    return torch.where((q >= 0) & (q < big_l), got.to(torch.int64), 0)


def _decode_step_core(st: Tensor, pt: Tensor, words: Tensor, rows: Tensor,
                      ln: Tensor, off: Tensor, act: Tensor, pos: Tensor,
                      w_max: int) -> Tuple[Tensor, Tensor, Tensor]:
    """One lane advance: CDF search + uint32 state update (int64 tensors)."""
    mod = st & 0xFFFF
    # s = #{q < len-1 : row[q] <= mod} - 1   (row[0] == 0)
    valid = pos < (ln.to(torch.int64) - 1)[..., None]
    s = ((rows <= mod[..., None]) & valid).sum(-1) - 1
    low = _pick(rows, s)
    freq = _pick(rows, s + 1) - low
    value = s + off
    x_new = (freq * (st >> 16) + mod - low) & _U32
    need = x_new < (1 << 16)
    word = words.gather(-1, pt.clamp(max=w_max)[..., None])[..., 0]
    x_ren = torch.where(need, ((x_new << 16) | word) & _U32, x_new)
    st = torch.where(act, x_ren, st)
    pt = torch.where(act & need, pt + 1, pt)
    return st, pt, value


def lane_decode_round_instep(states: Tensor, ptrs: Tensor, words: Tensor,
                             idx: Tensor, cdf: Tensor, cdf_len: Tensor,
                             cdf_off: Tensor, m: int
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """Decode one round of ``m`` symbols per image across K lanes, the table
    rows expanded inside each step (K2's plain twin).

    Symbol p goes to lane p % K at step p // K (the encoder's per-round
    assignment); lanes past the round's end are masked.  Returns
    (vals [N, m] int32, states [N, K] int64, ptrs [N, K] int32)."""
    n, k = states.shape
    dev = states.device
    t_steps = -(-m // k)
    pad = t_steps * k - m
    # pad with row 0 (a valid row): padded lanes are masked inactive
    idx_p = F.pad(idx[:, :m].to(torch.int64), (0, pad))
    idx_t = idx_p.reshape(n, t_steps, k).transpose(0, 1)      # [T, N, K]
    lane = torch.arange(k, device=dev)
    pos = torch.arange(cdf.shape[-1], device=dev)
    words = words.to(torch.int64)
    w_max = words.shape[-1] - 1
    st, pt = states.to(torch.int64), ptrs.to(torch.int64)
    vals = []
    for t in range(t_steps):
        rows, ln, off = expand_tables(idx_t[t], cdf, cdf_len, cdf_off)
        st, pt, value = _decode_step_core(st, pt, words, rows, ln, off,
                                          t * k + lane < m, pos, w_max)
        vals.append(value)
    if vals:
        out = torch.stack(vals, 1).reshape(n, t_steps * k)[:, :m]
    else:
        out = torch.zeros((n, 0), dtype=torch.int64, device=dev)
    return out.to(torch.int32), st, pt.to(torch.int32)


def apply_fixups(vals: Tensor, fix_pos: Tensor, fix_val: Tensor,
                 fix_active: Tensor, lo: Union[int, Tensor], m: int
                 ) -> Tensor:
    """Overlay escape fixups onto one round's decoded values.

    vals [N, m]; fix_pos [N, F] global flat positions; fix_val [N, F];
    fix_active [N, F] bool.  Fixups with position in [lo, lo + m) land at
    (pos - lo); the others are dropped (scattered into a spare slot, so no
    host sync picks them out)."""
    n = vals.shape[0]
    local = fix_pos.to(torch.int64) - lo
    in_round = fix_active & (local >= 0) & (local < m)
    batch = torch.arange(n, device=vals.device)[:, None]
    spare = n * m
    flat_idx = torch.where(in_round, batch * m + local, spare).reshape(-1)
    out = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
    out = out.scatter(0, flat_idx, fix_val.reshape(-1).to(vals.dtype))
    return out[:spare].reshape(n, m)
