"""The lane-rans32 coder of the device wire in plain PyTorch: the twins of
K2 (decode) and E1 (encode).

Counterpart of ``crdr_tpu/ops/device_rans.py`` (``init_lane_state``,
``expand_tables``, ``_decode_step_core``, ``lane_decode_round_instep``,
``apply_fixups``, ``encode_grid``, ``lane_encode_rounds``).  It decodes and
writes the streams of ``runtime/lane_rans.py``: all K lanes of every image
advance one symbol per step, with the same count-based CDF search and the
same masking as JAX.

Tensors: states [N, K] int64 holding uint32 values (torch has no general
uint32 arithmetic: every product and shift is masked with ``& 0xFFFFFFFF``,
which equals uint32 wrap-around), ptrs [N, K] int32, words [N, K, W] int32
holding 16-bit values, idx [N, M >= m] int32, cdf [R, L] int32, cdf_len /
cdf_off [R] int32.  Everything is integer, so the twin, the CUDA kernel
(``ops/lane_decode.py``), JAX and the host C++ lane decoder agree exactly.

Encode (E1's twin, ``lane_encode_rounds``): the slot resolution is a
parallel gather (``lane_encode_operands``), the serial part a reverse walk
over the [T, K] grid of ``encode_grid`` (``lane_encode_scan``); the two are
``lane_encode_walk``, the CPU implementation of E1's op ``crdr::lane_encode``,
which resolves the slots itself from ``lane_positions`` (the grid composed
with the codec's lane permutation) and ``encode_table`` (per CDF row and
slot: low, freq and freq's reciprocal, ``reciprocal48`` / ``divide48``).
The escape fixups (``lane_fixups``) are cumsums and scatters, shared with
the kernel's wrapper ``ops/lane_encode.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
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


# ---------------- encode ---------------------------------------------------

def encode_grid(slice_offsets: Sequence[int], num_lanes: int) -> np.ndarray:
    """The [T, K] int32 grid of flat symbol positions in lane consumption
    order: within each round (``slice_offsets`` boundaries, where the lane
    assignment restarts) symbol ``off_s + r*K + j`` sits at row ``r``, lane
    ``j``; entries past a round's end are -1 (inactive).  The per-lane
    sequence of the host coder's ``lane_rans_encode``."""
    off = np.asarray(slice_offsets, dtype=np.int64)
    k = int(num_lanes)
    rows = [np.zeros((0, k), np.int64)]
    for s in range(off.size - 1):
        m = int(off[s + 1] - off[s])
        t = -(-m // k)
        g = (off[s] + np.arange(t, dtype=np.int64)[:, None] * k
             + np.arange(k, dtype=np.int64)[None, :])
        rows.append(np.where(g < off[s + 1], g, -1))
    return np.concatenate(rows, axis=0).astype(np.int32)


def lane_positions(grid: Tensor, perm: Optional[Tensor] = None) -> Tensor:
    """The [T, K] int32 table of where each grid entry's symbol lies in
    the order the codec produced it: ``perm[grid]`` where the entry is
    active (``grid >= 0``), -1 elsewhere; ``grid`` itself when ``perm`` is
    None.  ``perm`` [M] maps lane order to the produced order
    (``sym_lane = sym.index_select(1, perm)``).  Built once per latent
    shape: E1 then reads each symbol where it lies, with no permuted copy."""
    if perm is None:
        return grid.to(torch.int32)
    at = perm.to(torch.int64)[grid.to(torch.int64).clamp(min=0)]
    return torch.where(grid >= 0, at, -1).to(torch.int32)


def reciprocal48(freq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """E1's reciprocal of each freq in [1, 2^16]: m = ceil(2^48 / freq) as
    (m >> 32, m & 0xFFFFFFFF), int64 arrays (m >> 32 <= 2^16).  Exact
    division by it (``divide48``): for x < 2^32, m = (2^48 + e) / freq with
    0 <= e < freq, so x * m / 2^48 = x / freq + x * e / (freq * 2^48), and
    x * e < 2^48 keeps the excess below 1 / freq: the floor is x // freq."""
    f = np.asarray(freq, np.int64)
    m = ((1 << 48) + f - 1) // f
    return m >> 32, m & 0xFFFFFFFF


def divide48(x: np.ndarray, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """x // freq as E1 computes it from ``reciprocal48``'s halves:
    (x * hi + ((x * lo) >> 32)) >> 16 (the kernel's 64-bit integer ops;
    every product fits in 64 bits), uint64 arrays."""
    x = np.asarray(x, np.uint64)
    hi, lo = np.asarray(hi, np.uint64), np.asarray(lo, np.uint64)
    return (x * hi + ((x * lo) >> np.uint64(32))) >> np.uint64(16)


def encode_table(cdf, cdf_len, offset) -> Tensor:
    """E1's per-(row, slot) table [R, L, 4] int32 of a dense CDF table
    (``cdf`` [R, L], arrays or tensors; on ``cdf``'s device): low =
    cdf[r, s], freq = cdf[r, s + 1] - cdf[r, s] (0 past the row's end), and
    freq's ``reciprocal48`` (its low 32 bits as int32, then its high bits),
    0 where freq < 1.  Built once per table at ``codec_setup``.  The kernel
    reads one 16-byte entry a symbol; ``lane_encode_walk`` reads its low
    column as ``cdf``."""
    device = cdf.device if torch.is_tensor(cdf) else "cpu"
    c = (cdf.detach().cpu().numpy() if torch.is_tensor(cdf)
         else np.asarray(cdf)).astype(np.int64)
    rows, big_l = c.shape
    freq = np.zeros_like(c)
    freq[:, :-1] = np.diff(c, axis=1)
    valid = (freq >= 1) & (freq <= 1 << 16)
    hi, lo = reciprocal48(np.where(valid, freq, 1))
    tab = np.stack([c, np.where(valid, freq, 0), np.where(valid, lo, 0),
                    np.where(valid, hi, 0)], -1)
    return torch.from_numpy(tab.astype(np.uint32).view(np.int32)
                            .reshape(rows, big_l, 4)).to(device)


def lane_encode_operands(sym: Tensor, idx: Tensor, grid: Tensor, cdf: Tensor,
                         cdf_len: Tensor, offset: Tensor
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """The parallel half of the encoder: each symbol's slot (its value
    folded into its row, or the escape slot), its ``low`` and ``freq``, laid
    onto the grid.  sym / idx [N, M] (any int dtype), grid [T, K] int32,
    tables int32.  Returns (low [N, T, K] int32, freq [N, T, K] int32, 0 at
    an inactive entry, esc [N, M] bool)."""
    n, m = sym.shape
    t_steps, k = grid.shape
    i = idx.to(torch.int64)
    sym = sym.to(torch.int64)
    maxv = cdf_len[i].to(torch.int64) - 2
    folded = sym - offset[i].to(torch.int64)
    esc = (folded < 0) | (folded >= maxv)
    flat = i * cdf.shape[1] + torch.where(esc, maxv, folded)
    cdf_flat = cdf.reshape(-1)
    low = cdf_flat[flat]
    freq = cdf_flat[flat + 1] - low
    gpos = grid.to(torch.int64).clamp(min=0).reshape(-1)
    act = (grid >= 0).reshape(1, t_steps, k)
    low_g = low[:, gpos].reshape(n, t_steps, k)
    freq_g = torch.where(act, freq[:, gpos].reshape(n, t_steps, k), 0)
    return (low_g.to(torch.int32).contiguous(),
            freq_g.to(torch.int32).contiguous(), esc)


def _row_cumsum(v: Tensor, piece: int = 1024) -> Tensor:
    """Inclusive int32 cumsum along dim 1 of [N, M] (few rows, M long) as
    two short scans: within pieces of ``piece`` (many rows at once), then
    over the pieces' totals.  The same integers as ``torch.cumsum``; a
    single scan of a few long rows runs one block a row on the card."""
    n, m = v.shape
    w = F.pad(v, (0, -m % piece)).view(n, -1, piece)
    inner = torch.cumsum(w, 2, dtype=torch.int32)
    tot = inner[:, :, -1]
    before = torch.cumsum(tot, 1, dtype=torch.int32) - tot
    return (inner + before[:, :, None]).view(n, -1)[:, :m]


def lane_fixups(sym: Tensor, esc: Tensor, fix_cap: Optional[int]
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Escape fixups in forward flat order: (fix_pos [N, F] int32, fix_val
    [N, F] int32, n_esc [N] int32) with F = ``fix_cap``; escapes past the
    cap are counted in ``n_esc`` but not stored, and unused slots are 0.
    ``fix_cap=None`` keeps every escape (F = M)."""
    n, m = sym.shape
    dev = sym.device
    if fix_cap is None:
        fix_cap = m
    esc_i = esc.to(torch.int32)
    fcum = _row_cumsum(esc_i)
    n_esc = fcum[:, -1] if m else torch.zeros(n, dtype=torch.int32,
                                              device=dev)
    fpos = (fcum - esc_i).to(torch.int64)
    # escapes past the cap, and the symbols that are none, go to a spare
    # region, one slot each (no two writes to one address)
    pos = torch.arange(m, device=dev).expand(n, m)
    slot = torch.where(esc & (fpos < fix_cap), fpos, fix_cap + pos)
    fix_pos = torch.zeros((n, fix_cap + m), dtype=torch.int32, device=dev)
    fix_val = torch.zeros_like(fix_pos)
    fix_pos.scatter_(1, slot, pos.to(torch.int32))
    fix_val.scatter_(1, slot, sym.to(torch.int32))
    return (fix_pos[:, :fix_cap].contiguous(),
            fix_val[:, :fix_cap].contiguous(), n_esc.to(torch.int32))


def lane_encode_scan(low_g: Tensor, freq_g: Tensor) -> Tuple[Tensor, Tensor]:
    """The serial half in plain PyTorch (E1's twin): every lane walks its
    grid column last row first from the state 2^16.  A step with
    ``(x >> 16) >= freq`` first emits ``x & 0xFFFF`` and shifts x down by 16
    (at most one word a symbol); then ``q = x // freq``, ``x = (q << 16) +
    (x - q*freq) + low``, in uint32 (int64 carriers; an inactive entry,
    freq 0, leaves x as it was).  The word of row t lands at ``2 + #emissions
    at rows < t`` and the final state in words 0 (high half) and 1.
    Returns (words [N, K, T+2] int32 holding 16-bit values, zero past each
    lane's length; lens [N, K] int32)."""
    n, t_steps, k = low_g.shape
    dev = low_g.device
    x = torch.full((n, k), 1 << 16, dtype=torch.int64, device=dev)
    words_t, emit_t = [], []
    for t in range(t_steps - 1, -1, -1):
        act = freq_g[:, t] > 0
        fq = torch.where(act, freq_g[:, t].to(torch.int64), 1)
        emit = act & ((x >> 16) >= fq)
        words_t.append(x & 0xFFFF)
        emit_t.append(emit)
        x1 = torch.where(emit, x >> 16, x)
        q = x1 // fq
        x2 = ((q << 16) + (x1 - q * fq) + low_g[:, t].to(torch.int64)) & _U32
        x = torch.where(act, x2, x1)
    cap = t_steps + 2
    words = torch.zeros((n, k, cap + 1), dtype=torch.int64, device=dev)
    if t_steps:
        emit = torch.stack(emit_t[::-1], 2).to(torch.int64)  # [N, K, T]
        ecum = torch.cumsum(emit, 2)
        pos = torch.where(emit > 0, 2 + ecum - emit, cap)  # cap: spare
        words.scatter_(2, pos, torch.stack(words_t[::-1], 2))
        lens = 2 + ecum[:, :, -1]
    else:
        lens = torch.full((n, k), 2, dtype=torch.int64, device=dev)
    words = words[:, :, :cap]
    words[:, :, 0] = x >> 16
    words[:, :, 1] = x & 0xFFFF
    return words.to(torch.int32), lens.to(torch.int32)


def lane_encode_walk(sym: Tensor, idx: Tensor, grid: Tensor, pos: Tensor,
                     etab: Tensor, cdf_len: Tensor, offset: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """E1's op (``crdr::lane_encode``) in plain PyTorch, its CPU
    implementation: grid entry (t, k) encodes the symbol at ``pos[t, k]`` of
    sym / idx [N, M] (int32; ``lane_positions``), whose lane-order index is
    ``grid[t, k]``; the slots are resolved from ``etab``'s low column (the
    dense ``cdf``, ``encode_table``) by ``lane_encode_operands``, then
    walked by ``lane_encode_scan``.  Returns (words [N, K, T+2] int32, lens
    [N, K] int32, esc [N, M] bool in lane order)."""
    n, m = sym.shape
    act = grid.reshape(-1) >= 0
    at = grid.reshape(-1)[act].to(torch.int64)
    src = pos.reshape(-1)[act].to(torch.int64)

    def lane_order(v):
        out = torch.zeros((n, m), dtype=torch.int32, device=v.device)
        out[:, at] = v[:, src].to(torch.int32)
        return out

    low_g, freq_g, esc = lane_encode_operands(
        lane_order(sym), lane_order(idx.expand(n, -1)), grid, etab[..., 0],
        cdf_len, offset)
    return lane_encode_scan(low_g, freq_g) + (esc,)


def lane_encode_rounds(sym: Tensor, idx: Tensor, grid: Tensor, cdf: Tensor,
                       cdf_len: Tensor, offset: Tensor,
                       fix_cap: Optional[int], perm: Optional[Tensor] = None
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The device-wire lane encoder in plain PyTorch, the inverse of
    ``lane_decode_round_instep``; its streams equal the host coder's
    (``runtime/lane_rans.lane_encode``) byte for byte.

    sym / idx [N, M] in lane consumption order, or, with ``perm`` [M] (lane
    order -> the order given, ``lane_positions``), in the order given;
    grid [T, K] int32 from ``encode_grid`` (on the tensors' device), cdf
    [R, L] / cdf_len [R] / offset [R] int32.  Returns (words [N, K, T+2]
    int32 of 16-bit values, lens [N, K] int32, fix_pos [N, F] int32,
    fix_val [N, F] int32, n_esc [N] int32), F = ``fix_cap`` (M when None:
    every escape is kept): ``words[n, k, :lens[n, k]]`` is lane k's stream
    (2 state words, then the renorm words)."""
    if perm is not None:
        sym, idx = sym.index_select(1, perm), idx.index_select(1, perm)
    low_g, freq_g, esc = lane_encode_operands(sym, idx, grid, cdf, cdf_len,
                                              offset)
    words, lens = lane_encode_scan(low_g, freq_g)
    return (words, lens) + lane_fixups(sym, esc, fix_cap)
