"""E1's CUDA kernel (the device wire's lane encoder) against its plain twin
and the host C++ lane coder, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_lane_encode_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's CPU
tests are in ``tests/test_torch_lane_encode.py``).  Shapes: the flagship's
device-wire y (batch 4, 10 rounds of 49,152 symbols, K 128, T 3,840, the
real y table, escapes included) and z (one round of 18,432, the channel as
CDF row, K 128); a ragged small case and K = 1; m = 0.  Each case runs
twice: with the symbols in lane order, and in a produced order (a seeded
permutation, read through ``lane_positions`` as the codec reads y).  The
wrapper's words, lengths and fixups (E1's op ``crdr::lane_encode``, then
the fixups) must equal the twin's element for element, the op's escape
flags the twin's operands', each image's container the host coder's byte
for byte, and two launches must be bit-identical.
"""

import numpy as np
import pytest

import torch

from crdr_tpu_torch.entropy import GaussianConditionalCodec, get_scale_table
from crdr_tpu_torch.ops.device_rans import (encode_grid, encode_table,
                                            lane_encode_operands,
                                            lane_encode_rounds as twin_rounds,
                                            lane_positions)
from crdr_tpu_torch.ops.lane_encode import launch_walk, lane_encode_rounds
from crdr_tpu_torch.runtime import pmf_to_quantized_cdf
from crdr_tpu_torch.runtime.lane_rans import lane_encode, pack_lane_container


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the E1 kernel has no CPU mode")
    return torch.device("cuda")


def _y_tables():
    codec = GaussianConditionalCodec()
    codec.update_scale_table(get_scale_table())
    return codec.quantized_cdf, codec.cdf_length, codec.offset


def _symbols(rng, tables, idx, escape_share=1e-3):
    """Symbols of the CDF rows ``idx`` around each row's centre, inside the
    row, and a share of escapes (past the row's end)."""
    _, cdf_len, offsets = tables
    maxv = cdf_len[idx] - 2
    folded = np.clip(maxv // 2 + np.round(rng.standard_normal(idx.shape) * 2)
                     .astype(np.int32), 0, maxv - 1)
    esc = rng.random(idx.shape) < escape_share
    return (offsets[idx] + np.where(esc, maxv + 100, folded)) \
        .astype(np.int32)


def _rows(rng, tables, n, m):
    return rng.integers(0, tables[0].shape[0], (n, m)).astype(np.int32)


def _check(dev, v, idx, off, k, tables, fix_cap=4096):
    cdfs, cdf_len, offsets = (torch.from_numpy(np.ascontiguousarray(a))
                              .to(dev) for a in tables)
    grid = torch.from_numpy(encode_grid(off, k)).to(dev)
    sym, rows = torch.from_numpy(v).to(dev), torch.from_numpy(idx).to(dev)
    etab = encode_table(cdfs, cdf_len, offsets)
    twin = twin_rounds(sym, rows, grid, cdfs, cdf_len, offsets, fix_cap)
    _, _, esc = lane_encode_operands(sym, rows, grid, cdfs, cdf_len, offsets)
    perm = torch.from_numpy(np.random.default_rng(v.shape[1]).permutation(
        v.shape[1])).to(dev)
    inv = torch.argsort(perm)
    orders = {"lane": (sym, rows, None, grid),  # lane = produced[:, perm]
              "produced": (sym[:, inv], rows[:, inv], perm,
                           lane_positions(grid, perm))}
    for name, (s, r, p, pos) in orders.items():
        before = lane_encode_rounds.launches
        out = lane_encode_rounds(s, r, grid, cdfs, cdf_len, offsets, fix_cap,
                                 p, pos, etab)
        again = lane_encode_rounds(s, r, grid, cdfs, cdf_len, offsets,
                                   fix_cap, p, pos, etab)
        torch.cuda.synchronize()
        assert lane_encode_rounds.launches == before + 2, name
        for a, b, c in zip(out, again, twin):
            assert torch.equal(a, b) and torch.equal(a, c), name
        flags = launch_walk(s, r, grid, pos, etab, cdf_len, offsets)[2]
        assert torch.equal(flags, esc), name
    words, lens, fp, fv, ne = (a.cpu().numpy() for a in out)
    for b in range(v.shape[0]):
        host = lane_encode(v[b], idx[b], off, k, *tables,
                           fix_cap=fix_cap or 4096)
        f = int(ne[b])
        assert f == host[2].size and (fix_cap is None or f <= fix_cap)
        assert pack_lane_container(
            words[b].astype(np.uint16), lens[b], fp[b, :f].astype(np.int64),
            fv[b, :f]) == pack_lane_container(*host)
    return out


@pytest.mark.gpu
def test_flagship_y_and_z(cuda):
    rng = np.random.default_rng(0)
    tables = _y_tables()
    m = 32 * 48 * 32  # a 512x768 image's y slice
    idx = _rows(rng, tables, 4, 10 * m)
    v = _symbols(rng, tables, idx)
    off = np.arange(11, dtype=np.int64) * m
    out = _check(cuda, v, idx, off, 128, tables, fix_cap=None)  # the codec's
    assert out[0].shape == (4, 128, 3842) and int(out[4].min()) > 0
    assert out[2].shape == (4, 10 * m)
    # z: one round over [8, 12, 192] with the channel as CDF row
    zm = 8 * 12 * 192
    zidx = np.broadcast_to(np.arange(zm, dtype=np.int32) % 192,
                           (4, zm)).copy()
    zlen = rng.integers(3, 40, 192).astype(np.int32)
    cdfs = np.zeros((192, 40), np.int32)
    for r in range(192):
        pmf = rng.random(int(zlen[r]) - 1).astype(np.float32) + 1e-4
        cdfs[r, :zlen[r]] = pmf_to_quantized_cdf(pmf / pmf.sum(), 16)
    ztables = (cdfs, zlen, rng.integers(-8, 0, 192).astype(np.int32))
    zv = _symbols(rng, ztables, zidx)
    _check(cuda, zv, zidx, np.asarray([0, zm], np.int64), 128, ztables)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,rounds", [(8, 37, 3), (1, 50, 2), (64, 0, 1)])
def test_small_shapes(cuda, k, m, rounds):
    rng = np.random.default_rng(k + m)
    tables = _y_tables()
    idx = _rows(rng, tables, 2, rounds * m)
    v = _symbols(rng, tables, idx, escape_share=0.05)
    _check(cuda, v, idx, np.arange(rounds + 1, dtype=np.int64) * m, k,
           tables)


@pytest.mark.gpu
def test_a_flipped_symbol_changes_the_words(cuda):
    rng = np.random.default_rng(3)
    tables = _y_tables()
    idx = _rows(rng, tables, 1, 4096)
    v = _symbols(rng, tables, idx, escape_share=0.0)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in tables]
    grid = torch.from_numpy(encode_grid([0, 4096], 32)).to(cuda)
    etab = encode_table(*t)
    rows = torch.from_numpy(idx).to(cuda)
    base = launch_walk(torch.from_numpy(v).to(cuda), rows, grid, grid, etab,
                       *t[1:])
    w = v.copy()
    w[0, 1000] += 1
    moved = launch_walk(torch.from_numpy(w).to(cuda), rows, grid, grid, etab,
                        *t[1:])
    assert not torch.equal(base[0], moved[0])
