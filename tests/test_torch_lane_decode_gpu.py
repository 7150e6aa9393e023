"""K2's CUDA kernel against its plain twin, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_lane_decode_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's and
the lookup emulation's CPU tests are in ``tests/test_torch_lane_decode.py``).
Streams come from the host lane encoder on seeded symbols; the kernel must
equal the twin exactly (values, states, pointers) over two rounds with the
states carried, and be bit-identical across launches.  Shapes: a ragged
small round, the flagship round (batch 4, K 128, m 49,152, the real y
table), a table too large for a block's shared memory (read from global
memory), a high-rate table (lanes renorm on consecutive steps), K of 8, 32,
128 and 1024, m = 0, batch 1 against its image in batch 4, and a launch
captured in a CUDA graph; a table of another lookup width raises.
"""

import numpy as np
import pytest

import torch

from crdr_tpu_torch.entropy import GaussianConditionalCodec, get_scale_table
from crdr_tpu_torch.ops.device_rans import (init_lane_state,
                                            lane_decode_round_instep)
from crdr_tpu_torch.ops.lane_decode import (lane_decode_round, lane_plan,
                                            prepare_lane_table, smem_cap)
from crdr_tpu_torch.runtime import pmf_to_quantized_cdf
from crdr_tpu_torch.runtime.lane_rans import lane_encode


def _random_tables(rng, rows, max_len, full=False):
    """Random CDF rows of 3..max_len entries (all max_len when ``full``)."""
    cdf_len = (np.full(rows, max_len, np.int32) if full else
               rng.integers(3, max_len + 1, rows).astype(np.int32))
    cdfs = np.zeros((rows, max_len), np.int32)
    for r in range(rows):
        pmf = rng.random(int(cdf_len[r]) - 1).astype(np.float32) + 1e-4
        cdfs[r, :cdf_len[r]] = pmf_to_quantized_cdf(pmf / pmf.sum(), 16)
    return cdfs, cdf_len, rng.integers(-6, 6, rows).astype(np.int32)


def _y_tables():
    codec = GaussianConditionalCodec()
    codec.update_scale_table(get_scale_table())
    return codec.quantized_cdf, codec.cdf_length, codec.offset


def _streams(rng, tables, n, rounds, m, k, uniform=False):
    """[n, k, W] words and [n, rounds, m] CDF rows of seeded symbols
    (``uniform``: over the whole row, the most bits a symbol)."""
    cdfs, cdf_len, offsets = tables
    idx = rng.integers(0, cdfs.shape[0], (n, rounds, m)).astype(np.int32)
    if uniform:
        v = offsets[idx] + rng.integers(0, cdf_len[idx] - 1)
    else:
        center = (cdf_len[idx] - 2) // 2
        v = offsets[idx] + np.clip(center + np.round(
            rng.standard_normal(idx.shape) * 3).astype(np.int32), 0,
            cdf_len[idx] - 1)  # the top value is the escape slot's fixup
    encs = [lane_encode(v[i].reshape(-1), idx[i].reshape(-1),
                        np.arange(rounds + 1) * m, k, *tables)
            for i in range(n)]
    words = np.zeros((n, k, max(e[0].shape[1] for e in encs)), np.int32)
    for i, e in enumerate(encs):
        words[i, :, :e[0].shape[1]] = e[0]
    return words, idx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K2 kernel has no CPU mode")
    return torch.device("cuda")


def _round_pair(st, pt, words, idx, table, m):
    """The kernel twice (counted) and the twin on one round."""
    before = lane_decode_round.launches
    got = lane_decode_round(st, pt, words, idx, table, m)
    again = lane_decode_round(st, pt, words, idx, table, m)
    torch.cuda.synchronize()
    assert lane_decode_round.launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = lane_decode_round_instep(st, pt, words, idx, table.cdf,
                                   table.cdf_len, table.cdf_off, m)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    return got


def _two_rounds(cuda, rng, tables, n, m, k, uniform=False):
    """Two rounds with the states carried, each held against the twin;
    returns the table and each round's (inputs, outputs)."""
    words_np, idx_np = _streams(rng, tables, n, 2, m, k, uniform)
    words = torch.from_numpy(words_np).to(cuda)
    table = prepare_lane_table(*tables, device=cuda)
    st, pt = init_lane_state(words)
    rounds = []
    for r in range(2):
        idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, r])).to(cuda)
        out = _round_pair(st, pt, words, idx, table, m)
        rounds.append(((st, pt, words, idx), out))
        st, pt = out[1], out[2]
    return table, rounds


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "flagship", "global_table",
                                  "high_rate"])
def test_kernel_matches_plain_on_gpu(cuda, case):
    rng = np.random.default_rng(7)
    n, m, k, tables = {
        "ragged": (2, 37, 16, _random_tables(rng, 8, 14)),
        "flagship": (4, 32 * 48 * 32, 128, _y_tables()),
        # 64 x 1000 int32 = 256 KB of used entries: over the shared memory
        "global_table": (2, 500, 64, _random_tables(rng, 64, 1000, True)),
        # ~11 bits a symbol: most steps renorm, many on consecutive steps
        "high_rate": (2, 40 * 64 + 9, 64, _random_tables(rng, 8, 2000,
                                                           True)),
    }[case]
    table, rounds = _two_rounds(cuda, rng, tables, n, m, k,
                                uniform=case == "high_rate")
    plan = lane_plan(k, table.buf.numel(), smem_cap(cuda))
    assert plan["in_smem"] == (case != "global_table")
    if case == "high_rate":
        steps = -(-m // k)
        for (st, pt, *_), (_, _, pt2) in rounds:
            assert float((pt2 - pt).double().mean()) > 0.6 * steps


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 32, 128, 1024])
def test_kernel_lane_counts_on_gpu(cuda, k):
    """The flagship y table at K 8..1024, m not a multiple of K (at 1024
    lanes the rings take 64 KB beside the table)."""
    m = 3 * k + 5
    table, _ = _two_rounds(cuda, np.random.default_rng(k), _y_tables(), 2,
                           m, k)
    assert lane_plan(k, table.buf.numel(), smem_cap(cuda)) == {
        "in_smem": True,
        "smem_bytes": 16 + 8 * 8 * max(k, 32) + 4 * table.buf.numel()}


@pytest.mark.gpu
def test_kernel_m0_on_gpu(cuda):
    """m = 0: no symbol, states and pointers unchanged (the prologue
    alone)."""
    rng = np.random.default_rng(11)
    words_np, idx_np = _streams(rng, _y_tables(), 2, 1, 50, 16)
    words = torch.from_numpy(words_np).to(cuda)
    table = prepare_lane_table(*_y_tables(), device=cuda)
    st, pt = init_lane_state(words)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, 0])).to(cuda)
    vals, st2, pt2 = _round_pair(st, pt, words, idx, table, 0)
    assert vals.shape == (2, 0)
    assert torch.equal(st2, st) and torch.equal(pt2, pt)


@pytest.mark.gpu
def test_kernel_batch_invariant_on_gpu(cuda):
    """Each image of a batch-4 round equals its batch-1 round."""
    rng = np.random.default_rng(12)
    m, k = 4000, 128
    words_np, idx_np = _streams(rng, _y_tables(), 4, 1, m, k)
    table = prepare_lane_table(*_y_tables(), device=cuda)
    words = torch.from_numpy(words_np).to(cuda)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, 0])).to(cuda)
    st, pt = init_lane_state(words)
    batch = _round_pair(st, pt, words, idx, table, m)
    for i in range(4):
        one = lane_decode_round(st[i:i + 1], pt[i:i + 1], words[i:i + 1],
                                idx[i:i + 1], table, m)
        for a, b in zip(one, batch):
            assert torch.equal(a[0], b[i])


@pytest.mark.gpu
def test_kernel_in_a_cuda_graph(cuda):
    """A launch captured in a CUDA graph and replayed equals the eager
    launch."""
    rng = np.random.default_rng(13)
    m, k = 4 * 128 * 20 + 3, 128
    words_np, idx_np = _streams(rng, _y_tables(), 4, 1, m, k)
    table = prepare_lane_table(*_y_tables(), device=cuda)
    words = torch.from_numpy(words_np).to(cuda)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, 0])).to(cuda)
    st, pt = init_lane_state(words)
    eager = _round_pair(st, pt, words, idx, table, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        lane_decode_round(st, pt, words, idx, table, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lane_decode_round(st, pt, words, idx, table, m)
    for o in out:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_raises_on_another_lookup_width_on_gpu(cuda):
    """The kernel's lookup width is fixed at build time: a table prepared
    with another width raises, uncounted, and never falls back."""
    rng = np.random.default_rng(14)
    words_np, idx_np = _streams(rng, _y_tables(), 1, 1, 300, 32)
    table = prepare_lane_table(*_y_tables(), bits=9, device=cuda)
    words = torch.from_numpy(words_np).to(cuda)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, 0])).to(cuda)
    st, pt = init_lane_state(words)
    before = lane_decode_round.launches
    with pytest.raises(ValueError, match="lookup"):
        lane_decode_round(st, pt, words, idx, table, 300)
    assert lane_decode_round.launches == before
