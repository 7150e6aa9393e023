"""K2's CUDA kernel against its plain twin, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_lane_decode_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's CPU
tests are in ``tests/test_torch_lane_decode.py``).  Streams come from the
host lane encoder on seeded symbols; the kernel must equal the twin exactly
(values, states, pointers) over two rounds with the states carried, and be
bit-identical across launches.  Shapes: a ragged small round, the flagship
round (batch 4, K 128, m 49,152, the real y table) and a table too large for
a block's shared memory (read from global memory).
"""

import numpy as np
import pytest

import torch

from crdr_tpu_torch.entropy import GaussianConditionalCodec, get_scale_table
from crdr_tpu_torch.ops.device_rans import (init_lane_state,
                                            lane_decode_round_instep)
from crdr_tpu_torch.ops.lane_decode import lane_decode_round
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


def _streams(rng, tables, n, rounds, m, k):
    """[n, k, W] words and [n, rounds, m] CDF rows of seeded symbols."""
    cdfs, cdf_len, offsets = tables
    idx = rng.integers(0, cdfs.shape[0], (n, rounds, m)).astype(np.int32)
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "flagship", "global_table"])
def test_kernel_matches_plain_on_gpu(cuda, case):
    rng = np.random.default_rng(7)
    n, m, k, tables = {
        "ragged": (2, 37, 16, _random_tables(rng, 8, 14)),
        "flagship": (4, 32 * 48 * 32, 128, _y_tables()),
        # 64 x 1000 int32 = 256 KB of used entries: over the shared memory
        "global_table": (2, 500, 64, _random_tables(rng, 64, 1000, True)),
    }[case]
    words_np, idx_np = _streams(rng, tables, n, 2, m, k)
    words = torch.from_numpy(words_np).to(cuda)
    tabs = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in tables]
    st, pt = init_lane_state(words)
    pst, ppt = st, pt
    for r in range(2):
        idx = torch.from_numpy(np.ascontiguousarray(idx_np[:, r])).to(cuda)
        before = lane_decode_round.launches
        vals, st2, pt2 = lane_decode_round(st, pt, words, idx, *tabs, m)
        again = lane_decode_round(st, pt, words, idx, *tabs, m)
        torch.cuda.synchronize()
        assert lane_decode_round.launches == before + 2
        for a, b in zip((vals, st2, pt2), again):
            assert torch.equal(a, b)
        pv, pst, ppt = lane_decode_round_instep(pst, ppt, words, idx, *tabs,
                                                m)
        assert torch.equal(vals, pv)
        assert torch.equal(st2, pst) and torch.equal(pt2, ppt)
        st, pt = st2, pt2
