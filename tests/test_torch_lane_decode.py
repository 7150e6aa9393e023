"""The device wire's lane coder and K2's plain twin against the JAX package.

* the port's ``runtime/lane_rans.py`` writes the bytes of JAX's host lane
  coder and containers;
* ``ops/device_rans.lane_decode_round_instep`` (K2's twin) equals JAX's
  ``lane_decode_round_instep``, the Pallas kernel in interpret mode and the
  host C++ ``LaneStreamDecoder``, round after round with the states and
  pointers carried: exact integers.
* K2's kernel-ready table (``ops/lane_decode.prepare_lane_table``) and the
  kernel's lookup search in plain PyTorch
  (``ops/lane_decode.lane_decode_round_lookup``, which reads only the
  prepared buffer) equal the twin, and through it JAX, the Pallas
  interpreter and the host decoder: on the same cases, the flagship y table,
  a flagship-width z table, rows of length 2 and 3, and states whose 16-bit
  slot sits on every bucket edge, the slot before it and in each row's last
  bucket; the plan keeps the flagship y table and the rings at K 128 inside
  a block's 227 KB.

Inputs are random tables and symbols from a numpy seed, escapes included,
at several (N, K, m) with m not a multiple of K, and the flagship's real y
table.  The kernel itself runs only on a GPU
(``tests/test_torch_lane_decode_gpu.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crdr_tpu.ops import device_rans as jdr
from crdr_tpu.ops.pallas_lane_decode import pallas_lane_decode_round
from crdr_tpu.runtime import lane_rans as jlr
from crdr_tpu_torch.entropy import (EntropyBottleneckCodec,
                                    GaussianConditionalCodec,
                                    SteEntropyBottleneck, get_scale_table)
from crdr_tpu_torch.ops import device_rans as tdr
from crdr_tpu_torch.ops.lane_decode import (RING, lane_decode_round,
                                            lane_decode_round_lookup,
                                            lane_plan, prepare_lane_table)
from crdr_tpu_torch.runtime import lane_rans as tlr
from tests.test_lane_rans import _random_tables


def _y_tables():
    codec = GaussianConditionalCodec()
    codec.update_scale_table(get_scale_table())
    return codec.quantized_cdf, codec.cdf_length, codec.offset


def _case(rng, tables, n_imgs, n_slices, m, k, esc):
    """Per image: symbols, CDF rows [S, m] and the port's lane encoding."""
    cdfs, cdf_len, offsets = tables
    imgs = []
    for _ in range(n_imgs):
        idx = rng.integers(0, cdfs.shape[0], (n_slices, m)).astype(np.int32)
        max_v = cdf_len[idx] - 2
        v = offsets[idx] + np.minimum(
            rng.geometric(0.3, (n_slices, m)) - 1, max_v - 1)
        if esc:
            v = np.where(rng.random((n_slices, m)) < esc,
                         offsets[idx] + max_v + 7, v)
        v = v.astype(np.int32)
        off = np.arange(n_slices + 1) * m
        imgs.append((v, idx, tlr.lane_encode(v, idx, off, k, cdfs, cdf_len,
                                             offsets, fix_cap=4)))
    return imgs


def _padded(imgs):
    """[N, K, W] int32 words and [N, F] fixups, as the codec uploads them."""
    n, k = len(imgs), imgs[0][2][0].shape[0]
    w = max(e[2][0].shape[1] for e in imgs)
    f = max(1, max(e[2][2].size for e in imgs))
    words = np.zeros((n, k, w), np.int32)
    fp, fv = np.zeros((n, f), np.int64), np.zeros((n, f), np.int32)
    fa = np.zeros((n, f), bool)
    for i, (_, _, (wd, _, p, v)) in enumerate(imgs):
        words[i, :, :wd.shape[1]] = wd
        fp[i, :p.size], fv[i, :p.size], fa[i, :p.size] = p, v, True
    return words, fp, fv, fa


CASES = [  # seed, n_imgs, n_slices, m, K, escape fraction
    (0, 2, 3, 100, 16, 0.0),      # ragged m vs K
    (1, 3, 4, 37, 8, 0.08),       # escapes + tail mask
    (2, 2, 2, 5, 32, 0.0),        # more lanes than symbols
    (5, 2, 2, 300, 128, 0.02),    # the flagship's lane count
]


@pytest.mark.parametrize("seed,n,s,m,k,esc", CASES)
def test_lane_encode_and_containers_match_jax(seed, n, s, m, k, esc):
    rng = np.random.default_rng(seed)
    tables = _random_tables(rng)
    for v, idx, enc in _case(rng, tables, n, s, m, k, esc):
        ref = jlr.lane_encode(v, idx, np.arange(s + 1) * m, k, *tables)
        for a, b in zip(enc, ref):
            np.testing.assert_array_equal(a, b)
        blob = tlr.pack_lane_container(*enc)
        assert blob == jlr.pack_lane_container(*ref)
        for a, b in zip(tlr.unpack_lane_container(blob),
                        jlr.unpack_lane_container(blob)):
            np.testing.assert_array_equal(a, b)


def _decode_all(imgs, s, m, rounds_of):
    """Round-by-round decode with the states carried; ``rounds_of`` maps
    (states, ptrs, words, idx, i) -> (vals, states, ptrs) in numpy."""
    words, fp, fv, fa = _padded(imgs)
    idx_all = np.stack([e[1] for e in imgs])            # [N, S, m]
    st = ((words[..., 0].astype(np.int64) << 16) | words[..., 1])
    pt = np.full(st.shape, 2, np.int32)
    out = []
    for i in range(s):
        vals, st, pt = rounds_of(st, pt, words, idx_all[:, i], i)
        out.append((vals, st.copy(), pt.copy()))
    return out, (fp, fv, fa)


@pytest.mark.parametrize("seed,n,s,m,k,esc", CASES)
def test_twin_matches_jax_pallas_and_host_decoder(seed, n, s, m, k, esc):
    rng = np.random.default_rng(seed)
    tables = _random_tables(rng)
    imgs = _case(rng, tables, n, s, m, k, esc)
    cdf, ln, off = tables
    tt = [torch.from_numpy(a) for a in tables]
    jt = [jnp.asarray(a) for a in tables]

    def twin(st, pt, words, idx, i):
        v, st, pt = tdr.lane_decode_round_instep(
            torch.from_numpy(st), torch.from_numpy(pt),
            torch.from_numpy(words), torch.from_numpy(idx), *tt, m)
        return v.numpy(), st.numpy(), pt.numpy()

    def jax_xla(st, pt, words, idx, i):
        v, st, pt = jdr.lane_decode_round_instep(
            jnp.asarray(st.astype(np.uint32)), jnp.asarray(pt),
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(idx), *jt, m)
        return (np.asarray(v), np.asarray(st).astype(np.int64),
                np.asarray(pt))

    def jax_pallas(st, pt, words, idx, i):
        v, st, pt = pallas_lane_decode_round(
            jnp.asarray(st.astype(np.uint32)), jnp.asarray(pt),
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(idx), *jt, m,
            interpret=True)
        return (np.asarray(v), np.asarray(st).astype(np.int64),
                np.asarray(pt))

    got, fixups = _decode_all(imgs, s, m, twin)
    for ref_fn in (jax_xla, jax_pallas):
        ref, _ = _decode_all(imgs, s, m, ref_fn)
        for a, b in zip(got, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # the host C++ decoder, and the symbols the encoder was given
    fp, fv, fa = (torch.from_numpy(a) for a in fixups)
    for b, (v, idx, (words, lens, _, _)) in enumerate(imgs):
        dec = tlr.LaneStreamDecoder(words, lens)
        for i in range(s):
            host = dec.decode(idx[i], cdf, ln, off)
            np.testing.assert_array_equal(got[i][0][b], host)
            fixed = tdr.apply_fixups(torch.from_numpy(got[i][0]), fp, fv, fa,
                                     i * m, m)
            np.testing.assert_array_equal(fixed[b].numpy(), v[i])


def test_twin_on_the_flagship_y_table():
    """The real 64-row y table (rows up to 3133 entries), 2 images, K 16."""
    rng = np.random.default_rng(3)
    tables = _y_tables()
    s, m, k = 2, 150, 16
    imgs = _case(rng, tables, 2, s, m, k, 0.01)
    tt = [torch.from_numpy(a) for a in tables]
    jt = [jnp.asarray(a) for a in tables]
    words, *_ = _padded(imgs)
    idx_all = np.stack([e[1] for e in imgs])
    st, pt = tdr.init_lane_state(torch.from_numpy(words))
    jst, jpt = jdr.init_lane_state(jnp.asarray(words.astype(np.uint32)))
    for i in range(s):
        v, st, pt = tdr.lane_decode_round_instep(
            st, pt, torch.from_numpy(words),
            torch.from_numpy(idx_all[:, i]), *tt, m)
        jv, jst, jpt = jdr.lane_decode_round_instep(
            jst, jpt, jnp.asarray(words.astype(np.uint32)),
            jnp.asarray(idx_all[:, i]), *jt, m)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(st.numpy(),
                                      np.asarray(jst).astype(np.int64))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))


def test_apply_fixups_matches_jax():
    rng = np.random.default_rng(4)
    n, m, f = 3, 50, 9
    vals = rng.integers(-9, 9, (n, m)).astype(np.int32)
    pos = rng.integers(-20, 180, (n, f)).astype(np.int64)
    val = rng.integers(100, 200, (n, f)).astype(np.int32)
    act = rng.random((n, f)) < 0.7
    for lo in (0, 50, 100):
        got = tdr.apply_fixups(torch.from_numpy(vals), torch.from_numpy(pos),
                               torch.from_numpy(val), torch.from_numpy(act),
                               lo, m)
        ref = jdr.apply_fixups(jnp.asarray(vals), jnp.asarray(pos, np.int32),
                               jnp.asarray(val), jnp.asarray(act), lo, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_init_lane_state_matches_jax():
    words = np.random.default_rng(6).integers(0, 1 << 16, (2, 5, 7))
    st, pt = tdr.init_lane_state(torch.from_numpy(words.astype(np.int32)))
    jst, jpt = jdr.init_lane_state(jnp.asarray(words.astype(np.uint32)))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst).astype(np.int64))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    assert st.dtype == torch.int64 and pt.dtype == torch.int32


def test_wrapper_runs_the_twin_on_cpu_tensors():
    rng = np.random.default_rng(7)
    tables = _random_tables(rng)
    imgs = _case(rng, tables, 2, 1, 40, 8, 0.0)
    words, *_ = _padded(imgs)
    w = torch.from_numpy(words)
    st, pt = tdr.init_lane_state(w)
    idx = torch.from_numpy(np.stack([e[1][0] for e in imgs]))
    tt = [torch.from_numpy(a) for a in tables]
    before = lane_decode_round.launches
    got = lane_decode_round(st, pt, w, idx, prepare_lane_table(*tables), 40)
    ref = tdr.lane_decode_round_instep(st, pt, w, idx, *tt, 40)
    assert lane_decode_round.launches == before  # no kernel on the CPU
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.stack([e[0][0] for e in imgs]))


def test_lane_encode_grows_the_fixup_buffer():
    """Escapes past ``fix_cap`` grow the buffer; the bytes do not change."""
    rng = np.random.default_rng(8)
    tables = _random_tables(rng)
    (v, idx, small), = _case(rng, tables, 1, 2, 60, 8, 0.3)
    big = tlr.lane_encode(v, idx, [0, 60, 120], 8, *tables, fix_cap=1024)
    assert small[2].size > 4  # more escapes than the first buffer held
    for a, b in zip(small, big):
        np.testing.assert_array_equal(a, b)


def test_container_overflow_raises():
    words = np.zeros((2, 3), np.uint16)
    lens = np.asarray([2, 70000], np.int32)
    with pytest.raises(ValueError, match="overflow"):
        tlr.pack_lane_container(words, lens, np.zeros(0, np.int64),
                                np.zeros(0, np.int32))


def test_unpack_names_the_config_key():
    with pytest.raises(ValueError, match="wire_format: compressai"):
        tlr.unpack_lane_container(b"not a lane container")


# ---- K2's kernel-ready table and its lookup search ------------------------

def _z_tables():
    """A z table at the flagship's width: 192 channels of the bottleneck's
    seeded init."""
    m = SteEntropyBottleneck(192)
    m.reset_parameters(torch.Generator().manual_seed(0))
    codec = EntropyBottleneckCodec(
        {k: v.detach().numpy() for k, v in m.named_parameters()})
    codec.update()
    return codec.quantized_cdf, codec.cdf_length, codec.offset


def _lookup_fn(table, m):
    def fn(st, pt, words, idx, i):
        v, st, pt = lane_decode_round_lookup(
            torch.from_numpy(st), torch.from_numpy(pt),
            torch.from_numpy(words), torch.from_numpy(idx), table, m)
        return v.numpy(), st.numpy(), pt.numpy()
    return fn


@pytest.mark.parametrize("seed,n,s,m,k,esc", CASES)
def test_lookup_search_matches_twin_jax_pallas_and_host(seed, n, s, m, k,
                                                        esc):
    """The prepared buffer and the kernel's search on the twin's cases,
    round after round with the states carried."""
    rng = np.random.default_rng(seed)
    tables = _random_tables(rng)
    imgs = _case(rng, tables, n, s, m, k, esc)
    jt = [jnp.asarray(a) for a in tables]

    def jax_pallas(st, pt, words, idx, i):
        v, st, pt = pallas_lane_decode_round(
            jnp.asarray(st.astype(np.uint32)), jnp.asarray(pt),
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(idx), *jt, m,
            interpret=True)
        return (np.asarray(v), np.asarray(st).astype(np.int64),
                np.asarray(pt))

    def twin(st, pt, words, idx, i):
        v, st, pt = tdr.lane_decode_round_instep(
            torch.from_numpy(st), torch.from_numpy(pt),
            torch.from_numpy(words), torch.from_numpy(idx),
            *(torch.from_numpy(a) for a in tables), m)
        return v.numpy(), st.numpy(), pt.numpy()

    got, _ = _decode_all(imgs, s, m, _lookup_fn(prepare_lane_table(*tables),
                                                m))
    for ref_fn in (twin, jax_pallas):
        ref, _ = _decode_all(imgs, s, m, ref_fn)
        for a, b in zip(got, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for b, (_, idx, (words, lens, _, _)) in enumerate(imgs):
        dec = tlr.LaneStreamDecoder(words, lens)
        for i in range(s):
            np.testing.assert_array_equal(
                got[i][0][b], dec.decode(idx[i], *tables))


@pytest.mark.parametrize("which", ["y", "z"])
def test_lookup_search_on_the_flagship_tables(which):
    """The flagship's 64-row y table (rows up to 3133 entries) and a
    192-channel z table: streams of seeded symbols, two rounds, against the
    twin and JAX."""
    rng = np.random.default_rng(14)
    tables = _y_tables() if which == "y" else _z_tables()
    s, m, k = 2, 150, 16
    imgs = _case(rng, tables, 2, s, m, k, 0.01)
    table = prepare_lane_table(*tables)
    jt = [jnp.asarray(a) for a in tables]

    def jax_xla(st, pt, words, idx, i):
        v, st, pt = jdr.lane_decode_round_instep(
            jnp.asarray(st.astype(np.uint32)), jnp.asarray(pt),
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(idx), *jt, m)
        return (np.asarray(v), np.asarray(st).astype(np.int64),
                np.asarray(pt))

    got, _ = _decode_all(imgs, s, m, _lookup_fn(table, m))
    ref, _ = _decode_all(imgs, s, m, jax_xla)
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for b, (v, idx, (words, lens, _, _)) in enumerate(imgs):
        dec = tlr.LaneStreamDecoder(words, lens)
        for i in range(s):
            np.testing.assert_array_equal(got[i][0][b],
                                          dec.decode(idx[i], *tables))


def _short_tables():
    """Rows of length 2 and 3 (one or two symbols), and a degenerate row
    of length 1 and 0, beside a longer one."""
    cdf = np.zeros((6, 5), np.int32)
    cdf[0, :2] = [0, 65536]
    cdf[1, :3] = [0, 40000, 65536]
    cdf[2, :3] = [0, 1, 65536]
    cdf[3, :1] = [7]
    cdf[4, :1] = [3]          # len 0: the twin still reads cdf[r, 0]
    cdf[5, :5] = [0, 256, 257, 65279, 65536]
    return (cdf, np.asarray([2, 3, 3, 1, 0, 5], np.int32),
            np.asarray([0, -1, 2, 5, -3, 4], np.int32))


def _edge_mods(bits):
    """Every bucket edge u * 2^(16-bits), the slot before it, and the last
    bucket's last slot."""
    edges = np.arange(1 << bits, dtype=np.int64) << (16 - bits)
    return np.unique(np.concatenate([edges, edges - 1, [65535]]))[1:]


@pytest.mark.parametrize("which,bits", [("y", 8), ("z", 8), ("short", 8),
                                        ("y", 4), ("short", 0)])
def test_lookup_search_at_every_bucket_edge(which, bits):
    """One step per lane from states whose slot (x & 0xFFFF) is each bucket
    edge, the slot before it and the last slot, on every row: the
    emulation's values, states and pointers equal the twin's."""
    tables = {"y": _y_tables, "z": _z_tables, "short": _short_tables}[which]()
    table = prepare_lane_table(*tables, bits=bits)
    mods = _edge_mods(bits)
    rng = np.random.default_rng(15)
    tt = [torch.from_numpy(np.asarray(a, np.int32)) for a in tables]
    rows = tables[0].shape[0]
    for r0 in range(0, rows, 8):
        rr = np.arange(r0, min(r0 + 8, rows))
        r_of, mod_of = (a.reshape(1, -1) for a in np.meshgrid(rr, mods,
                                                             indexing="ij"))
        k = r_of.shape[1]
        hi = rng.integers(1, 1 << 16, (1, k))
        st = torch.from_numpy((hi << 16) | mod_of)
        pt = torch.full((1, k), 2, dtype=torch.int32)
        words = torch.from_numpy(rng.integers(0, 1 << 16, (1, k, 4))
                                 .astype(np.int32))
        idx = torch.from_numpy(r_of.astype(np.int32))
        got = lane_decode_round_lookup(st, pt, words, idx, table, k)
        ref = tdr.lane_decode_round_instep(st, pt, words, idx, *tt, k)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_prepared_table_layout():
    """Headers, the lookup's counts and the packed entries, read back."""
    cdf, ln, off = _short_tables()
    t = prepare_lane_table(cdf, ln, off, bits=2)
    buf = t.buf.numpy()
    assert t.rows == 6 and t.bits == 2 and buf.size % 4 == 0
    hdr = buf[:24].reshape(6, 4)
    np.testing.assert_array_equal(hdr[:, 1], ln)
    np.testing.assert_array_equal(hdr[:, 2], off)
    lk = buf[24:24 + 15].view(np.uint16)[:30].reshape(6, 5)
    # row 5: entries 0, 256, 257, 65279 | 65536; slots 0, 16384, 32768,
    # 49152; the last entry is len - 1
    np.testing.assert_array_equal(lk[5], [1, 3, 3, 3, 4])
    np.testing.assert_array_equal(lk[1], [1, 1, 1, 2, 2])
    np.testing.assert_array_equal(lk[3], [0, 0, 0, 0, 0])
    for r in range(6):
        n = max(ln[r], 1)
        np.testing.assert_array_equal(buf[hdr[r, 0]:hdr[r, 0] + n],
                                      cdf[r, :n])
    for a, b in zip(t[:3], (cdf, ln, off)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_prepare_lane_table_raises():
    cdf, ln, off = _short_tables()
    bad = cdf.copy()
    bad[5, 2] = 100  # decreasing
    with pytest.raises(ValueError, match="decreases"):
        prepare_lane_table(bad, ln, off)
    with pytest.raises(ValueError, match="cdf_len"):
        prepare_lane_table(cdf, ln + 3, off)
    with pytest.raises(ValueError, match="bits"):
        prepare_lane_table(cdf, ln, off, bits=17)


def test_flagship_table_fits_beside_the_rings():
    """The flagship y buffer (8-bit lookup) and the rings of 8 fit an H100
    block's 227 KB at K 128 and at 1024 lanes; a table too large goes to
    global memory."""
    cap = 227 * 1024  # an H100's opt-in shared memory a block
    t = prepare_lane_table(*_y_tables())
    n = t.buf.numel()
    assert 4 * n == 142944  # 64 headers, 64 x 257 u16, 27,256 entries
    assert RING == 8
    plan = lane_plan(128, n, cap)
    assert plan == {"in_smem": True, "smem_bytes": 16 + 8 * 8 * 128 + 4 * n}
    assert plan["smem_bytes"] <= cap
    assert lane_plan(1024, n, cap) == {
        "in_smem": True, "smem_bytes": 16 + 8 * 8 * 1024 + 4 * n}
    assert lane_plan(64, 64 * 1000 + 8480, cap) == {
        "in_smem": False, "smem_bytes": 16 + 8 * 8 * 64}
    z = prepare_lane_table(*_z_tables())
    assert lane_plan(128, z.buf.numel(), cap)["in_smem"]
