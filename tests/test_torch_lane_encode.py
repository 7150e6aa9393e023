"""E1's plain twin (the device wire's lane encoder) against the JAX package's
``lane_encode_rounds`` and the host C++ lane coder, on the CPU.

The cases of ``tests/test_device_rans_encode.py`` (in-range symbols,
escapes, more lanes than symbols, one lane, a batch, fixup overflow counts,
a seeded fuzz of shapes): the port's ``encode_grid`` equals JAX's, and
``lane_encode_rounds`` (the twin, and the kernel's wrapper, which runs the
twin on a CPU tensor and launches nothing) returns JAX's words, lengths,
fixups and escape counts element for element; each image's container equals
the host coder's byte for byte.  The kernel itself is held to the twin on
the card (``tests/test_torch_lane_encode_gpu.py``, ``chip_smoke.py``).

E1 v2's own pieces:
* its division by an exact reciprocal (``reciprocal48`` / ``divide48``, the
  kernel's formula in numpy integers) at every freq in [1, 2^16], at the
  boundary values of x around a spread of quotients and at 2^32 - 1;
* the position table (``lane_positions``: the grid composed with the
  codec's lane permutation) against ``index_select`` then the grid's
  gather, on the flagship's 10-slice grid and on the checkerboard's;
* the wrapper with symbols in the codec's order (``perm``, ``pos``,
  ``etab``), whose CPU implementation is the op's twin
  (``lane_encode_walk``): the same words, lengths, fixups and escape
  flags as the twin's lane-order path, JAX's values and the host coder's
  containers.
"""

import numpy as np
import pytest

import jax
import torch

from crdr_tpu_torch.models.codec_devicewire import DeviceWireCodecMixin

from crdr_tpu.ops.device_rans import encode_grid as jax_encode_grid
from crdr_tpu.ops.device_rans import lane_encode_rounds as jax_encode
from crdr_tpu_torch.ops import device_rans, lane_encode
from crdr_tpu_torch.runtime.lane_rans import lane_encode as host_encode
from crdr_tpu_torch.runtime.lane_rans import pack_lane_container
from tests.test_lane_rans import _random_tables


def _random_case(rng, n_slices, m_per_slice, escape_frac=0.0, batch=1):
    """``tests/test_device_rans_encode.py``'s case generator."""
    cdfs, cdf_len, offsets = _random_tables(rng)
    rows = cdfs.shape[0]
    slice_off = np.arange(n_slices + 1, dtype=np.int64) * m_per_slice
    n = int(slice_off[-1])
    idx = rng.integers(0, rows, size=(batch, n)).astype(np.int32)
    max_v = cdf_len[idx] - 2
    v = (offsets[idx] + rng.integers(0, np.maximum(max_v, 1))).astype(np.int32)
    if escape_frac:
        esc = rng.random((batch, n)) < escape_frac
        v = np.where(esc, offsets[idx] + max_v
                     + rng.integers(-40, 40, size=(batch, n)),
                     v).astype(np.int32)
    return v, idx, slice_off, cdfs, cdf_len, offsets


def _check(v, idx, off, cdfs, cdf_len, offsets, k, fix_cap):
    """``fix_cap=None`` (the codec's call: every escape kept) is held to
    JAX's function with a cap of M."""
    jax_cap = v.shape[1] if fix_cap is None else fix_cap
    grid = device_rans.encode_grid(off, k)
    np.testing.assert_array_equal(grid, jax_encode_grid(off, k))
    t = torch.from_numpy
    launches = lane_encode.lane_encode_rounds.launches
    out = lane_encode.lane_encode_rounds(t(v), t(idx), t(grid), t(cdfs),
                                         t(cdf_len), t(offsets), fix_cap)
    assert lane_encode.lane_encode_rounds.launches == launches  # CPU: twin
    twin = device_rans.lane_encode_rounds(t(v), t(idx), t(grid), t(cdfs),
                                          t(cdf_len), t(offsets), fix_cap)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda s, i, c, cl, o: jax_encode(s, i, grid, c, cl, o, jax_cap))(
            v, idx, cdfs, cdf_len, offsets))
    for a, b, r, name in zip(out, twin, ref, ("words", "lens", "fix_pos",
                                              "fix_val", "n_esc")):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        np.testing.assert_array_equal(a.numpy(), r.astype(np.int64),
                                      err_msg=name)
    words, lens, fp, fv, ne = (a.numpy() for a in out)
    for b in range(v.shape[0]):
        host = host_encode(v[b], idx[b], off, k, cdfs, cdf_len, offsets,
                           fix_cap=1 << 16)
        assert int(ne[b]) == host[2].size
        if host[2].size > jax_cap:
            continue  # JAX's codec re-encodes on the host; the port's has
            # no cap
        f = int(ne[b])
        mine = pack_lane_container(words[b].astype(np.uint16), lens[b],
                                   fp[b, :f].astype(np.int64), fv[b, :f])
        assert mine == pack_lane_container(*host)
    return ne


CASES = {  # (seed, slices, symbols a slice, K, escape share, batch, fix_cap)
    "in_range": (0, 3, 257, 16, 0.0, 1, 64),
    "escapes": (1, 4, 129, 8, 0.08, 1, 64),
    "more_lanes_than_symbols": (2, 2, 3, 32, 0.0, 1, 64),
    "single_lane": (3, 2, 100, 1, 0.0, 1, 64),
    "batched": (4, 3, 65, 8, 0.05, 3, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_jax_and_the_host_coder(case):
    seed, ns, m, k, esc, batch, cap = CASES[case]
    rng = np.random.default_rng(seed)
    _check(*_random_case(rng, ns, m, esc, batch), k, cap)


def test_fixup_overflow_is_counted():
    """Escapes past the cap are dropped from the arrays but counted, as in
    JAX's function."""
    rng = np.random.default_rng(5)
    ne = _check(*_random_case(rng, 1, 200, escape_frac=0.5), 4, 8)
    assert int(ne[0]) > 8


@pytest.mark.parametrize("case", ["escapes", "batched", "overflow"])
def test_no_cap_keeps_every_escape(case):
    """``fix_cap=None``, as the codec calls E1: F = M, every escape is
    stored, and each container equals the host coder's bytes, also where a
    cap of 8 would overflow."""
    seed, ns, m, k, esc, batch, _ = dict(
        CASES, overflow=(5, 1, 200, 4, 0.5, 1, None))[case]
    rng = np.random.default_rng(seed)
    v = _random_case(rng, ns, m, esc, batch)
    ne = _check(*v, k, None)
    assert int(ne.max()) > (8 if case == "overflow" else 0)


def test_fuzz_of_shapes():
    rng = np.random.default_rng(6)
    for _ in range(15):
        ns = int(rng.integers(1, 5))
        m = int(rng.integers(1, 200))
        k = int(rng.integers(1, 64))
        _check(*_random_case(rng, ns, m, float(rng.random() * 0.1)), k, 256)


def test_an_empty_round_and_a_flipped_symbol():
    """m = 0 gives two state words a lane; one symbol more or less changes
    the stream."""
    rng = np.random.default_rng(7)
    v, idx, off, cdfs, cdf_len, offsets = _random_case(rng, 1, 96)
    t = torch.from_numpy
    tabs = (t(cdfs), t(cdf_len), t(offsets))
    grid = device_rans.encode_grid([0, 0], 4)
    words, lens, *_ = lane_encode.lane_encode_rounds(
        t(v[:, :0]), t(idx[:, :0]), t(grid), *tabs, 4)
    assert grid.shape == (0, 4) and lens.tolist() == [[2] * 4]
    np.testing.assert_array_equal(words.numpy(), [[[1, 0]] * 4])
    grid = t(device_rans.encode_grid(off, 8))
    base = lane_encode.lane_encode_rounds(t(v), t(idx), grid, *tabs, 16)
    w = v.copy()
    w[0, 50] += 1
    moved = lane_encode.lane_encode_rounds(t(w), t(idx), grid, *tabs, 16)
    assert not torch.equal(base[0], moved[0])


def test_reciprocal_division_is_exact_at_every_freq():
    """q = x // freq through ``reciprocal48``'s halves, as the kernel
    computes it, at every freq in [1, 2^16]: x = q*f - 1, q*f and q*f + f - 1
    for 48 quotients spread over [0, (2^32 - 1) // f], and x = 2^32 - 1."""
    top = (1 << 32) - 1
    spread = np.concatenate([np.arange(8), np.geomspace(8, 1 << 32, 40)])
    for start in range(1, (1 << 16) + 1, 8192):
        f = np.arange(start, min(start + 8192, (1 << 16) + 1),
                      dtype=np.int64)[:, None]
        hi, lo = device_rans.reciprocal48(f)
        assert hi.max() <= 1 << 16 and lo.max() < 1 << 32
        q = np.minimum(spread[None].astype(np.int64), top // f)
        for x in (q * f - 1, q * f, q * f + f - 1,
                  np.full_like(q, top)):
            x = np.clip(x, 0, top)
            got = device_rans.divide48(x, np.broadcast_to(hi, x.shape),
                                       np.broadcast_to(lo, x.shape))
            np.testing.assert_array_equal(got.astype(np.int64), x // f)


class _LaneShapes(DeviceWireCodecMixin):
    """The lane order of the flagship / the checkerboard at 512x768 (y 32x48
    of 320 channels in 10 slices of 32, z 8x12 of 192): only what
    ``_lane_wire_statics`` reads."""

    def __init__(self, checkerboard: bool):
        self.yC, self.zC, self.num_slices, self.slice_ch = 320, 192, 10, 32
        self.use_charm, self._is_checkerboard = True, checkerboard
        self.device_wire_lanes, self.device = 128, torch.device("cpu")
        self._lane_enc_cache, self._cb_ids_cache = {}, {}


@pytest.mark.parametrize("checkerboard", [False, True])
def test_positions_compose_the_permutation_with_the_grid(checkerboard):
    st = _LaneShapes(checkerboard)._lane_wire_statics(32, 48, 8, 12)
    m = 32 * 48 * 320
    assert torch.equal(torch.sort(st.perm).values, torch.arange(m))
    assert st.grid_y.shape == (3840, 128)
    sym = torch.from_numpy(np.random.default_rng(int(checkerboard))
                           .integers(-50, 50, (2, m)).astype(np.int32))
    act = st.grid_y >= 0
    lane = sym.index_select(1, st.perm)[:, st.grid_y.clamp(min=0).long()]
    held = sym[:, st.pos_y.clamp(min=0).long()]
    assert torch.equal(st.pos_y < 0, ~act)
    assert torch.equal(held[:, act], lane[:, act])
    assert torch.equal(device_rans.lane_positions(st.grid_y, st.perm),
                       st.pos_y)
    assert torch.equal(device_rans.lane_positions(st.grid_y), st.grid_y)


@pytest.mark.parametrize("case", ["escapes", "batched", "in_range"])
def test_codec_order_matches_the_lane_order_path(case):
    """Symbols in a produced order (a seeded permutation of lane order) with
    their ``pos`` and ``etab``, through the wrapper (the op's twin on the
    CPU): words, lengths and fixups equal the twin's lane-order path and
    JAX's; the escape flags equal the twin's operands'; each container is
    the host coder's."""
    seed, ns, m, k, esc, batch, cap = CASES[case]
    rng = np.random.default_rng(seed + 100)
    v, idx, off, cdfs, cdf_len, offsets = _random_case(rng, ns, m, esc,
                                                       batch)
    ne = _check(v, idx, off, cdfs, cdf_len, offsets, k, None)
    t = torch.from_numpy
    perm = t(rng.permutation(v.shape[1]).astype(np.int64))
    inv = torch.argsort(perm)
    v_c, idx_c = t(v)[:, inv], t(idx)[:, inv]  # lane order = v_c[:, perm]
    grid = t(device_rans.encode_grid(off, k))
    pos = device_rans.lane_positions(grid, perm)
    tabs = (t(cdfs), t(cdf_len), t(offsets))
    etab = device_rans.encode_table(*tabs)
    assert torch.equal(etab[..., 0], tabs[0])
    launches = lane_encode.lane_encode_rounds.launches
    got = lane_encode.lane_encode_rounds(v_c, idx_c, grid, *tabs, None,
                                         perm, pos, etab)
    assert lane_encode.lane_encode_rounds.launches == launches
    want = device_rans.lane_encode_rounds(t(v), t(idx), grid, *tabs, None)
    for a, b, name in zip(got, want, ("words", "lens", "fix_pos",
                                      "fix_val", "n_esc")):
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    assert torch.equal(got[4], t(ne))
    words, lens, esc = device_rans.lane_encode_walk(v_c, idx_c, grid, pos,
                                                    etab, *tabs[1:])
    _, _, esc_l = device_rans.lane_encode_operands(t(v), t(idx), grid,
                                                   *tabs)
    assert torch.equal(esc, esc_l) and torch.equal(words, got[0])
    for b in range(v.shape[0]):
        host = host_encode(v[b], idx[b], off, k, cdfs, cdf_len, offsets,
                           fix_cap=1 << 16)
        f = int(got[4][b])
        assert pack_lane_container(
            got[0][b].numpy().astype(np.uint16), got[1][b].numpy(),
            got[2][b, :f].numpy().astype(np.int64), got[3][b, :f].numpy()) \
            == pack_lane_container(*host)
