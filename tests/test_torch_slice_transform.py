"""K1 (crdr_tpu_torch/ops/slice_transform.py) and the packed Charm step.

On the CPU the wrapper runs the kernel's plain twin; it is held against the
JAX oracle ``slice_transform_reference`` and, once, the Pallas kernel in
interpret mode.  Tolerance atol 2e-2: bf16 operands, and a one-ulp f32
difference between the frameworks' sums can flip one bf16 rounding of an
intermediate.  The kernel itself is compared with the twin on the card by
``tests/test_torch_slice_transform_gpu.py`` (marked ``gpu``) and by
chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.importers.torch_import import import_state_dict
from crdr_tpu.ops import charm_uniform as jcu
from crdr_tpu.ops.pallas_slice_transform import (pallas_slice_transform,
                                                 slice_transform_reference)
from crdr_tpu_torch.ops import charm_uniform as tcu
from crdr_tpu_torch.ops.slice_transform import (fits_fused, slice_transform,
                                                slice_transform_plain)
from crdr_tpu_torch.subnet import build_subnet as tbuild
from tests.test_comp_model import tiny_opt
from tests.test_torch_subnets import _JaxCharm

K1_ATOL = 2e-2


def _make(rng, n, h, w, cin, c0=24, c1=16, cout=8, fan_in_scaled=False):
    def a(shape, s):
        if fan_in_scaled and len(shape) == 4:
            s = 1.0 / np.sqrt(np.prod(shape[:3]))
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return (a((n, h, w, cin), 1.0), a((5, 5, cin, c0), 0.05), a(c0, 0.1),
            a((5, 5, c0, c1), 0.05), a(c1, 0.1), a((3, 3, c1, cout), 0.05),
            a(cout, 0.1))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 3)])
def test_plain_matches_jax_reference(seed, n):
    args = _make(np.random.default_rng(seed), n, 4, 6, 16)
    ref = np.asarray(slice_transform_reference(*map(jnp.asarray, args)))
    out = slice_transform_plain(*map(torch.from_numpy, args)).numpy()
    assert out.shape == ref.shape == (n, 4, 6, 8)
    np.testing.assert_allclose(out, ref, atol=K1_ATOL, rtol=0)
    assert np.abs(out).mean() > 1e-3


def test_plain_matches_pallas_interpret():
    args = _make(np.random.default_rng(0), 1, 4, 6, 16)
    ref = np.asarray(pallas_slice_transform(*map(jnp.asarray, args),
                                            interpret=True))
    out = slice_transform_plain(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(out, ref, atol=K1_ATOL, rtol=0)


def test_plain_is_batch_size_independent():
    args = _make(np.random.default_rng(4), 3, 5, 7, 16)
    t = list(map(torch.from_numpy, args))
    full = slice_transform_plain(*t)
    for i in range(3):
        one = slice_transform_plain(t[0][i:i + 1], *t[1:])
        assert torch.equal(full[i:i + 1], one)


def test_wrapper_on_cpu_runs_the_plain_twin():
    args = list(map(torch.from_numpy,
                    _make(np.random.default_rng(5), 2, 4, 6, 16)))
    stacks = [torch.stack([a * 0, a]) for a in args[1:]]  # slice 1 is `a`
    before = slice_transform.launches
    out = slice_transform(args[0], *stacks, 1)
    assert slice_transform.launches == before  # no kernel launched
    assert torch.equal(out, slice_transform_plain(*args))


def test_fits_fused_gate_matches_jax():
    from crdr_tpu.ops.pallas_slice_transform import fits_fused as jfits
    for hw in [(32, 48), (64, 96), (64, 97), (128, 128), (1, 6144),
               (1, 6145)]:
        assert fits_fused(*hw) == jfits(*hw)


# ---- the packed per-slice stacks -------------------------------------------

CM = tiny_opt().subnet.context_model.to_dict()
NS, SC = CM["num_slices"], CM["bottleneck_y"] // CM["num_slices"]
HALF, MSUP = CM["hyper_out_ch"] // 2, CM["max_support_slices"]


@pytest.fixture(scope="module")
def charm():
    port = tbuild(CM, "context_model")
    g = torch.Generator().manual_seed(0)
    for m in port.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    packed = tcu.pack_charm_weights(port.state_dict(), NS, SC, HALF, MSUP)
    return port, packed


def test_pack_matches_jax(charm):
    port, packed = charm
    template = jax.eval_shape(lambda: _JaxCharm().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, NS * SC)),
        jnp.zeros((1, 4, 4, 2 * HALF))))["params"]
    state = {f"context_model.{k}": v.numpy()
             for k, v in port.state_dict().items()}
    params = import_state_dict(state, template, use_rate=True, use_beta=True,
                               strict=True)
    ref = jcu.pack_charm_weights(params["context_model"], NS, SC, HALF, MSUP)
    assert sorted(ref) == sorted(packed)
    for k in ref:
        np.testing.assert_array_equal(packed[k], ref[k], err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("idx", range(NS))
@pytest.mark.parametrize("kind", ["mean", "scale", "lrp"])
def test_packed_slice_transform_matches_own_weights(charm, kind, idx, fused):
    """The padded packed input/weights compute the slice's own transform:
    f32 convolutions (fused off) or the K1 plain twin (fused on)."""
    port, packed = charm
    stacks = {k: torch.from_numpy(v) for k, v in packed.items()}
    stacks.update(tcu.kernel_stacks(stacks))
    nsup = min(idx, MSUP)
    rng = np.random.default_rng(idx)
    hyper = torch.from_numpy(rng.standard_normal((2, 4, 4, HALF))
                             .astype(np.float32))
    sup = torch.from_numpy(rng.standard_normal((2, 4, 4, nsup * SC))
                           .astype(np.float32))
    cur = torch.from_numpy(rng.standard_normal((2, 4, 4, SC))
                           .astype(np.float32))
    pad = torch.zeros((2, 4, 4, (MSUP - nsup) * SC))
    tail = [cur] if kind == "lrp" else []
    x_packed = torch.cat([hyper, sup, pad] + tail, -1)
    x_own = torch.cat([hyper, sup] + tail, -1)
    with torch.no_grad():
        out = tcu._slice_transform(stacks, kind, idx, x_packed, fused)
        st = getattr(port, f"{kind}_slice_transforms")[idx]
        if fused:
            ws = [st.model[j].weight.permute(2, 3, 1, 0) for j in (0, 2, 4)]
            bs = [st.model[j].bias for j in (0, 2, 4)]
            own = slice_transform_plain(x_own, ws[0], bs[0], ws[1], bs[1],
                                        ws[2], bs[2])
            np.testing.assert_allclose(out.numpy(), own.numpy(),
                                       atol=K1_ATOL, rtol=0)
        else:
            own = st(x_own.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            np.testing.assert_allclose(out.numpy(), own.numpy(), rtol=1e-5,
                                       atol=1e-5)


# ---- the kernel's tiling plan (pure Python; the kernel runs it on the card) --

from crdr_tpu_torch.ops import slice_transform as k1  # noqa: E402


def _admitted_shapes():
    """Latents fits_fused admits, sampled densely: every h x w with h, w in
    a spread of sizes, the edges and the largest."""
    sizes = [1, 2, 3, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 96]
    return [(h, w) for h in sizes for w in sizes if fits_fused(h, w)] + [
        (1, 6144), (6144, 1), (64, 96), (96, 64), (31, 47)]


STAGES = [(480, 224, 5), (512, 224, 5), (224, 128, 5), (128, 32, 3),
          (48, 224, 5), (16, 8, 3)]


def test_plan_takes_no_batch_size():
    import inspect
    for fn in (k1.conv_plan, k1.slice_transform_plan):
        names = set(inspect.signature(fn).parameters)
        assert not names & {"n", "batch", "batch_size", "N"}, names
    assert set(inspect.signature(k1.conv_plan).parameters) == {
        "h", "w", "cin", "cout", "ksize", "split"}


@pytest.mark.parametrize("cin,cout,ksize", STAGES)
def test_plan_tiles_cover_every_position_once(cin, cout, ksize):
    for h, w in _admitted_shapes():
        p = k1.conv_plan(h, w, cin, cout, ksize)
        assert p["cw"] * p["rb"] == k1.BOX_M
        seen = np.zeros((h, w), np.int64)
        for t in range(p["tiles_x"] * p["tiles_y"]):
            pos = k1.plan_tile_positions(p, t)
            assert len(set(pos)) == k1.TILE_M  # no row twice in a tile
            for y, x in pos:
                if y < h and x < w:
                    seen[y, x] += 1
        assert (seen == 1).all(), (h, w, cin, cout)
        # the grid's extra tile (tiles rounded up to the pair) stores nothing
        tiles = p["tiles_x"] * p["tiles_y"]
        for t in range(tiles, -(-tiles // p["pair"]) * p["pair"]):
            assert all(y >= h for y, _ in k1.plan_tile_positions(p, t))


@pytest.mark.parametrize("cin,cout,ksize", STAGES)
def test_plan_k_partition_covers_taps_and_channels_once(cin, cout, ksize):
    for h, w in [(1, 1), (5, 7), (32, 48), (64, 96)]:
        p = k1.conv_plan(h, w, cin, cout, ksize)
        ranks = k1.plan_k_steps(p)
        assert len(ranks) == p["split"] and all(ranks)
        steps = [s for r in ranks for s in r]
        # taps outer, 64-channel chunks inner, the ranks in order
        want = [(t, c) for t in range(ksize * ksize)
                for c in range(0, cin, k1.BK)]
        assert steps == want
        covered = {(t, c + j) for t, c in steps
                   for j in range(min(k1.BK, cin - c))}
        assert covered == {(t, c) for t in range(ksize * ksize)
                           for c in range(cin)}
        assert p == k1.conv_plan(h, w, cin, cout, ksize)  # one fixed order
        assert p["cout"] <= p["n_inst"] and p["n_inst"] in k1.N_INST


@pytest.mark.parametrize("hw,splits", [
    ((32, 48), [2, 2, 2]),    # the flagship latent: 96 blocks at batch 4
    ((64, 96), [1, 1, 1]),    # 192 tiles at batch 4 fill the card alone
    ((1, 1), [8, 8, 4]),      # conv2's 9 taps x 2 chunks: 4 steps a rank
])
def test_plan_split_fills_one_wave_at_the_reference_batch(hw, splits):
    plans = k1.slice_transform_plan(*hw, 480, 224, 128, 32)
    assert [p["split"] for p in plans] == splits
    for p in plans:
        tiles = -(-p["tiles_x"] * p["tiles_y"] // p["pair"]) * p["pair"]
        blocks = k1.REF_BATCH * tiles * p["split"]
        assert blocks <= k1.RESIDENT_BLOCKS or p["split"] == 1
        assert p["split"] * p["pair"] <= k1.MAX_SPLIT
        shared = p["tiles_x"] * p["tiles_y"] > 1 and p["n_inst"] > 128
        assert p["pair"] == (2 if shared else 1)
    if hw == (32, 48):
        assert [p["tiles_x"] * p["tiles_y"] for p in plans] == [12, 12, 12]
        ints = k1.plan_ints(plans)
        assert len(ints) == 3 * k1.PLAN_INTS
        assert ints[:11] == [5, 480, 224, 224, 16, 4, 3, 4, 8, 2, 2]
        assert [p["pair"] for p in plans] == [2, 1, 1]


@pytest.mark.parametrize("args", [
    (64, 97, 480, 224, 5),   # beyond fits_fused
    (0, 48, 480, 224, 5),    # empty latent
    (32, 48, 484, 224, 5),   # Cin not a multiple of 8
    (32, 48, 480, 228, 5),   # Cout not a multiple of 8
    (32, 48, 480, 232, 5),   # Cout beyond the widest wgmma N
    (32, 48, 480, 224, 7),   # a kernel size the SliceTransform has not
])
def test_plan_raises_for_a_shape_it_cannot_serve(args):
    with pytest.raises(ValueError, match="conv_plan"):
        k1.conv_plan(*args)


@pytest.mark.parametrize("split", [3, 16])
def test_plan_raises_for_a_split_it_cannot_serve(split):
    with pytest.raises(ValueError, match="conv_plan"):
        k1.conv_plan(32, 48, 480, 224, 5, split)
