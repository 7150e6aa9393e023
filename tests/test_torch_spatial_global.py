"""The spatial split across a global operation, on the CPU: HiFiC with
``InstanceNorm2D`` (``channel_norm: False`` in the encoder and the decoder)
over the serving mesh (``parallel/spatial.py``'s tile exchange,
``models/codec.py``), held to the JAX package's spatial mesh on the same
weights (``tests/test_torch_families.py``'s edited JAX init at tiny
widths; JAX on its virtual CPU devices, the port on ``[cpu] * 4``):

* one 256x256 image over 4 devices, on both wires: streams byte-identical
  to the port at one device; against JAX's ``serving_partition: spatial``
  mesh, byte-identical but for the symbols whose ``y - mean`` lies within
  1e-4 of a rounding boundary (one of 8192 here, apart in the whole codecs
  too); cross-decode both ways between split and whole and between the
  port and JAX; the split analysis and synthesis within JAX's 2e-4 of the
  whole ones;
* the exchange: one round a norm and a call, the same bits whichever tile
  posts first, the moments at the first analysis norm within 1e-6 of
  ``torch.mean`` / ``torch.var`` over the whole tensor;
* the moments take each tile's own rows only: with the input rows past
  the margin set to NaN no own row of any tile turns NaN, one grid row
  less and some does; the margin holds each norm input's halo;
* no local fallback: an ``InstanceNorm2D`` in a tile without an exchange
  raises;
* an AOT package on the split model: a round trip equals the live split,
  its synthesis tiles run live (no ``decode_image`` hit at a tile's
  shape, which the package holds).
"""

import contextlib
import copy
import json
import threading

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models.codec import codec_numerics
from crdr_tpu_torch.nn.norm import InstanceNorm2D
from crdr_tpu_torch.parallel.spatial import (SpatialSplitError, TileExchange,
                                             join_rows, split_rows, tile,
                                             tile_plan)
from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                        load_package,
                                        record_serving_roundtrip)
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_torch_families import pair
from tests.torch_pairs import images, one_torch_thread  # noqa: F401

ATOL = 2e-4  # tests/test_spatial.py
N_DEV, H, W = 4, 256, 256
MESH = dict(serving_devices=N_DEV, serving_partition="spatial")


def _norms(module) -> int:
    return sum(isinstance(m, InstanceNorm2D) for m in module.modules())


def _one_device(sp):
    """The port at one device on ``sp``'s weights and options."""
    one = build_comp_model(ConfigDict(dict(copy.deepcopy(sp.opt.to_dict()),
                                           serving_devices=1)),
                           device="cpu")
    one.load_state_dict(sp.state_dict())
    one.codec_setup()
    return one


def _apart_on_boundaries(model, x, y_a, y_b, what):
    """The symbols apart between two ``y_hat`` of the images ``x`` (a mask),
    checked to be few (at most 1e-3 of them) and each one whose ``y -
    mean`` (``model``'s) lies within 1e-4 of a rounding boundary: where
    two f32 computations of y a few ulps apart may round either way."""
    with codec_numerics(model._chain_tf32):
        y, z_sym, _ = model.encode_head(torch.from_numpy(x), None)
        _, mean, _, _ = model.generic_params(z_sym)
    r = (y - mean).numpy()
    apart = np.abs(np.asarray(y_a) - np.asarray(y_b)) > 0.5
    print(f"{what}: {int(apart.sum())} of {apart.size} symbols apart, y - "
          f"mean {r[apart]}")
    assert apart.sum() <= 1e-3 * apart.size
    assert np.all(np.abs(r[apart] - np.floor(r[apart]) - 0.5) < 1e-4)
    return apart


@pytest.fixture(scope="module")
def trio():
    """(JAX's spatial mesh, the port's split, the port at one device)."""
    jm, sp = pair("hific", instance_norm=True, **MESH)
    return jm, sp, _one_device(sp)


def run_tiles(fn, x, plan, in_rows, out_rows, exchange=None, inputs=None):
    """``fn`` over the tiles of ``plan`` (or over ``inputs``, one tile
    each), one thread a tile, all in tile scopes of ``exchange``; the own
    rows joined."""
    tiles = inputs if inputs is not None else split_rows(x, plan, in_rows)
    outs, errors = [None] * len(plan), []

    def run(i):
        try:
            with torch.no_grad(), tile(exchange, i):
                outs[i] = fn(tiles[i])
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(plan))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return join_rows(outs, plan, out_rows, x.device)


# ---------------- against JAX ---------------------------------------------------------

@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_split_streams_equal_one_device_and_jax(trio, wire):
    """Byte-identical to one device; against JAX's spatial mesh, every
    symbol apart is one whose ``y - mean`` lies within 1e-4 of a rounding
    boundary.  This image has one (of 8192, at ``y - mean`` = 10.500006
    in the port): the port's and JAX's f32 analyses differ by ~1e-5 there,
    split or whole (each package's split equals its whole; at 64x96 the
    whole codecs are byte-identical, ``tests/test_torch_hific.py``)."""
    jm, sp, one = trio
    for m in (jm, sp, one):
        m.opt["wire_format"] = wire
        m.opt["device_wire_lanes"] = 16
        m.codec_setup()
    assert sp._spatial_globals == (_norms(sp.net.encoder),
                                   _norms(sp.net.decoder)) == (5, 10)
    m_enc, m_dec = sp._spatial_margins
    assert sp._spatial_plan(16, 1) == tile_plan(16, N_DEV, m_dec)
    x = images(1, H, W, seed=12)
    e_sp, e_one, e_j = (m.compress(x) for m in (sp, one, jm))
    assert sp._exchange_rounds == [5, 0]  # one fixed-batch call
    assert e_sp["string_list"] == e_one["string_list"]
    y_sp, y_j = e_sp["y_hat"], np.asarray(e_j["y_hat"])
    assert np.unique(y_sp).size > 8
    apart = _apart_on_boundaries(one, x, y_sp, y_j, f"{wire}, JAX's split")
    if not apart.any():
        assert e_sp["string_list"] == [bytes(s) for s in e_j["string_list"]]
    np.testing.assert_allclose(y_sp[~apart], y_j[~apart], rtol=0, atol=1e-5)
    f_sp, _, y_dec = sp.decompress(e_sp["string_list"])
    assert sp._exchange_rounds == [5, 10]
    f_one, _, y_one = one.decompress(e_one["string_list"])
    np.testing.assert_array_equal(y_dec, y_sp)
    np.testing.assert_array_equal(y_one, y_sp)
    assert np.isfinite(f_sp).all() and f_sp.shape == (1, H, W, 3)
    # the images: uint8 levels (codec_uint8_io), one level at most apart
    assert np.abs(f_sp.astype(np.int32) - f_one.astype(np.int32)).max() <= 1
    # cross-decode: split <-> whole exactly; port <-> JAX, each decoding
    # the other's stream to its encoder's y_hat (the means to 1e-5)
    for model, enc in ((one, e_sp), (sp, e_one)):
        np.testing.assert_array_equal(
            model.decompress(enc["string_list"])[2], y_sp)
    for model, enc, want in ((sp, e_j, y_j), (jm, e_sp, y_sp)):
        got = np.asarray(model.decompress(enc["string_list"])[2])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_split_transforms_match_the_whole(trio):
    """The split analysis of a 256x256 image and synthesis of a 16x16
    latent against the whole transforms at JAX's 2e-4."""
    _, sp, one = trio
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 3, H, W)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, sp.yC, H // 16, W // 16)).astype(np.float32))
    plan = sp._spatial_plan(H // 16, 1)
    with torch.no_grad():
        diffs = [float((a - b).abs().max()) for a, b in zip(
            sp._analysis(x, None), one._analysis(x, None))]
        split = sp._spatial_map(y, plan, 1, 16, 1, lambda rep, yt: (
            rep._synthesis_rows(yt, [None, None])))
        diffs.append(float((split - one._synthesis_rows(
            y, [None, None])).abs().max()))
    print(f"split vs whole, largest |difference|: y {diffs[0]:.3g}, z "
          f"{diffs[1]:.3g}, image {diffs[2]:.3g}")
    assert max(diffs) <= ATOL, diffs


def test_served_batch_waits_outside_the_precision_lock(trio, monkeypatch):
    """``compress_batch`` / ``decompress_batch`` of 2 images, as the
    batcher calls them: against one device, every symbol apart lies on a
    rounding boundary (here one of 6144, ``y - mean`` = 5.499995: the
    split's y is ~2.5e-5 from the whole's, its moments summed in another
    order), and each decodes its own stream exactly; no tile waits at the
    exchange's barrier while it holds the precision sections' lock
    (another tile could then never post)."""
    from crdr_tpu_torch.models import codec
    from crdr_tpu_torch.parallel import spatial

    _, sp, one = trio
    waits = []

    class Barrier(threading.Barrier):
        def wait(self, timeout=None):
            sections = codec._SECTIONS
            waits.append(sections._owns(sections._blocks()))
            return super().wait(timeout)

    monkeypatch.setattr(spatial.threading, "Barrier", Barrier)
    x = images(2, 128, 192, seed=4)
    enc_sp, enc_one = sp.compress_batch(x), one.compress_batch(x)
    want = [np.concatenate([e["y_hat"] for e in enc])
            for enc in (enc_sp, enc_one)]
    apart = _apart_on_boundaries(one, x, *want, "batch of 2, the whole")
    f_sp, _, y_sp = sp.decompress_batch([e["string_list"] for e in enc_sp])
    f_one, _, y_one = one.decompress_batch(
        [e["string_list"] for e in enc_one])
    np.testing.assert_array_equal(y_sp, want[0])
    np.testing.assert_array_equal(y_one, want[1])
    same = ~apart.any(axis=(1, 2, 3))  # the images with no symbol apart
    assert same.any()
    for i in np.flatnonzero(same):
        assert enc_sp[i]["string_list"] == enc_one[i]["string_list"]
        assert np.abs(f_sp[i].astype(np.int32)
                      - f_one[i].astype(np.int32)).max() <= 1
    assert len(waits) == N_DEV * 15 and not any(waits)


# ---------------- the exchange ------------------------------------------------------

def _first_norm_input(model, x):
    """The input of the analysis's first norm, whole."""
    got = []
    hook = model.net.encoder.norm1.norm.register_forward_hook(
        lambda m, args, out: got.append(args[0]))
    try:
        with torch.no_grad():
            model.net.encode(x)
    finally:
        hook.remove()
    return got[0]


def test_exchange_combines_in_tile_order(trio):
    """The moments of the first analysis norm through the exchange, the
    tiles posting in order and in reverse: the same bits on every tile and
    in both orders, within 1e-6 of torch.mean / torch.var of the whole."""
    _, sp, _ = trio
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 3, H, W)).astype(np.float32))
    act = _first_norm_input(sp, x)
    plan = tile_plan(H // 16, N_DEV, 0)  # own rows only: no margin needed
    tiles = split_rows(act, plan, 16)

    def moments(order):
        arrived = []
        turn = {i: threading.Event() for i in order}
        turn[order[0]].set()

        @contextlib.contextmanager
        def release():
            # entered by a tile after its post: the next one may post
            i = int(threading.current_thread().name.split("-")[1])
            arrived.append(i)
            nxt = order.index(i) + 1
            if nxt < len(order):
                turn[order[nxt]].set()
            yield

        ex = TileExchange(plan, release=release)
        out = [None] * len(plan)

        def run(i):
            turn[i].wait(30)
            out[i] = ex.moments(i, tiles[i])

        threads = [threading.Thread(target=run, args=(i,), name=f"tile-{i}")
                   for i in range(len(plan))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert arrived == list(order) and ex.rounds == 1
        return out

    forward = moments([0, 1, 2, 3])
    backward = moments([3, 2, 1, 0])
    for got in forward[1:] + backward:
        for a, b in zip(got, forward[0]):
            assert torch.equal(a, b)
    mean, var = forward[0]
    want_mean = torch.mean(act, dim=(2, 3), keepdim=True)
    want_var = torch.var(act, dim=(2, 3), keepdim=True, correction=0)
    for got, want in ((mean, want_mean), (var, want_var)):
        assert got.dtype == want.dtype and got.shape == want.shape
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        assert rel <= 1e-6, rel


def test_exchange_takes_own_rows_only(trio):
    """Tiles cut with two grid rows more than the margin, and the input
    rows past the margin set to NaN: no own row of any tile turns NaN (the
    moments read own rows only, and the margin holds each norm input's
    reach); past one row less, some own row does."""
    _, sp, _ = trio
    net, g = sp.net, 24
    cases = ((net.encode, 3, 16, 1, sp._spatial_margins[0], 48),
             (net.decode, sp.yC, 1, 16, sp._spatial_margins[1], 3))
    for fn, ch, a, b, margin, w in cases:
        x = torch.rand(1, ch, g * a, w, generator=torch.Generator()
                       .manual_seed(0))
        plan = tile_plan(g, 3, margin + 2)
        for m, finite in ((margin, True), (margin - 1, False)):
            tiles = split_rows(x, plan, a)
            for t, (t0, _, g0, g1) in zip(tiles, plan):
                t[:, :, :max(0, (g0 - m - t0) * a)] = float("nan")
                t[:, :, (g1 + m - t0) * a:] = float("nan")
            ex = TileExchange(plan)
            out = run_tiles(fn, x, plan, a, b, ex, inputs=tiles)
            assert ex.rounds == _norms(net.encoder if a > 1 else net.decoder)
            assert bool(torch.isfinite(out).all()) is finite, (fn, m)


def test_margin_holds_each_norm_input():
    """``grid_margin``: the largest of the output's halo and each global
    module's input halo, in grid rows.  A norm on a 9x9 convolution's
    output (4 rows a side, 2 rows a grid row: 2 grid rows) beside an output
    that reads no neighbour (a 1x1 convolution of stride 2)."""
    import torch.nn.functional as F

    from crdr_tpu_torch.parallel.spatial import grid_margin

    g = torch.Generator().manual_seed(0)
    w9, w1 = torch.randn(2, 2, 9, 9, generator=g), torch.ones(2, 2, 1, 1)
    norm = InstanceNorm2D(2)
    down = lambda x: F.conv2d(x, w1, stride=(2, 1))  # noqa: E731

    def fn(x):
        norm(F.conv2d(x, w9, padding=4))
        return down(x)

    assert grid_margin(down, 2, 1, 2, 4) == (0, 0)
    assert grid_margin(fn, 2, 1, 2, 4) == (2, 1)


def test_instance_norm_in_a_tile_without_an_exchange_raises():
    norm = InstanceNorm2D(4)
    x = torch.randn(1, 4, 8, 8)
    with tile(None, 0), pytest.raises(SpatialSplitError, match="exchange"):
        norm(x)
    # outside a tile: torch.mean / torch.var over the pixels, as always
    want = (x - x.mean(dim=(2, 3), keepdim=True)) * torch.rsqrt(
        x.var(dim=(2, 3), keepdim=True, correction=0) + 1e-5)
    assert torch.equal(norm(x), norm.gamma.reshape(1, -1, 1, 1) * want
                       + norm.beta.reshape(1, -1, 1, 1))


def test_a_failed_tile_breaks_the_exchange():
    """A tile that fails before its post does not leave the others waiting:
    they raise, and the failure is the cause."""
    plan = tile_plan(4, 2, 0)
    ex = TileExchange(plan)

    def fn(t):
        if torch.isnan(t).any():
            raise ValueError("tile failed")
        return InstanceNorm2D(2)(t)

    x = torch.randn(1, 2, 4, 4)
    x[:, :, 3] = float("nan")
    with pytest.raises((ValueError, SpatialSplitError)):
        run_tiles(fn, x, plan, 1, 1, ex)
    assert isinstance(ex.failure, ValueError)


# ---------------- AOT ----------------------------------------------------------------

def test_split_round_trip_through_a_package(trio, tmp_path):
    """A package recorded on the split model (a 256x256 round trip, and
    ``decode_image`` at the shape of the split's edge synthesis tiles,
    called outside a tile), loaded into a fresh split model: its round
    trip equals the live split, the tiles exchange, and ``decode_image``
    is never served inside a tile, though outside one the package serves
    it at that shape."""
    _, sp, _ = trio
    sp.opt["wire_format"] = "device"
    sp.codec_setup()
    short = (H // 16) // N_DEV + sp._spatial_margins[1]  # edge tiles' rows
    assert sp._spatial_plan(H // 16, 1)[0] == (0, short, 0, short - (
        sp._spatial_margins[1]))
    edge = torch.zeros(1, sp.yC, short, W // 16)
    record_serving_roundtrip(sp, 1, H, W)
    with codec_numerics(sp._chain_tf32):
        sp._synthesis_rows(edge, [None, None])
    path = str(tmp_path / "pkg")
    manifest = export_package(sp, path, platforms=("cpu",))
    sp._aot.recorder = None
    assert not manifest["skipped"], manifest["skipped"]
    shapes = [json.loads(e["key"])[4][0][1] for e in manifest["entries"]
              if e["name"] == "decode_image"]
    assert shapes == [[4, sp.yC, short, W // 16]], shapes  # fixed batch 4
    fresh = build_comp_model(ConfigDict(copy.deepcopy(sp.opt.to_dict())),
                             device="cpu")
    fresh.load_state_dict(sp.state_dict())
    fresh.codec_setup()
    load_package(fresh, path)
    x = images(1, H, W, seed=5)
    live, got = sp.compress(x), fresh.compress(x)
    assert got["string_list"] == live["string_list"]
    f_live, _, y_live = sp.decompress(live["string_list"])
    f_aot, _, y_aot = fresh.decompress(got["string_list"])
    np.testing.assert_array_equal(y_aot, y_live)
    np.testing.assert_array_equal(f_aot, f_live)
    counts = aot_counts(fresh)
    assert fresh._exchange_rounds == [5, 10]
    assert "decode_image" not in counts, counts  # never dispatched
    assert counts["encode_head"]["hits"] and counts["generic_params"]["hits"]
    with codec_numerics(fresh._chain_tf32):  # outside a tile it is served
        fresh._synthesis_rows(edge, [None, None])
    assert aot_counts(fresh)["decode_image"]["hits"] == 1
