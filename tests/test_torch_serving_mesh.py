"""The port's serving mesh on the CPU (``serving_devices`` /
``serving_partition``, ``models/codec.py``; ``parallel/spatial.py``), held to
the JAX package's ``tests/test_serving_mesh.py`` and ``tests/test_spatial.py``
on the same weights (``tests/torch_pairs.py``; JAX's mesh on its virtual CPU
devices, the port's on ``[cpu] * N``):

* ``serving_devices: 4`` (batch): streams byte-identical to the port at one
  device and to JAX's 4-device mesh, on both wires; decodes equal; the odd
  batch (runs whole on the first device, same bytes);
* ``serving_partition: spatial``: one 256x256 image over 4 devices, streams
  byte-identical to one device and to JAX's spatial mesh, both wires, and
  cross-decode with one device both ways; the split analysis and synthesis
  against the whole ones at JAX's 2e-4;
* the overlap margin is needed: one grid row less breaks the result (the
  Balle18 GDN model, HiFiC and HiFiC with ``InstanceNorm2D`` by value, the
  last through the tiles' exchange; the flagship by dependence, with the
  rows past the margin set to NaN);
* HiFiC with ``InstanceNorm2D`` (``channel_norm: False``) splits, its tiles
  exchanging the moments of each norm (``tests/test_torch_spatial_global
  .py`` holds it to JAX); a tile without an exchange refuses the norm, and
  any other whole-height operation refuses the split; the compress CLI
  with ``--serving_devices 2`` and the serve CLI with an explicit device
  list on the CPU.
"""

import os

import numpy as np
import pytest
import yaml

import torch

from crdr_tpu_torch.cli import compress as compress_cli
from crdr_tpu_torch.cli import serve as serve_cli
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.parallel.spatial import (SpatialSplitError, TileExchange,
                                             tile, tile_plan)
from crdr_tpu_torch.utils import img_utils
from crdr_tpu_torch.utils.codec_utils import (pack_byte_strings,
                                              unpack_byte_strings)
from crdr_tpu_torch.utils.config import ConfigDict
from crdr_tpu_torch.utils.img_utils import decode_png, encode_png
from chip_smoke import family_config
from tests.test_torch_serving import _get_json, _post, _start
from tests.test_torch_spatial_global import run_tiles
from tests.torch_pairs import (BETA, Q, images,  # noqa: F401
                               one_torch_thread, pair, port_model,
                               tiny_config)

FLAGSHIP = "BetaCondInterpCaHyperpriorCharmModel"
ATOL = 2e-4  # tests/test_spatial.py


def _strings(encs):
    return [e["string_list"] for e in encs]


def _port(**extra):
    pm = port_model(tiny_config(FLAGSHIP, **extra))
    pm.codec_setup()
    return pm


@pytest.fixture(scope="module", params=["compressai", "device"])
def batch_trio(request):
    """(port at 1 device, port at 4, JAX at 4) on one wire."""
    wire = dict(wire_format=request.param, device_wire_lanes=8)
    pm4, jm4 = pair(FLAGSHIP, serving_devices=4, **wire)
    return _port(**wire), pm4, jm4


def test_batch_mesh_replicas(batch_trio):
    one, four, _ = batch_trio
    assert one._mesh is None and len(one._replicas) == 1
    assert four._mesh == [torch.device("cpu")] * 4
    assert len(four._replicas) == 4 and four._replicas[0] is four
    nets = [r.net for r in four._replicas]
    assert len({id(n) for n in nets}) == 4  # a replica's own net and tables
    assert len({id(r._table) for r in four._replicas}) == 4
    for k, v in four.net.state_dict().items():
        assert all(torch.equal(n.state_dict()[k], v) for n in nets[1:])


@pytest.mark.parametrize("n", [4, 3])  # 3: the odd batch runs whole
def test_batch_mesh_streams_byte_identical(batch_trio, n):
    one, four, jax4 = batch_trio
    x = images(n, 64, 64, seed=3)
    enc1 = one.compress_batch(x, rate_ind=Q)
    enc4 = four.compress_batch(x, rate_ind=Q)
    encj = jax4.compress_batch(x, rate_ind=Q)
    assert _strings(enc4) == _strings(enc1) == _strings(encj)
    f1, _, y1 = one.decompress_batch(_strings(enc1), beta=BETA)
    f4, _, y4 = four.decompress_batch(_strings(enc4), beta=BETA)
    # each replica decodes what its encoder replayed, exactly
    np.testing.assert_array_equal(y4, np.concatenate(
        [e["y_hat"] for e in enc4]))
    # against one device (other batch sizes through the CPU's convs) and
    # JAX: JAX's tests/test_serving_mesh.py tolerances
    np.testing.assert_allclose(y4, y1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(f4, f1, rtol=0, atol=1e-6)
    _, _, yj = jax4.decompress_batch(_strings(enc4), beta=BETA)
    np.testing.assert_allclose(np.asarray(yj), y4, rtol=0, atol=1e-5)


def test_batch_mesh_per_image_rates(batch_trio):
    """One rate_ind / beta per image: each shard gets its own rows."""
    one, four, _ = batch_trio
    x = images(4, 64, 64, seed=8)
    qs, betas = [0.0, 1.5, 2.0, 0.5], [0.0, 2.56, 1.28, 5.12]
    enc1 = one.compress_batch(x, rate_ind=qs)
    enc4 = four.compress_batch(x, rate_ind=qs)
    assert _strings(enc4) == _strings(enc1)
    f1, _, _ = one.decompress_batch(_strings(enc1), beta=betas)
    f4, _, _ = four.decompress_batch(_strings(enc4), beta=betas)
    np.testing.assert_allclose(f4, f1, rtol=0, atol=1e-6)


def test_replicas_run_in_turn_when_the_transforms_switch_tf32(
        batch_trio, monkeypatch):
    """The replicas run from worker threads, also where the transforms'
    TF32 setting differs from the chain's: they take turns at the
    process-wide flags one precision section at a time.  Every
    convolution and linear layer of a batch encode and decode sees, when
    it is called and again after a pause in which another replica may
    run, its own section's flags (the transforms' for the replicas'
    transform weights, else the chain's); the streams stay one
    device's."""
    import threading
    import time

    import torch.nn.functional as F

    one, four, _ = batch_trio
    chain = four._chain_tf32
    reps = four._replicas
    transform = {p.data_ptr() for r in reps
                 for m in (r._enc_t, r._henc_t, r._dec_t)
                 for p in m.parameters()}
    calls = []

    def checked(real):
        def call(x, w, *args, **kwargs):
            want = (not chain) if w.data_ptr() in transform else chain
            b = torch.backends
            flags = [(b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)]
            time.sleep(1e-4)
            flags.append((b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32))
            calls.append((threading.current_thread().name,
                          flags == [(want, want)] * 2))
            return real(x, w, *args, **kwargs)
        return call

    for name in ("conv2d", "conv_transpose2d", "linear"):
        monkeypatch.setattr(F, name, checked(getattr(F, name)))
    saved = [r._transform_tf32 for r in reps]
    for r in reps:
        r._transform_tf32 = not chain
    try:
        x = images(4, 64, 64, seed=5)
        enc4 = four.compress_batch(x, rate_ind=Q)
        f4, _, _ = four.decompress_batch(_strings(enc4), beta=BETA)
    finally:
        for r, v in zip(reps, saved):
            r._transform_tf32 = v
    workers = {n for n, _ in calls if n.startswith("crdr-mesh")}
    assert len(workers) > 1 and len(calls) > 100
    assert all(ok for _, ok in calls), [n for n, ok in calls if not ok][:5]
    monkeypatch.undo()
    enc1 = one.compress_batch(x, rate_ind=Q)
    assert _strings(enc4) == _strings(enc1)
    f1, _, _ = one.decompress_batch(_strings(enc1), beta=BETA)
    np.testing.assert_allclose(f4, f1, rtol=0, atol=1e-6)


# ---------------- the spatial split ---------------------------------------------

@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_spatial_single_image_byte_identical(wire):
    """One 256x256 image over 4 devices: 16 latent rows, 4 a device plus
    the margins."""
    kw = dict(wire_format=wire, device_wire_lanes=8)
    sp, jsp = pair(FLAGSHIP, serving_devices=4, serving_partition="spatial",
                   **kw)
    one = _port(**kw)
    assert sp._spatial_margins == (9, 9)
    assert sp._spatial_plan(16, 0) == [(0, 13, 0, 4), (0, 16, 4, 8),
                                       (0, 16, 8, 12), (3, 16, 12, 16)]
    x = images(1, 256, 256, seed=12)
    e_sp, e_one = sp.compress(x, rate_ind=1.0), one.compress(x, rate_ind=1.0)
    e_j = jsp.compress(x, rate_ind=1.0)
    assert e_sp["string_list"] == e_one["string_list"] == e_j["string_list"]
    f_sp, _, y_sp = sp.decompress(e_sp["string_list"], beta=BETA)
    f_one, _, y_one = one.decompress(e_one["string_list"], beta=BETA)
    np.testing.assert_allclose(y_sp, y_one, rtol=0, atol=1e-5)
    np.testing.assert_allclose(f_sp, f_one, rtol=0, atol=1e-6)
    # cross-decode: each setting's stream on the other
    _, _, y_a = one.decompress(e_sp["string_list"], beta=BETA)
    _, _, y_b = sp.decompress(e_one["string_list"], beta=BETA)
    np.testing.assert_array_equal(y_a, y_one)
    np.testing.assert_array_equal(y_b, y_sp)
    # a height whose 5 latent rows do not divide by 4 runs whole
    assert sp._spatial_plan(5, 0) is None
    x5 = images(1, 80, 64, seed=2)
    assert sp.compress(x5, rate_ind=1.0)["string_list"] == one.compress(
        x5, rate_ind=1.0)["string_list"]


def test_spatial_analysis_and_synthesis_match_the_whole():
    """JAX's tests/test_spatial.py shapes over 8 devices: the analysis of a
    128x64 image and the synthesis of a 16x8 latent, split, against the
    whole transforms at 2e-4."""
    sp = _port(serving_devices=8, serving_partition="spatial")
    one = _port()
    ri, bt = torch.tensor([1.0]), torch.tensor([2.56])
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 3, 128, 64)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(sp._analysis(x, ri), one._analysis(x, ri)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ATOL,
                                       atol=ATOL)
        y = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (1, 16, 8, 32)).astype(np.float32))
        np.testing.assert_allclose(sp._synthesis(y, ri, bt).numpy(),
                                   one._synthesis(y, ri, bt).numpy(),
                                   rtol=ATOL, atol=ATOL)


def _family_model(family: str, **over):
    opt = dict(family_config(family, tiny=True), seed=7, **over)
    return build_comp_model(ConfigDict(opt), device="cpu")


def _hific_in():
    """HiFiC with ``InstanceNorm2D`` (``channel_norm: False``)."""
    sub = family_config("hific", tiny=True)["subnet"]
    for part in ("encoder", "decoder"):
        sub[part]["channel_norm"] = False
    return _family_model("hific", subnet=sub)


def _tiles(fn, x, plan, a, b):
    """The tiles of ``plan`` through ``fn``, in threads under one exchange
    (which a transform without a global operation never calls)."""
    return run_tiles(fn, x, plan, a, b, TileExchange(plan))


@pytest.mark.parametrize("family", ["balle18", "hific", "hific_in"])
def test_one_margin_row_less_breaks_the_split(family):
    """By value: with the computed margin the tiles give the whole result
    (within 2e-4), with one latent row less they do not (by > 1e-3)."""
    m = {"balle18": _balle18, "hific": lambda: _family_model("hific"),
         "hific_in": _hific_in}[family]()
    m.opt["serving_devices"], m.opt["serving_partition"] = 2, "spatial"
    m.codec_setup()
    m_enc, m_dec = m._spatial_margins
    net, g = m.net, 24
    x = torch.rand(1, 3, 16 * g, 48, generator=torch.Generator().manual_seed(
        0)) * 2 - 1
    y = torch.randn(1, m.yC, g, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for fn, inp, a, b, margin in ((net.encode, x, 16, 1, m_enc),
                                      (net.decode, y, 1, 16, m_dec)):
            whole = fn(inp)
            ok = _tiles(fn, inp, tile_plan(g, 2, margin), a, b)
            short = _tiles(fn, inp, tile_plan(g, 2, margin - 1), a, b)
            np.testing.assert_allclose(ok.numpy(), whole.numpy(), rtol=ATOL,
                                       atol=ATOL)
            assert float((short - whole).abs().max()) > 1e-3


def _balle18():
    from crdr_tpu_torch.utils.config import Config
    from tests.test_torch_generic import CONFIG, TINY

    cfg = Config.from_file(CONFIG)
    for key, kw in TINY.items():
        cfg.subnet[key].update(kw)
    cfg["seed"] = 7
    return build_comp_model(cfg, device="cpu")


def test_flagship_margin_is_the_dependence_reach():
    """The flagship's margins by dependence: with the input rows past the
    margin set to NaN the own rows of a tile stay finite; past one row less,
    some own row turns NaN (f32 cannot see the last margin row of ELIC's
    transforms by value: its weight on the edge rows is ~1e-15)."""
    sp = _port(serving_devices=2, serving_partition="spatial")
    net, (m_enc, m_dec) = sp.net, sp._spatial_margins
    ri, bt = torch.tensor([1.0]), torch.tensor([2.56])
    g, own = 30, (12, 18)  # the own rows of a middle tile
    cases = ((lambda v: net.encode(v, ri), 3, 16, 1, m_enc, 48),
             (lambda v: net.decode(v, ri, bt), sp.yC, 1, 16, m_dec, 3))
    with torch.no_grad():
        for fn, ch, a, b, margin, w in cases:
            for m, finite in ((margin, True), (margin - 1, False)):
                x = torch.rand(1, ch, g * a, w)
                x[:, :, :(own[0] - m) * a] = float("nan")
                x[:, :, (own[1] + m) * a:] = float("nan")
                rows = fn(x)[:, :, own[0] * b:own[1] * b]
                assert bool(torch.isfinite(rows).all()) is finite, m


def _nan_reach(fn, channels, rows, width):
    """(top, bottom) rows of ``fn``'s output that turn NaN when the input
    rows past each edge of a middle cut are NaN: the dependence by value.
    ``fn`` runs as one tile whose own rows, where a global module takes its
    moments, are the 10 grid rows farthest from the cut."""
    g, cut = 40, 20
    out = []
    for past_top in (True, False):
        x = torch.rand(1, channels, g * rows[0], width)
        if past_top:
            x[:, :, :cut * rows[0]] = float("nan")
        else:
            x[:, :, cut * rows[0]:] = float("nan")
        own = (g - 10, g) if past_top else (0, 10)
        with tile(TileExchange([(0, g) + own]), 0):
            bad = torch.isnan(fn(x)).any(dim=3).any(dim=1)[0].numpy()
        c = cut * rows[1]
        out.append(int(bad[c:].sum()) if past_top else int(bad[:c].sum()))
    return tuple(out)


@pytest.mark.parametrize("family", ["flagship", "balle18", "hific",
                                    "hific_in"])
def test_row_halo_is_the_nan_dependence(family):
    """The row tracker's reach of each transform (from the operations'
    geometry; a global module's moments as constants) equals the reach of
    NaN rows through the real transform (its moments from rows far from
    the NaN)."""
    from crdr_tpu_torch.parallel.spatial import row_halo

    m = {"flagship": lambda: _port(), "balle18": _balle18,
         "hific": lambda: _family_model("hific"),
         "hific_in": _hific_in}[family]()
    ri, bt = torch.tensor([1.0]), torch.tensor([2.56])
    net = m.net
    enc = lambda x: net.encode(x, ri if m.use_rate else None)
    dec = lambda y: net.decode(y, ri if m.use_rate else None,
                               bt if m.use_beta else None)
    with torch.no_grad():
        for fn, ch, rows, w in ((enc, 3, (16, 1), 64),
                                (dec, m.opt.subnet.encoder.get(
                                    "out_ch", m.opt.subnet.encoder.get(
                                        "bottleneck_y")), (1, 16), 4)):
            top, bottom = row_halo(fn, torch.zeros(1, ch, 40 * rows[0], w))
            assert (top, bottom) == _nan_reach(fn, ch, rows, w)


def test_row_tracker_refuses_what_a_tile_cannot_reproduce():
    import torch.nn.functional as F

    from crdr_tpu_torch.parallel.spatial import row_halo

    probe = torch.zeros(1, 2, 32, 4)
    assert row_halo(lambda x: F.interpolate(
        F.conv2d(x, torch.ones(2, 2, 3, 3), padding=1), scale_factor=2,
        mode="nearest"), probe) == (2, 2)
    # HiFiC's ChannelNorm: statistics over the channels keep each row
    assert row_halo(lambda x: (x - x.mean(dim=1, keepdim=True)) * torch.rsqrt(
        x.var(dim=1, keepdim=True) + 1e-5), probe) == (0, 0)
    # the height mixed, reshaped, or its rows moved at the same shape
    for bad in (lambda x: F.interpolate(x, scale_factor=2, mode="bilinear"),
                lambda x: x - x.mean(dim=(2, 3), keepdim=True),
                lambda x: x.flatten(2),
                lambda x: torch.softmax(x, dim=2),
                lambda x: torch.cumsum(x, dim=2),
                lambda x: torch.flip(x, dims=(2,)),
                lambda x: torch.roll(x, 1, dims=2)):
        with pytest.raises(SpatialSplitError):
            row_halo(bad, probe)


def test_spatial_refuses_instance_norm(monkeypatch):
    """HiFiC with ``InstanceNorm2D`` splits: the model sets up with its
    margins and one exchange a norm, and a batch mesh still builds 2
    replicas.  What the split refuses is the norm's local moments (a tile
    without an exchange raises) and any whole-height operation it does not
    know (a raw mean over the height in the transform raises
    ``SpatialSplitError`` at setup)."""
    from torch import nn

    m = _hific_in()
    m.opt["serving_devices"], m.opt["serving_partition"] = 2, "spatial"
    m.codec_setup()
    assert m._spatial_margins == (3, 7) and m._spatial_globals == (5, 10)
    with tile(None, 0), pytest.raises(SpatialSplitError, match="exchange"):
        m.net.encode(torch.zeros(1, 3, 64, 64))

    class RawMean(nn.Module):
        def forward(self, x):
            return x - x.mean(dim=(2, 3), keepdim=True)

    monkeypatch.setattr(m.net.encoder.norm1, "norm", RawMean())
    with pytest.raises(SpatialSplitError, match="mixes or reshapes"):
        m.codec_setup()
    monkeypatch.undo()
    m.opt["serving_partition"] = "batch"
    m.codec_setup()  # a batch mesh has nothing to split
    assert len(m._replicas) == 2 and m._spatial_margins is None


# ---------------- the CLIs ------------------------------------------------------------

def test_compress_cli_serving_devices_on_cpu(tmp_path):
    """``--serving_devices 2`` (the CPU twice): the .bin files and PNGs of a
    batch of 4 equal one device's."""
    cfg = tiny_config("InterpCaHyperpriorCharmModel", seed=3).to_dict()
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    for i in range(4):
        img_utils.write_png(str(tmp_path / "img" / f"im{i}.png"),
                            images(1, 64, 96, seed=i)[0])
    outs = {}
    for name, flags in (("one", []), ("two", ["--serving_devices", "2"])):
        compress_cli.main([str(tmp_path / "tiny.yaml"), "--img_dir",
                           str(tmp_path / "img"), "--save_dir",
                           str(tmp_path / name), "-q", "1.5", "-b",
                           str(BETA), "-d", "cpu", "--decompress", "--batch",
                           "4", *flags])
        outs[name] = {f: open(tmp_path / name / f, "rb").read()
                      for f in sorted(os.listdir(tmp_path / name))
                      if f.endswith((".bin", ".png"))}
    assert len(outs["one"]) == 8 and outs["one"] == outs["two"]


def test_serve_cli_mesh_devices_on_cpu(tmp_path):
    """The serve CLI with ``serving_devices: 2`` and ``--mesh_devices
    cpu,cpu``: a request's .bin and PNG equal one device's."""
    cfg = tiny_config(FLAGSHIP, serving_devices=2).to_dict()
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    model = serve_cli.build_model(serve_cli.parse_args(
        [str(path), "-d", "cpu", "--mesh_devices", "cpu,cpu"]))
    assert len(model._replicas) == 2
    one = build_comp_model(ConfigDict(dict(cfg, serving_devices=1)),
                           device="cpu")
    one.codec_setup()
    img = images(1, 64, 64, seed=4)[0]
    want = one.compress(img, rate_ind=Q)["string_list"]
    srv, base = _start(model, max_batch=4, max_wait_s=0.05)
    try:
        assert _get_json(base + "/healthz")["devices"] == ["cpu", "cpu"]
        status, _, body = _post(f"{base}/compress?q={Q}", encode_png(img))
        assert status == 200
        assert unpack_byte_strings(body)[1:] == want[1:]
        status, _, png = _post(f"{base}/decompress?beta={BETA}",
                               pack_byte_strings(want))
        assert status == 200
        fake, _, _ = one.decompress(want, beta=BETA)
        np.testing.assert_array_equal(
            decode_png(png), img_utils.tensor_to_uint8(fake[0]))
    finally:
        srv.shutdown()
        srv.batcher.close()
