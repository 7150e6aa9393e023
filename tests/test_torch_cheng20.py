"""The Cheng20 family in the port (``nn/resblock.py``,
``subnet/autoencoder/cheng20.py``, the Cheng20 hyper pair of
``subnet/hyperprior/alt.py``) against the JAX package's, on the CPU.

Weights go JAX -> port through ``export_state_dict`` (``tests/test_torch_families
.py``).  Modules: ``ResBlock`` (down / not, each activation, GDN and IGDN),
``UpResBlock`` (both up types), the four Cheng20 classes and the hyper pair
at tiny widths: rtol 1e-4, atol 5e-4 (f32 convolutions sum in another order
in the two frameworks, as in ``tests/test_torch_generic.py``).  The codec:
``HyperpriorModel`` on the Cheng20 pair and hyper pair, CDF tables
integer-identical, ``[header, z, y]`` byte-identical on the compressai wire
and on the device wire, each package decoding the other's streams.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.nn.resblock import ResBlock as JResBlock
from crdr_tpu.nn.resblock import UpResBlock as JUpResBlock
from crdr_tpu.subnet import build_subnet as jbuild
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.nn.resblock import ResBlock, UpResBlock
from crdr_tpu_torch.subnet import build_subnet as tbuild
from tests.test_torch_families import edit, nchw, nhwc, pair, subnets
from tests.torch_pairs import images, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=5e-4)


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(flax_mod, port_mod, args, seed, use_rate=False):
    jargs = tuple(jnp.asarray(a) for a in args)
    params = edit(jax.device_get(flax_mod.init(jax.random.PRNGKey(seed),
                                               *jargs)["params"]), seed)
    port = torch.nn.ModuleDict({"m": port_mod})
    port.load_state_dict(export_state_dict({"m": params}, port, use_rate,
                                           False))
    jy = flax_mod.apply({"params": params}, *jargs)
    targs = tuple(nchw(a) if a.ndim == 4 else torch.from_numpy(a)
                  for a in args)
    with torch.no_grad():
        ty = port["m"](*targs)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), **TOL)


@pytest.mark.parametrize("actv,actv2,down,in_ch", [
    ("lrelu", "gdn", True, 3), ("lrelu", "lrelu", False, 8),
    ("relu", None, False, 6), ("lrelu", "igdn", False, 8)])
def test_resblock_matches_flax(actv, actv2, down, in_ch):
    kw = dict(actv=actv, actv2=actv2, downscale=down)
    _check(JResBlock(in_ch, 8, **kw), ResBlock(in_ch, 8, **kw),
           (_x((2, 12, 10, in_ch), 1),), 3)


@pytest.mark.parametrize("up_type", ["pixelshuffle", "interp"])
def test_upresblock_matches_flax(up_type):
    kw = dict(actv="lrelu", actv2="igdn", up_type=up_type)
    _check(JUpResBlock(8, 8, **kw), UpResBlock(8, 8, **kw),
           (_x((2, 5, 6, 8), 2),), 4)


@pytest.mark.parametrize("family,key,shape", [
    ("cheng20", "encoder", (1, 64, 48, 3)),
    ("cheng20", "decoder", (2, 4, 3, 32)),
    ("cheng20_interp_ca", "encoder", (2, 64, 48, 3)),
    ("cheng20_interp_ca", "decoder", (2, 4, 3, 32)),
    ("cheng20", "hyperencoder", (1, 4, 4, 32)),
    ("cheng20", "hyperdecoder", (2, 1, 2, 16))])
def test_cheng20_subnets_match_flax(family, key, shape):
    opt = subnets(family)[key]
    args = (_x(shape, 5, 2.0),)
    if family == "cheng20_interp_ca":
        args += (np.asarray([0.5, 3.25], np.float32),)
    _check(jbuild(opt, key), tbuild(opt, key), args, 6,
           use_rate=family == "cheng20_interp_ca")


def test_cheng20_hyperdecoder_layouts():
    """c2 / c4 transposed (4x4, stride 2), c1 / c3 / c5 plain."""
    hd = tbuild(subnets("cheng20", tiny=False)["hyperdecoder"],
                "hyperdecoder")
    shapes = {k: tuple(v.shape) for k, v in hd.state_dict().items()}
    assert shapes["c1.weight"] == (192, 192, 3, 3)
    assert shapes["c2.weight"] == shapes["c4.weight"] == (192, 192, 4, 4)
    assert shapes["c5.weight"] == (384, 192, 3, 3)
    y = hd(torch.zeros(1, 192, 3, 5))
    assert y.shape == (1, 384, 12, 20)


@pytest.fixture(scope="module")
def models():
    return pair("cheng20")


@pytest.fixture(scope="module")
def x():
    return images(2, 64, 96, 11)


def test_cheng20_cdf_tables_match_jax(models):
    jm, pm = models
    for a, b in ((pm.codec_z, jm.codec_z), (pm.codec_y, jm.codec_y)):
        np.testing.assert_array_equal(a.quantized_cdf, b.quantized_cdf)
        np.testing.assert_array_equal(a.offset, b.offset)


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_cheng20_streams_byte_identical_and_cross_decode(models, x, wire):
    jm, pm = models
    try:
        for m in (jm, pm):
            m.opt["wire_format"] = wire
            m.opt["device_wire_lanes"] = 16
            m.codec_setup()
        port, ref = pm.compress_batch(x), jm.compress_batch(x)
        for p, j in zip(port, ref):
            assert [bytes(s) for s in p["string_list"]] == \
                [bytes(s) for s in j["string_list"]]
            assert p["pred_y_bpp"] > p["pred_z_bpp"]
        assert np.unique(np.concatenate([p["y_hat"] for p in port])).size > 8
        _, _, y_p = pm.decompress_batch([e["string_list"] for e in port])
        np.testing.assert_array_equal(y_p, np.concatenate(
            [e["y_hat"] for e in port]))
        _, _, y_pj = pm.decompress_batch([e["string_list"] for e in ref])
        _, _, y_jp = jm.decompress_batch([e["string_list"] for e in port])
        for got in (y_pj, np.asarray(y_jp)):
            np.testing.assert_allclose(got, y_p, rtol=1e-5, atol=1e-5)
        assert pm.compress(x[1:])["string_list"] == port[1]["string_list"]
    finally:
        for m in (jm, pm):
            m.opt["wire_format"] = "compressai"
            m.codec_setup()
