"""The HiFiC family in the port (``subnet/autoencoder/hific.py``) against
the JAX package's, on the CPU.

Weights go JAX -> port through ``export_state_dict`` (``tests/test_torch_families
.py``; the norms' and GDN-free constants jittered).  The encoder (channel
and instance norm, each activation), the residual block, the decoder
with and without noise (JAX's ``jax.random.normal`` draw passed in, NCHW),
both up layers: rtol 1e-4, atol 5e-4.  The codec: ``HyperpriorModel`` on
the HiFiC pair and the Balle18 hyper pair, ``[header, z, y]`` byte-identical
to JAX's on the compressai wire and on the device wire, each package
decoding the other's streams.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.subnet import build_subnet as jbuild
from crdr_tpu.subnet.autoencoder.hific import \
    HificResidualBlock as JResidualBlock
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.subnet import build_subnet as tbuild
from crdr_tpu_torch.subnet.autoencoder.hific import HificResidualBlock
from tests.test_torch_families import edit, nchw, nhwc, pair, subnets
from tests.torch_pairs import images, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=5e-4)


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(flax_mod, port_mod, x, seed, **apply_kw):
    params = edit(jax.device_get(flax_mod.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), **apply_kw)["params"]),
        seed)
    port = torch.nn.ModuleDict({"m": port_mod})
    port.load_state_dict(export_state_dict({"m": params}, port, False,
                                           False))
    return params, port["m"]


@pytest.mark.parametrize("activation,channel_norm", [
    ("relu", True), ("leaky_relu", False), ("elu", True)])
def test_encoder_matches_flax(activation, channel_norm):
    opt = dict(subnets("hific")["encoder"], activation=activation,
               channel_norm=channel_norm)
    x = _x((2, 48, 64, 3), 1)
    flax, port = jbuild(opt, "encoder"), tbuild(opt, "encoder")
    params, port = _pair(flax, port, x, 2)
    jy = flax.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ty = port(nchw(x))
    assert ty.shape == (2, 32, 3, 4)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), **TOL)


def test_residual_block_matches_flax():
    x = _x((2, 5, 7, 8), 3)
    params, port = _pair(JResidualBlock(8, "relu", True, False),
                         HificResidualBlock(8, "relu", True, False), x, 4)
    jy = JResidualBlock(8, "relu", True, False).apply({"params": params},
                                                      jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(jy),
                                   **TOL)


@pytest.mark.parametrize("sample_noise,pixelshuffle", [
    (False, False), (True, False), (False, True)])
def test_decoder_matches_flax(sample_noise, pixelshuffle):
    opt = dict(subnets("hific")["decoder"], sample_noise=sample_noise,
               use_pixelshuffle=pixelshuffle, noise_dim=4)
    x = _x((2, 3, 4, 32), 5)
    flax, port = jbuild(opt, "decoder"), tbuild(opt, "decoder")
    rng = jax.random.PRNGKey(9)
    kw = {"rng": rng} if sample_noise else {}
    params, port = _pair(flax, port, x, 6, **kw)
    jy = flax.apply({"params": params}, jnp.asarray(x), **kw)
    tkw = {}
    if sample_noise:
        # the noise JAX draws inside the decoder, at the head's shape
        noise = jax.random.normal(rng, (2, 3, 4, 4), jnp.float32)
        tkw["noise"] = nchw(np.asarray(noise))
    with torch.no_grad():
        ty = port(nchw(x), **tkw)
    assert ty.shape == (2, 3, 48, 64)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), **TOL)


def test_decoder_noise_needs_a_source_and_uses_the_generator():
    opt = dict(subnets("hific")["decoder"], sample_noise=True, noise_dim=4)
    dec = tbuild(opt, "decoder")
    g = torch.Generator().manual_seed(0)
    for m in dec.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    x = torch.from_numpy(_x((1, 32, 3, 4), 7))
    with pytest.raises(ValueError, match="generator"):
        dec(x)
    with torch.no_grad():
        a = dec(x, generator=torch.Generator().manual_seed(3))
        b = dec(x, generator=torch.Generator().manual_seed(3))
        c = dec(x, generator=torch.Generator().manual_seed(4))
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_full_width_state_dict_shapes():
    enc = tbuild(subnets("hific", tiny=False)["encoder"], "encoder")
    dec = tbuild(subnets("hific", tiny=False)["decoder"], "decoder")
    e, d = enc.state_dict(), dec.state_dict()
    assert e["conv_block1.weight"].shape == (60, 3, 7, 7)
    assert e["conv_block_out.weight"].shape == (220, 960, 3, 3)
    assert d["upconv_block1.deconv.weight"].shape == (960, 480, 3, 3)
    assert d["first_norm.norm.gamma"].shape == (220,)
    assert sum(k.startswith("resblock_") for k in d) == 9 * 8


@pytest.fixture(scope="module")
def models():
    return pair("hific")


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_hific_streams_byte_identical_and_cross_decode(models, wire):
    jm, pm = models
    x = images(2, 64, 96, 12)
    try:
        for m in (jm, pm):
            m.opt["wire_format"] = wire
            m.opt["device_wire_lanes"] = 16
            m.codec_setup()
        port, ref = pm.compress_batch(x), jm.compress_batch(x)
        for p, j in zip(port, ref):
            assert [bytes(s) for s in p["string_list"]] == \
                [bytes(s) for s in j["string_list"]]
        assert np.unique(np.concatenate([p["y_hat"] for p in port])).size > 8
        fake, _, y_p = pm.decompress_batch([e["string_list"] for e in port])
        np.testing.assert_array_equal(y_p, np.concatenate(
            [e["y_hat"] for e in port]))
        assert fake.shape == (2, 64, 96, 3) and np.isfinite(fake).all()
        _, _, y_pj = pm.decompress_batch([e["string_list"] for e in ref])
        _, _, y_jp = jm.decompress_batch([e["string_list"] for e in port])
        for got in (y_pj, np.asarray(y_jp)):
            np.testing.assert_allclose(got, y_p, rtol=1e-5, atol=1e-5)
        assert pm.compress(x[1:])["string_list"] == port[1]["string_list"]
    finally:
        for m in (jm, pm):
            m.opt["wire_format"] = "compressai"
            m.codec_setup()
