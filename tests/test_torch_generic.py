"""The generic codec (``HyperpriorModel`` on the Balle18 GDN transforms,
``config/balle18_mean_scale.yaml``) against the JAX package, on the CPU.

Weights go JAX -> port through ``export_state_dict``: the JAX importer picks
the transposed-conv layout by path and cannot take a Balle18 decoder
(``decoder.conv_N`` is a transposed conv there), so port -> JAX would carry
those weights transposed the wrong way.

The JAX init is edited the same way for both packages, in the flax tree:
every GDN's stored ``gamma`` re-drawn non-symmetric (the init ``0.1 * I``
would hide a transposed product), the last analysis conv scaled up so that
y spans several quantization bins, and the scale half of the hyper-decoder's
last bias raised so that the y Gaussian tables carry the rate.

* Balle18 encoder / decoder / hyper pair at tiny widths, and the encoder /
  decoder at full width (192 / 320) on a 64x64 image: rtol 1e-4, atol 5e-4
  (f32 convolutions sum in another order in the two frameworks, as in
  ``tests/test_torch_subnets.py``).
* The codec at tiny widths: CDF tables integer-identical, symbols
  identical, ``[header, z, y]`` byte-identical, each package decodes the
  other's streams, batch streams equal batch-1 streams.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.subnet import build_subnet as jbuild
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.subnet import build_subnet as tbuild
from crdr_tpu_torch.utils.config import Config

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "config", "balle18_mean_scale.yaml")
TINY = {"encoder": {"out_ch": 32, "main_ch": 16},
        "decoder": {"in_ch": 32, "main_ch": 16},
        "hyperencoder": {"in_ch": 32, "out_ch": 16, "main_ch": 16},
        "hyperdecoder": {"in_ch": 16, "out_ch": 64, "main_ch": 16},
        "entropy_model_z": {"channels": 16}}
TOL = dict(rtol=1e-4, atol=5e-4)
Y_GAIN, SCALE_BIAS = 40.0, 2.0


def _config(cls, tiny=True):
    cfg = cls.from_file(CONFIG)
    if tiny:
        for key, kw in TINY.items():
            for k, v in kw.items():
                cfg.subnet[key][k] = v
    return cfg


def _edit(params, seed):
    """The flax tree with the edits of the module doc (numpy, a copy)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k == "gamma":
                v = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
            elif path[-2:] == ("encoder", "conv_6"):
                v = v * Y_GAIN
            elif path[-2:] == ("hyperdecoder", "c3") and k == "bias":
                v[v.size // 2:] += SCALE_BIAS
            out[k] = v
        return out

    return walk(params)


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = []
    for _ in range(n):
        f = rng.uniform(2, 9, 3)
        imgs.append(np.stack([np.sin(f[0] * xx + 1) * np.cos(f[1] * yy),
                              np.cos(f[2] * xx * yy), np.sin(3 * yy + xx)],
                             -1))
    noise = rng.uniform(-0.1, 0.1, (n, h, w, 3))
    return np.clip(np.round((np.stack(imgs) * 0.7 + noise + 1.0) * 127.5),
                   0, 255).astype(np.uint8)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _subnet_pair(key, kind, x, tiny, seed):
    """The flax subnet's edited init and the port subnet with those weights;
    returns both outputs, NHWC."""
    opt = _config(JaxConfig, tiny).subnet[key].to_dict()
    flax = jbuild(opt, kind)
    params = _edit(jax.device_get(flax.init(jax.random.PRNGKey(seed),
                                            jnp.asarray(x))["params"]), seed)
    port = torch.nn.ModuleDict({key: tbuild(opt, kind)})
    port.load_state_dict(export_state_dict({key: params}, port, False, False))
    jy = jax.jit(lambda p, a: flax.apply({"params": p}, a))(params,
                                                            jnp.asarray(x))
    with torch.no_grad():
        ty = port[key](_nchw(x))
    return ty.numpy().transpose(0, 2, 3, 1), np.asarray(jy)


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("key,kind,shape", [
    ("encoder", "encoder", (1, 64, 48, 3)),
    ("decoder", "decoder", (2, 4, 3, 32)),
    ("hyperencoder", "hyperencoder", (1, 4, 4, 32)),
    ("hyperdecoder", "hyperdecoder", (2, 1, 2, 16))])
def test_balle18_subnets_tiny(key, kind, shape):
    t, j = _subnet_pair(key, kind, _x(shape, 1, 2.0), True, 2)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("key,kind,shape", [
    ("encoder", "encoder", (1, 64, 64, 3)),
    ("decoder", "decoder", (1, 4, 4, 320))])
def test_balle18_full_width_layers(key, kind, shape):
    t, j = _subnet_pair(key, kind, _x(shape, 3, 2.0), False, 4)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(_config(JaxConfig))
    jm.init_params(input_size=64)
    params = _edit(jax.device_get(jm.params), 7)
    jm.params = jax.device_put(params)
    jm.codec_setup()
    pm = build_comp_model(_config(Config), device="cpu")
    pm.load_state_dict(export_state_dict(params, pm.net, False, False))
    pm.codec_setup()
    return jm, pm, _images(2, 64, 96, 11)


def test_cdf_tables_match_jax(pair):
    jm, pm, _ = pair
    for a, b in ((pm.codec_z, jm.codec_z), (pm.codec_y, jm.codec_y)):
        np.testing.assert_array_equal(a.quantized_cdf, b.quantized_cdf)
        np.testing.assert_array_equal(a.cdf_length, b.cdf_length)
        np.testing.assert_array_equal(a.offset, b.offset)


@pytest.fixture(scope="module")
def streams(pair):
    jm, pm, x = pair
    return pm.compress_batch(x), jm.compress_batch(x)


def test_streams_byte_identical_to_jax(pair, streams):
    _, pm, _ = pair
    for p, j in zip(*streams):
        assert [bytes(s) for s in p["string_list"]] == \
            [bytes(s) for s in j["string_list"]]
        np.testing.assert_allclose(p["y_hat"], np.asarray(j["y_hat"]),
                                   rtol=1e-5, atol=1e-5)
        assert p["pred_y_bpp"] > p["pred_z_bpp"]  # the y tables carry it
        assert pm.header_handler.decode(p["string_list"][0]) == \
            {"img_size": (64, 96), "max_sample": int(np.abs(p["y_hat"]).max())}


def test_symbols_and_cdf_rows_identical_to_jax(pair):
    """The replay's symbols and CDF rows: the port's ``_generic_replay``
    against JAX's ``encode_head`` -> ``generic_params`` -> round(y - mean)."""
    from crdr_tpu_torch.models.codec import codec_numerics
    from crdr_tpu_torch.utils.img_utils import pad_image

    jm, pm, x = pair
    x = pad_image(x, 64)
    with codec_numerics():
        y, z_sym, _ = pm.encode_head(torch.from_numpy(x), None)
        sym, idx, *_ = pm._generic_replay(y, z_sym)
    jy, jz, _ = jm._codec_fn("encode_head")(jm.params, jnp.asarray(x), None)
    _, jmean, _, jidx = jm._codec_fn("generic_params")(jm.params, jz,
                                                      jm._table_dev)
    np.testing.assert_array_equal(z_sym.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(sym.numpy(),
                                  np.asarray(jnp.round(jy - jmean)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert np.unique(sym.numpy()).size > 8  # many symbol values are coded


def test_round_trip_and_cross_decode(pair, streams):
    jm, pm, _ = pair
    port, jx = streams
    fake, z_hat, y_hat = pm.decompress_batch([e["string_list"] for e in port])
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in port]))
    np.testing.assert_array_equal(z_hat, np.concatenate(
        [e["z_hat"] for e in port]))
    assert fake.shape == (2, 64, 96, 3) and np.isfinite(fake).all()
    for i in range(2):
        jfake, _, jy = jm.decompress(port[i]["string_list"])
        np.testing.assert_allclose(np.asarray(jy), port[i]["y_hat"],
                                   rtol=1e-5, atol=1e-5)
        # the port's codec_uint8_io output sits on the uint8 grid (half a
        # step from JAX's f32 image at most, plus the transforms' f32 noise)
        np.testing.assert_allclose(fake[i:i + 1], np.asarray(jfake),
                                   atol=0.5 / 127.5 + 1e-4, rtol=0)
        _, _, py = pm.decompress(jx[i]["string_list"])
        np.testing.assert_allclose(py, np.asarray(jx[i]["y_hat"]), rtol=1e-5,
                                   atol=1e-5)


def test_batch_streams_equal_batch_1_streams(pair, streams):
    _, pm, x = pair
    port, _ = streams
    for i in range(2):
        one = pm.compress(x[i:i + 1])
        assert one["string_list"] == port[i]["string_list"]
    _, _, y1 = pm.decompress(port[1]["string_list"])
    np.testing.assert_array_equal(y1, port[1]["y_hat"])


def test_real_bpp_within_5_percent_of_predicted(pair):
    """At 128x192 (at 64x96 the streams' fixed flush bytes alone are ~5%)."""
    e = pair[1].compress(_images(1, 128, 192, 3))
    real = sum(len(s) for s in e["string_list"][1:]) * 8 / (128 * 192)
    assert real == pytest.approx(e["pred_y_bpp"] + e["pred_z_bpp"], rel=0.05)


def test_generic_device_wire_raises(pair):
    """Named for the time the port refused the generic device wire; it
    checks that the wire is now ported: the GDN model on
    wire_format: device, each package with its default device-side lane
    encoder (the port's E1 twin on the CPU), gives JAX's bytes, decodes its
    own streams exactly and each package decodes the other's."""
    jm, pm, x = pair
    try:
        for m in (jm, pm):
            m.opt["wire_format"] = "device"
            m.opt["device_wire_lanes"] = 16
            m.codec_setup()
        assert pm.device_wire_encoder == "device"
        port, ref = pm.compress_batch(x), jm.compress_batch(x)
        for p, j in zip(port, ref):
            assert p["string_list"][2][:4] == b"CRDW"
            assert [bytes(s) for s in p["string_list"]] == \
                [bytes(s) for s in j["string_list"]]
        _, _, y_p = pm.decompress_batch([e["string_list"] for e in port])
        np.testing.assert_array_equal(y_p, np.concatenate(
            [e["y_hat"] for e in port]))
        _, _, y_pj = pm.decompress_batch([e["string_list"] for e in ref])
        _, _, y_jp = jm.decompress_batch([e["string_list"] for e in port])
        for got in (y_pj, np.asarray(y_jp)):
            np.testing.assert_allclose(got, y_p, rtol=1e-5, atol=1e-5)
    finally:
        for m in (jm, pm):
            m.opt["wire_format"] = "compressai"
            m.codec_setup()


def test_full_width_config_builds_in_both_packages():
    jm = jax_build(_config(JaxConfig, tiny=False))
    pm = build_comp_model(_config(Config, tiny=False), device="cpu")
    variables = jax.eval_shape(lambda: jm.net.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
        is_train=False))
    shapes = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(shapes)
    assert shapes["encoder.gdn_1.gamma"] == (192, 192)
    assert shapes["decoder.conv_0.weight"] == (320, 192, 5, 5)
    assert shapes["hyperdecoder.c3.weight"] == (640, 192, 3, 3)
    assert type(pm).__name__ == type(jm).__name__ == "HyperpriorModel"
