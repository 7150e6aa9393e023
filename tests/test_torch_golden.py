"""The port on the JAX package's own weights: the seed-7 tiny flagship
(``tests/test_bitstream_golden.py``), exported with
``crdr_tpu_torch/importers/jax_params.py``.

* the exporter round-trips through the JAX importer, exactly;
* f32 codec path (fused kernel off): the port reproduces the committed
  digests of ``tests/golden_bitstream.json``, decodes its own stream to the
  encoder's ``y_hat`` exactly and to the JAX reconstruction within 2e-3, and
  the two packages decode each other's streams;
* the same on the device wire (``device_wire_lanes: 16``, the port's host
  lane encoder): ``tests/golden_bitstream_device.json`` byte for byte, the
  JAX package's own device-wire streams, and cross-decode both ways.

One JAX init (~45 s of per-op compiles on the CPU) serves the whole file:
the device-wire JAX model takes the same params.
"""

import hashlib
import json
import os

import numpy as np
import pytest

import jax
import jax.tree_util as jtu

from crdr_tpu.importers.torch_import import import_state_dict
from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_comp_model import tiny_opt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_bitstream.json")
GOLDEN_DEVICE = os.path.join(os.path.dirname(__file__),
                             "golden_bitstream_device.json")


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(tiny_opt())
    jm.init_params(input_size=64)  # seed 7 from tiny_opt
    jm.codec_setup()
    params = jax.device_get(jm.params)
    pm = build_comp_model(ConfigDict(tiny_opt().to_dict()), device="cpu")
    state = export_state_dict(params, pm.net, use_rate=True, use_beta=True)
    pm.load_state_dict(state, strict=True)
    pm.codec_setup()
    x = np.random.default_rng(1234).uniform(-1, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    return jm, pm, params, state, x


def test_exporter_round_trips_through_the_jax_importer(pair):
    _, pm, params, state, _ = pair
    back = import_state_dict({k: v.numpy() for k, v in state.items()}, params,
                             use_rate=True, use_beta=True, strict=True)
    assert jtu.tree_structure(back) == jtu.tree_structure(params)
    for a, b in zip(jtu.tree_leaves(back), jtu.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sorted(state) == sorted(pm.state_dict())


def test_cdf_tables_match_jax(pair):
    jm, pm, *_ = pair
    for a, b in ((pm.codec_z, jm.codec_z), (pm.codec_y, jm.codec_y)):
        np.testing.assert_array_equal(a.quantized_cdf, b.quantized_cdf)
        np.testing.assert_array_equal(a.cdf_length, b.cdf_length)
        np.testing.assert_array_equal(a.offset, b.offset)


def test_port_reproduces_golden_digests(pair):
    _, pm, _, _, x = pair
    enc = pm.compress(x, rate_ind=1.0)
    s = enc["string_list"]
    digests = {"header": hashlib.sha256(s[0]).hexdigest(),
               "z": hashlib.sha256(s[1]).hexdigest(),
               "y": hashlib.sha256(s[2]).hexdigest(),
               "z_len": len(s[1]), "y_len": len(s[2])}
    with open(GOLDEN) as f:
        assert digests == json.load(f)


@pytest.fixture(scope="module")
def streams(pair):
    jm, pm, _, _, x = pair
    return pm.compress(x, rate_ind=1.0), jm.compress(x, rate_ind=1.0)


def test_port_and_jax_streams_identical(streams):
    port_enc, jax_enc = streams
    assert [bytes(s) for s in port_enc["string_list"]] == \
        [bytes(s) for s in jax_enc["string_list"]]
    np.testing.assert_allclose(port_enc["y_hat"], np.asarray(jax_enc["y_hat"]),
                               rtol=1e-5, atol=1e-5)


def test_port_round_trip_and_jax_reconstruction(pair, streams):
    jm, pm, *_ = pair
    port_enc, _ = streams
    fake, _, y_hat = pm.decompress(port_enc["string_list"], beta=1.0)
    np.testing.assert_array_equal(y_hat, port_enc["y_hat"])
    jfake, _, _ = jm.decompress(port_enc["string_list"], beta=1.0)
    np.testing.assert_allclose(fake, np.asarray(jfake), atol=2e-3, rtol=0)


def test_jax_decodes_port_stream_and_port_decodes_jax_stream(pair, streams):
    jm, pm, *_ = pair
    port_enc, jax_enc = streams
    _, _, jy = jm.decompress(port_enc["string_list"], beta=2.56)
    np.testing.assert_allclose(np.asarray(jy), port_enc["y_hat"], rtol=1e-4,
                               atol=1e-4)
    _, _, py = pm.decompress(jax_enc["string_list"], beta=2.56)
    np.testing.assert_allclose(py, np.asarray(jax_enc["y_hat"]), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def device_pair(pair):
    """Both packages on the device wire, on the seed-7 weights of ``pair``."""
    _, _, params, state, x = pair
    opt = tiny_opt()
    opt["wire_format"] = "device"
    opt["device_wire_lanes"] = 16
    jm = jax_build(opt)
    jm.params = params
    jm.codec_setup()
    popt = ConfigDict(opt.to_dict())
    popt["device_wire_encoder"] = "host"
    pm = build_comp_model(popt, device="cpu")
    pm.load_state_dict(state, strict=True)
    pm.codec_setup()
    return jm, pm, pm.compress(x, rate_ind=1.0), jm.compress(x, rate_ind=1.0)


def test_port_reproduces_device_wire_golden_digests(device_pair):
    _, pm, port_enc, jax_enc = device_pair
    s = port_enc["string_list"]
    digests = {"z": hashlib.sha256(s[1]).hexdigest(), "z_len": len(s[1]),
               "y": hashlib.sha256(s[2]).hexdigest(), "y_len": len(s[2])}
    with open(GOLDEN_DEVICE) as f:
        assert digests == json.load(f)
    assert [bytes(b) for b in s] == \
        [bytes(b) for b in jax_enc["string_list"]]
    _, z_hat, y_hat = pm.decompress(s, beta=1.0)
    np.testing.assert_array_equal(y_hat, port_enc["y_hat"])
    np.testing.assert_array_equal(z_hat, port_enc["z_hat"])


def test_device_wire_cross_decode(device_pair):
    jm, pm, port_enc, jax_enc = device_pair
    _, _, jy = jm.decompress(port_enc["string_list"], beta=2.56)
    np.testing.assert_allclose(np.asarray(jy), port_enc["y_hat"], rtol=1e-4,
                               atol=1e-4)
    _, _, py = pm.decompress(jax_enc["string_list"], beta=2.56)
    np.testing.assert_allclose(py, np.asarray(jax_enc["y_hat"]), rtol=1e-4,
                               atol=1e-4)
