"""The port's codec on the device wire, on the CPU (mirrors of
``tests/test_device_wire.py``).

``tiny_opt()`` in the serving configuration (``fused_slice_kernel``, bf16
transforms) with ``wire_format: device`` and ``device_wire_encoder: host``:
on the CPU the K2, K1 and E1 wrappers run their plain twins, so these hold
the device-wire codec's structure; ``chip_smoke.py`` holds it on the H100
with the kernels.  The golden digests and the cross-decode with JAX are in
``tests/test_torch_golden.py`` (Charm), ``tests/test_torch_checkerboard.py``
(checkerboard) and below (the generic family).

The device-side lane encoder (``device_wire_encoder: device``, E1): its
containers equal the host coder's for the Charm, generic and checkerboard
families (as JAX's ``test_device_encoder_matches_host_encoder``), also on
an image with more escapes than ``device_wire_fixup_cap``: E1 keeps every
escape, where JAX re-encodes such a batch on the host.
"""

import os

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models import codec_devicewire
from crdr_tpu_torch.runtime.lane_rans import unpack_lane_container
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_comp_model import tiny_opt
from tests.test_torch_codec import _smooth

DEVICE_WIRE = {"wire_format": "device", "device_wire_encoder": "host",
               "device_wire_lanes": 16}


def _opt(**kw):
    opt = ConfigDict(tiny_opt().to_dict())
    opt.update(fused_slice_kernel=True, transform_dtype="bfloat16", **kw)
    return opt


def _model(**kw):
    m = build_comp_model(_opt(**kw), device="cpu")
    # scale heads off the 0.11 bound, as in tests/test_torch_codec.py
    with torch.no_grad():
        for st in m.net.context_model.scale_slice_transforms:
            st.model[4].bias += 0.5
    m.codec_setup()
    return m


@pytest.fixture(scope="module")
def model():
    return _model(**DEVICE_WIRE)


@pytest.fixture(scope="module")
def host_wire():
    return _model()


@pytest.mark.parametrize("q", [0.0, 2.0])
def test_round_trip_is_bit_exact(model, q):
    x = _smooth(1, 64, 128, seed=11 + int(q))
    enc = model.compress(x, rate_ind=q)
    assert enc["string_list"][1][:4] == b"CRDW"  # z rides the lane format
    assert enc["string_list"][2][:4] == b"CRDW"
    fake, z_hat, y_hat = model.decompress(enc["string_list"], beta=1.28)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    np.testing.assert_array_equal(z_hat, enc["z_hat"])
    assert fake.shape == x.shape and np.isfinite(fake).all()


def test_device_wire_matches_compressai_wire(model, host_wire):
    """Same weights, both wires: the same y_hat and reconstruction."""
    x = _smooth(2, 64, 64, seed=5)
    enc_d = model.compress_batch(x, rate_ind=1.0)
    enc_c = host_wire.compress_batch(x, rate_ind=1.0)
    for d, c in zip(enc_d, enc_c):
        np.testing.assert_array_equal(d["y_hat"], c["y_hat"])
        assert d["string_list"][0] == c["string_list"][0]  # the header
        assert d["string_list"][2] != c["string_list"][2]
    fake_d, _, y_d = model.decompress_batch([e["string_list"] for e in enc_d],
                                            beta=0.64)
    fake_c, _, y_c = host_wire.decompress_batch(
        [e["string_list"] for e in enc_c], beta=0.64)
    np.testing.assert_array_equal(y_d, y_c)
    np.testing.assert_array_equal(fake_d, fake_c)


def test_batch_with_per_image_rates(model):
    x = _smooth(3, 64, 64, seed=7)
    rates = [0.0, 1.0, 2.0]
    encs = model.compress_batch(x, rate_ind=rates)
    fake, z_hat, y_hat = model.decompress_batch(
        [e["string_list"] for e in encs], beta=[0.0, 2.56, 5.12])
    assert fake.shape == (3, 64, 64, 3)
    for i, e in enumerate(encs):
        np.testing.assert_array_equal(y_hat[i], e["y_hat"][0])
        np.testing.assert_array_equal(z_hat[i], e["z_hat"][0])
        one = model.compress(x[i:i + 1], rate_ind=rates[i])
        assert one["string_list"] == e["string_list"]


def test_legacy_compressai_z(model):
    """A device-wire stream whose z is a CompressAI stream (written before z
    rode the lane format) decodes z on the host, to the same image."""
    x = _smooth(1, 64, 64, seed=15)
    enc = model.compress(x, rate_ind=1.0)
    header, z_lane, y_str = enc["string_list"]
    z_sym = np.round(enc["z_hat"] - model.codec_z.params["quantiles"][
        None, None, None, :, 0, 1]).astype(np.int32)
    legacy_z = model.codec_z.compress_symbols(z_sym)[0]
    assert legacy_z != z_lane
    fake_new, _, yh_new = model.decompress([header, z_lane, y_str], beta=0.5)
    fake_old, _, yh_old = model.decompress([header, legacy_z, y_str],
                                           beta=0.5)
    np.testing.assert_array_equal(yh_new, yh_old)
    np.testing.assert_array_equal(fake_new, fake_old)


def test_wire_mismatch_raises(model, host_wire):
    x = _smooth(1, 64, 64, seed=3)
    dev = model.compress(x, rate_ind=2.0)["string_list"]
    cai = host_wire.compress(x, rate_ind=2.0)["string_list"]
    with pytest.raises(ValueError, match="device wire"):
        host_wire.decompress(dev, beta=0.0)
    with pytest.raises(ValueError, match="device wire"):
        host_wire.decompress_batch([dev], beta=0.0)
    with pytest.raises(ValueError, match="compressai"):
        model.decompress(cai, beta=0.0)


def test_device_encoder_is_not_ported():
    """Named for the time the port refused the device-side lane encoder;
    it checks that the encoder is now ported and is the default (as in
    JAX): device_wire_encoder: device sets up, and its containers equal the
    host coder's byte for byte."""
    m = build_comp_model(_opt(wire_format="device", device_wire_lanes=16),
                         device="cpu")
    m.codec_setup()
    assert m.device_wire_encoder == "device"
    x = _smooth(2, 64, 64, seed=13)
    dev = m.compress_batch(x, rate_ind=1.0)
    m.opt["device_wire_encoder"] = "host"
    m.codec_setup()
    host = m.compress_batch(x, rate_ind=1.0)
    assert [e["string_list"] for e in dev] == [e["string_list"] for e in host]


def test_k2_rounds_per_batch_decode(model, monkeypatch):
    """One z round and one y round per slice: 11 at the flagship's 10
    slices; on the CPU the wrapper runs its twin and launches nothing."""
    calls = []
    real = codec_devicewire.lane_decode_round
    monkeypatch.setattr(codec_devicewire, "lane_decode_round",
                        lambda *a: calls.append(a[-1]) or real(*a))
    enc = model.compress_batch(_smooth(2, 64, 64, seed=9), rate_ind=1.0)
    launches = real.launches
    model.decompress_batch([e["string_list"] for e in enc], beta=1.0)
    assert len(calls) == 1 + model.num_slices
    assert real.launches == launches
    assert calls[0] == 16 and set(calls[1:]) == {4 * 4 * model.slice_ch}


def test_escapes_ride_the_fixups():
    """Symbols beyond a CDF row's range are coded as the escape slot with
    a (position, value) fixup, from a fixup buffer that starts at 1."""
    m = _model(device_wire_fixup_cap=1, **DEVICE_WIRE)
    x = _smooth(1, 64, 64, seed=2) * 40.0  # far outside the trained range
    enc = m.compress(x, rate_ind=0.0)
    assert unpack_lane_container(enc["string_list"][2])[2].size > 1
    _, _, y_hat = m.decompress(enc["string_list"], beta=0.0)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])


def test_throughput_config_runs_the_device_wire():
    """config/crdr_throughput.yaml's keys (fused_decode_loop included) with
    the device wire, as the H100 smoke run sets them."""
    from crdr_tpu_torch.utils.config import Config
    cfg = Config.from_file(os.path.join(os.path.dirname(__file__), "..",
                                        "config", "crdr_throughput.yaml"))
    assert cfg.get("fused_decode_loop") is True
    m = _model(fused_decode_loop=True, **DEVICE_WIRE)
    assert m.wire_format == "device"
    enc = m.compress(_smooth(1, 64, 64, seed=4), rate_ind=1.0)
    _, _, y_hat = m.decompress(enc["string_list"], beta=1.0)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])


# ---------------- the device-side lane encoder (E1) -------------------------

def _family_opt(family, encoder):
    """JAX's ``_ab_opt``: the tiny model of a family on the device wire,
    16 lanes."""
    if family == "generic":
        opt = tiny_opt("HyperpriorModel", charm=False, rate=False, beta=False)
    else:
        opt = tiny_opt()
    opt = ConfigDict(opt.to_dict())
    if family == "cb":
        opt["subnet"]["context_model"]["type"] = \
            "ElicCheckerboardCharmContextModel"
    opt.update(wire_format="device", device_wire_lanes=16,
               device_wire_encoder=encoder)
    return opt


@pytest.mark.parametrize("family", ["charm", "generic", "cb"])
def test_device_encoder_matches_host_encoder(family):
    rate = {} if family == "generic" else {"rate_ind": 1.0}
    x = _smooth(2, 64, 64, seed=23) * 3.0
    encs = {}
    for encoder in ("device", "host"):
        m = build_comp_model(_family_opt(family, encoder), device="cpu")
        m.codec_setup()
        assert m.device_wire_encoder == encoder
        encs[encoder] = m.compress_batch(x, **rate)
    for d, h in zip(encs["device"], encs["host"]):
        assert d["string_list"] == h["string_list"]
        assert d["pred_y_bit"] == h["pred_y_bit"]
    beta = {} if family == "generic" else {"beta": 0.5}
    _, _, y_hat = m.decompress_batch(
        [e["string_list"] for e in encs["device"]], **beta)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in encs["device"]]))


def test_device_encoder_overflow_matches_host(monkeypatch):
    """More escapes than ``device_wire_fixup_cap``: E1 keeps every escape,
    so its containers equal the host coder's (whose buffer grows) byte for
    byte, without the host coder being called, and decode exactly."""
    x = _smooth(1, 64, 64, seed=2) * 40.0  # far outside the trained range
    out = {}
    for encoder in ("host", "device"):
        m = _model(device_wire_fixup_cap=1, **dict(
            DEVICE_WIRE, device_wire_encoder=encoder))
        out[encoder] = m.compress(x, rate_ind=0.0)
        monkeypatch.setattr(codec_devicewire, "lane_encode", None)
    assert unpack_lane_container(out["host"]["string_list"][2])[2].size > 1
    assert out["device"]["string_list"] == out["host"]["string_list"]
    _, _, y_hat = m.decompress(out["device"]["string_list"], beta=0.0)
    np.testing.assert_array_equal(y_hat, out["device"]["y_hat"])


@pytest.fixture(scope="module", params=["HyperpriorModel",
                                        "BetaCondInterpCaHyperpriorModel"])
def generic_pair(request):
    """(port, JAX) tiny generic models on the device wire, each with its
    default device-side lane encoder (``tests/torch_pairs.py``)."""
    from tests.torch_pairs import pair
    return pair(request.param, wire_format="device", device_wire_lanes=16)


def test_generic_device_wire_byte_identical_to_jax(generic_pair):
    from tests.torch_pairs import codec_kwargs, images
    pm, jm = generic_pair
    ek, dk = codec_kwargs(pm)
    x = images(2, 64, 96, seed=21)
    port, ref = pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)
    for p, j in zip(port, ref):
        assert p["string_list"][2][:4] == b"CRDW"
        assert [bytes(s) for s in p["string_list"]] == \
            [bytes(s) for s in j["string_list"]]
    _, _, y_p = pm.decompress_batch([e["string_list"] for e in port], **dk)
    np.testing.assert_array_equal(y_p, np.concatenate(
        [e["y_hat"] for e in port]))
    _, _, y_pj = pm.decompress_batch([e["string_list"] for e in ref], **dk)
    _, _, y_jp = jm.decompress_batch([e["string_list"] for e in port], **dk)
    for got in (y_pj, np.asarray(y_jp)):
        np.testing.assert_allclose(got, y_p, rtol=1e-5, atol=1e-5)
    one = pm.compress(x[1:], **ek)
    assert one["string_list"] == port[1]["string_list"]
