"""The checkerboard context model (``ElicCheckerboardCharmContextModel``) of
the port against the JAX package, on the CPU, at JAX's own tiny widths
(``tests/test_checkerboard.py::cb_opt``: 4 slices of 8 channels, 2 support
slices, ``tests/torch_pairs.py``'s edits and weight transfer).

* ``anchor_mask``, ``split_checkerboard`` / ``merge_checkerboard``;
* the module's eval forward, ``forward_compress`` and per-slice decode
  methods against flax's on the same weights, inputs seeded with numpy,
  and the model's eval forward (``run_model``): rtol 1e-4, atol 2e-4 (the
  port's subnet tolerances: f32 convolutions summed in another order);
* ``pack_cb_weights`` equal to JAX's, and ``cb_phase_a`` / ``cb_phase_b`` /
  ``cb_reconstruct_last`` against JAX's (the same tolerances; their CDF
  rows equal);
* the codec at ``codec_precision: highest``: on the compressai wire and on
  the device wire (each package's default device-side lane encoder),
  ``[header, z, y]`` byte-identical to JAX's, each package decodes the
  other's streams, the port's own round trip is exact, and a batch-1 stream
  equals its batch-2 stream; the two wires give the same ``y_hat``;
* ``codec_setup`` takes the checkerboard on both wires and both encoders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.ops import cb_uniform as jcb
from crdr_tpu.subnet.context_model import checkerboard as jcheck
from crdr_tpu_torch.ops import cb_uniform as tcb
from crdr_tpu_torch.subnet.context_model import checkerboard as tcheck
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_comp_model import tiny_opt
from tests.torch_pairs import (codec_kwargs, images,  # noqa: F401
                               jax_model, one_torch_thread, port_model)

CB = {"type": "ElicCheckerboardCharmContextModel", "num_slices": 4,
      "hyper_out_ch": 64, "bottleneck_y": 32, "max_support_slices": 2}
RTOL, ATOL = 1e-4, 2e-4


def cb_config(**extra) -> ConfigDict:
    """JAX's ``cb_opt()``: the tiny flagship class with the checkerboard."""
    opt = tiny_opt().to_dict()
    opt["subnet"]["context_model"] = dict(CB)
    opt.update(extra)
    return ConfigDict(opt)


def cb_pair(**extra):
    """(port model, JAX model) on the port's edited seeded weights, both
    with the codec set up."""
    opt = cb_config(**extra)
    pm = port_model(opt)
    jm = jax_model(pm, opt)
    pm.codec_setup()
    return pm, jm


@pytest.fixture(scope="module")
def models():
    return cb_pair()


# ---------------- the module ---------------------------------------------------

def test_anchor_mask_split_and_merge_match_jax():
    np.testing.assert_array_equal(tcheck.anchor_mask(6, 8).numpy(),
                                  np.asarray(jcheck.anchor_mask(6, 8)))
    x = np.random.default_rng(0).standard_normal((2, 6, 8, 4)) \
        .astype(np.float32)
    parts_t = tcheck.split_checkerboard(torch.from_numpy(x))
    parts_j = jcheck.split_checkerboard(jnp.asarray(x))
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tcheck.merge_checkerboard(*parts_t).numpy()
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(
        back, np.asarray(jcheck.merge_checkerboard(*parts_j)))


def _latents(seed):
    """y [1, 8, 12, 32] spread over a few bins, hyper_out [1, 8, 12, 64]
    with the scale half positive, NHWC."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((1, 8, 12, 32)) * 3.0).astype(np.float32)
    h = rng.standard_normal((1, 8, 12, 64)).astype(np.float32)
    h[..., 32:] = np.abs(h[..., 32:]) + 0.5
    return y, h


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_module_matches_flax(models):
    pm, jm = models
    y, h = _latents(1)
    cm = pm.net.context_model
    with torch.no_grad():
        y_hat, lik = cm(_nchw(y), _nchw(h), pm.net.entropy_model_y)
        comp = cm.forward_compress(_nchw(y), _nchw(h),
                                   pm.net.entropy_model_y)
    ref = jm.net.apply({"params": jm.params}, jnp.asarray(y), jnp.asarray(h),
                       method=lambda n, yy, hh: n.context_model(
                           yy, hh, n.entropy_model_y, is_train=False))
    ref_c = jm.net.apply({"params": jm.params}, jnp.asarray(y),
                         jnp.asarray(h),
                         method=lambda n, yy, hh:
                         n.context_model.forward_compress(
                             yy, hh, n.entropy_model_y))
    np.testing.assert_allclose(_nhwc(y_hat), np.asarray(ref[0]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(_nhwc(lik), np.asarray(ref[1]), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(comp, ref_c):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # the per-slice decode methods, slice 2 (two support slices)
    sup = y[..., :16]
    amasked = y[..., 16:24] * np.asarray(jcheck.anchor_mask(8, 12))[
        None, :, :, None]
    with torch.no_grad():
        base_t = cm.decode_slice_base(2, _nchw(h[..., :32]),
                                      _nchw(h[..., 32:]), _nchw(sup))
        spat_t = cm.decode_slice_spatial(2, *base_t, _nchw(amasked))
        lrp_t = cm.decode_slice_lrp(2, _nchw(h[..., :32]), _nchw(sup),
                                    _nchw(y[..., 16:24]))
    ref_d = jm.net.apply(
        {"params": jm.params}, jnp.asarray(h), jnp.asarray(sup),
        jnp.asarray(amasked), jnp.asarray(y[..., 16:24]),
        method=lambda n, hh, ss, am, ys: (
            n.context_model.decode_slice_base(2, hh[..., :32], hh[..., 32:],
                                              ss),
            n.context_model.decode_slice_spatial(
                2, *n.context_model.decode_slice_base(
                    2, hh[..., :32], hh[..., 32:], ss), am),
            n.context_model.decode_slice_lrp(2, hh[..., :32], ss, ys)))
    for a, b in zip(list(base_t) + list(spat_t) + [lrp_t],
                    list(ref_d[0]) + list(ref_d[1]) + [ref_d[2]]):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    # the spatial context moves the non-anchor params only
    mu_c = _nhwc(comp[0])
    base = jm.net.apply({"params": jm.params}, jnp.asarray(h[..., :32]),
                        jnp.asarray(h[..., 32:]),
                        jnp.zeros((1, 8, 12, 0), jnp.float32),
                        method=lambda n, hm, hs, sup:
                        n.context_model.decode_slice_base(0, hm, hs, sup))
    np.testing.assert_allclose(mu_c[:, 0::2, 0::2, :8],
                               np.asarray(base[0])[:, 0::2, 0::2],
                               rtol=RTOL, atol=ATOL)
    assert np.abs(mu_c[:, 0::2, 1::2, :8]
                  - np.asarray(base[0])[:, 0::2, 1::2]).max() > 1e-3


def test_eval_forward_of_the_model_matches_jax(models):
    """``run_model(is_train=False)`` of the checkerboard class: bpp and
    y_hat against JAX's eval forward."""
    pm, jm = models
    x = images(1, 64, 64, seed=4).astype(np.float32) / 127.5 - 1.0
    out_p = pm.run_model(x, rate_ind=1.0, beta=1.28, is_train=False)
    out_j = jm.run_model(x, rate_ind=1.0, beta=1.28, is_train=False)
    np.testing.assert_allclose(out_p["y_hat"], np.asarray(out_j["y_hat"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_p["bpp"], np.asarray(out_j["bpp"]),
                               rtol=1e-4)


# ---------------- the uniform phases ---------------------------------------------

def test_packed_weights_and_phases_match_jax(models):
    pm, jm = models
    ns, sc, msup = 4, 8, 2
    packed_t = tcb.pack_cb_weights(pm.net.context_model.state_dict(), ns, sc,
                                   32, msup)
    packed_j = jcb.pack_cb_weights(jax.device_get(jm.params["context_model"]),
                                   ns, sc, 32, msup)
    assert set(packed_t) == set(packed_j)
    for k in packed_t:
        np.testing.assert_allclose(packed_t[k], packed_j[k], rtol=0,
                                   atol=1e-7, err_msg=k)
    pt = {k: torch.from_numpy(v) for k, v in packed_t.items()}
    pj = {k: jnp.asarray(v) for k, v in packed_j.items()}
    table = np.asarray(pm.codec_y.scale_table, np.float32)
    rng = np.random.default_rng(2)
    _, h = _latents(3)
    hm, hs = h[..., :32], h[..., 32:]
    support = rng.standard_normal((1, 8, 12, msup * sc)).astype(np.float32)
    sym = np.round(rng.standard_normal((1, 8, 12, sc)) * 3).astype(np.float32)
    mu = rng.standard_normal((1, 8, 12, sc)).astype(np.float32)
    sigma = np.abs(rng.standard_normal((1, 8, 12, sc))).astype(np.float32)
    t = torch.from_numpy

    for i in (0, 2, 3):
        out_t = tcb.cb_phase_a(pt, i, t(hm), t(hs), t(support.copy()),
                               t(sym), t(mu), t(sigma), t(table), 0.11, ns,
                               sc, msup)
        out_j = jcb.cb_phase_a(pj, jnp.int32(i), hm, hs, support, sym, mu,
                               sigma, jnp.asarray(table), 0.11, ns, sc, msup)
        for k, (a, b) in enumerate(zip(out_t, out_j)):
            if k == 0 and i == 0:
                continue  # JAX's y_prev at slice 0 is dead
            if k == 4:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=ATOL)
    for i in (0, 3):
        out_t = tcb.cb_phase_b(pt, i, t(sym), t(mu), t(sigma), t(table),
                               0.11)
        out_j = jcb.cb_phase_b(pj, jnp.int32(i), sym, mu, sigma,
                               jnp.asarray(table), 0.11)
        for k, (a, b) in enumerate(zip(out_t, out_j)):
            if k == 3:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=ATOL)
    last_t = tcb.cb_reconstruct_last(pt, t(hm), t(support), t(sym), t(mu),
                                     t(sigma), ns)
    last_j = jcb.cb_reconstruct_last(pj, hm, support, sym, mu, sigma, ns)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), rtol=RTOL,
                               atol=ATOL)
    # JAX's phase A at i == num_slices computes the same last slice
    full = jcb.cb_phase_a(pj, jnp.int32(ns), hm, hs, support, sym, mu, sigma,
                          jnp.asarray(table), 0.11, ns, sc, msup)[0]
    np.testing.assert_allclose(last_t.numpy(), np.asarray(full), rtol=RTOL,
                               atol=ATOL)


# ---------------- the codec against JAX -------------------------------------------

@pytest.fixture(scope="module", params=["compressai", "device"])
def streams(request, models):
    """Both packages' streams of two 64x64 images on one wire (the device
    wire with each package's default encoder, the device-side one)."""
    pm, jm = models
    for m in (pm, jm):
        m.opt["wire_format"] = request.param
        m.opt["device_wire_lanes"] = 16
        m.opt["device_wire_encoder"] = "device"
        m.codec_setup()
    x = images(2, 64, 64, seed=8)
    ek, _ = codec_kwargs(pm)
    return pm, jm, x, pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)


def test_streams_byte_identical_to_jax(streams):
    pm, _, _, port, ref = streams
    for p, j in zip(port, ref):
        assert [bytes(s) for s in p["string_list"]] == \
            [bytes(s) for s in j["string_list"]]
        np.testing.assert_allclose(p["y_hat"], np.asarray(j["y_hat"]),
                                   rtol=1e-5, atol=1e-5)
        assert p["pred_y_bit"] == pytest.approx(j["pred_y_bit"], rel=1e-5)
    assert (port[0]["string_list"][2][:4] == b"CRDW") == \
        (pm.wire_format == "device")
    assert port[0]["pred_y_bpp"] > 10 * port[0]["pred_z_bpp"]


def test_each_package_decodes_the_others_streams(streams):
    pm, jm, _, port, ref = streams
    _, dk = codec_kwargs(pm)
    _, _, y_p = pm.decompress_batch([e["string_list"] for e in ref], **dk)
    np.testing.assert_allclose(y_p, np.concatenate(
        [np.asarray(e["y_hat"]) for e in ref]), rtol=1e-5, atol=1e-5)
    _, _, y_j = jm.decompress_batch([e["string_list"] for e in port], **dk)
    np.testing.assert_allclose(np.asarray(y_j), np.concatenate(
        [e["y_hat"] for e in port]), rtol=1e-5, atol=1e-5)


def test_round_trip_exact_and_batch_invariant(streams):
    pm, _, x, port, _ = streams
    ek, dk = codec_kwargs(pm)
    fake, z_hat, y_hat = pm.decompress_batch([e["string_list"] for e in port],
                                             **dk)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in port]))
    np.testing.assert_array_equal(z_hat, np.concatenate(
        [e["z_hat"] for e in port]))
    assert fake.shape == x.shape and np.isfinite(fake).all()
    one = pm.compress(x[-1:], **ek)
    assert one["string_list"] == port[-1]["string_list"]
    _, _, y1 = pm.decompress(port[-1]["string_list"], **dk)
    np.testing.assert_array_equal(y1, port[-1]["y_hat"])


def test_both_wires_give_the_same_y_hat(models):
    pm, _ = models
    x = images(1, 64, 128, seed=12)
    y = {}
    for wire in ("compressai", "device"):
        pm.opt["wire_format"] = wire
        pm.codec_setup()
        enc = pm.compress(x, rate_ind=0.5)
        _, _, y[wire] = pm.decompress(enc["string_list"], beta=2.0)
        np.testing.assert_array_equal(y[wire], enc["y_hat"])
    np.testing.assert_array_equal(y["compressai"], y["device"])


@pytest.mark.parametrize("wire,encoder", [("compressai", "device"),
                                          ("device", "device"),
                                          ("device", "host")])
def test_codec_setup_takes_the_checkerboard(wire, encoder):
    pm = port_model(cb_config(wire_format=wire, device_wire_encoder=encoder))
    pm.codec_setup()
    assert pm._is_checkerboard and pm.device_wire_encoder == encoder
    assert pm._packed["spat_w"].shape == (4, 5, 5, 8, 16)
