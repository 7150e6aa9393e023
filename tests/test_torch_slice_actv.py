"""The SliceTransform's ``actv`` (``slice_transform_kwargs: {actv: gelu |
lrelu}``) in the port against the JAX package, on the CPU, at tiny widths
(``tests/torch_pairs.py``; the checkerboard at JAX's ``cb_opt`` widths).

* The activations: ``gelu`` is flax's and ``jax.nn.gelu``'s default, the
  tanh approximation (not the erf form), ``lrelu`` has slope 0.2;
  ``SliceTransform`` against flax's on seeded weights (rtol 1e-4, atol
  2e-4, the port's subnet tolerances).
* The Charm flagship class and the checkerboard with each activation on
  both wires: ``[header, z, y]`` byte-identical to JAX's, each package
  decodes the other's streams, the port's own round trip is exact.
* The training forwards (Charm and checkerboard), loss and gradients
  against ``jax.value_and_grad`` (``tests/test_torch_train_forward.py``'s
  check and tolerances).
* K1 runs only for ReLU, as JAX's Pallas kernel: with ``gelu`` / ``lrelu``
  and ``fused_slice_kernel`` the chain takes the plain convolutions and
  never calls ``slice_transform``; the codec keeps no bf16 kernel stacks
  and gives the streams of the unfused chain.
* An AOT package of a ``gelu`` model serves its live streams, and a model
  of another activation does not take its programs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.subnet.context_model.charm import \
    SliceTransform as FlaxSliceTransform
from crdr_tpu_torch.ops import charm_uniform
from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                        load_package,
                                        record_serving_roundtrip)
from crdr_tpu_torch.subnet.context_model.charm import (SliceTransform,
                                                       activation)
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_torch_checkerboard import cb_config
from tests.test_torch_train_forward import _models, check_training_forward
from tests.torch_pairs import (codec_kwargs, images, jax_model,  # noqa: F401
                               one_torch_thread, port_model, tiny_config)

ACTVS = ("gelu", "lrelu")
RTOL, ATOL = 1e-4, 2e-4
FLAGSHIP = "BetaCondInterpCaHyperpriorCharmModel"


def with_actv(opt: ConfigDict, actv: str, **extra) -> ConfigDict:
    d = opt.to_dict()
    d["subnet"]["context_model"]["slice_transform_kwargs"] = {"actv": actv}
    d.update(extra)
    return ConfigDict(d)


def family_config(family: str, actv: str, **extra) -> ConfigDict:
    base = tiny_config(FLAGSHIP) if family == "charm" else cb_config()
    return with_actv(base, actv, **extra)


def actv_pair(opt: ConfigDict):
    pm = port_model(opt)
    jm = jax_model(pm, opt)
    pm.codec_setup()
    return pm, jm


# ---------------- the module ----------------------------------------------------

def test_activations_are_jaxs():
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    t = torch.from_numpy(x)
    gelu = activation("gelu")(t).numpy()
    np.testing.assert_allclose(gelu, np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    exact = torch.nn.functional.gelu(t).numpy()
    assert np.abs(gelu - exact).max() > 1e-4  # not the erf form
    np.testing.assert_array_equal(
        activation("lrelu")(t).numpy(),
        np.asarray(jax.nn.leaky_relu(x, 0.2)))
    np.testing.assert_array_equal(activation("relu")(t).numpy(),
                                  np.maximum(x, 0))
    with pytest.raises(ValueError, match="swish"):
        SliceTransform(8, 4, "swish")


@pytest.mark.parametrize("actv", ACTVS)
def test_slice_transform_matches_flax(actv):
    rng = np.random.default_rng(len(actv))
    x = rng.standard_normal((2, 6, 7, 24)).astype(np.float32)
    flax = FlaxSliceTransform(16, actv=actv)
    shapes = jax.eval_shape(flax.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(  # N(0, 1 / fan_in) kernels
        lambda s: (rng.standard_normal(s.shape) * (
            1 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1
            else 0.1)).astype(np.float32), shapes)
    port = SliceTransform(24, 16, actv)
    with torch.no_grad():
        for tag in ("0", "2", "4"):
            p = params[f"model_{tag}"]
            conv = port.model[int(tag)]
            conv.weight.copy_(torch.from_numpy(
                np.asarray(p["weight"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    ref = np.asarray(flax.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=RTOL,
                               atol=ATOL)


# ---------------- the codec against JAX ----------------------------------------

CASES = [(f, a) for f in ("charm", "checkerboard") for a in ACTVS]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def pairs(request):
    family, actv = request.param
    return actv_pair(family_config(family, actv, device_wire_lanes=16))


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_streams_byte_identical_and_cross_decode(pairs, wire):
    pm, jm = pairs
    for m in (pm, jm):
        m.opt["wire_format"] = wire
        m.codec_setup()
    ek, dk = codec_kwargs(pm)
    x = images(2, 64, 64, seed=11)
    port, ref = pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)
    for p, j in zip(port, ref):
        assert p["string_list"] == [bytes(s) for s in j["string_list"]]
    if wire == "device":
        assert port[0]["string_list"][2][:4] == b"CRDW"
    assert port[0]["pred_y_bpp"] > 10 * port[0]["pred_z_bpp"]
    y_port = np.concatenate([e["y_hat"] for e in port])
    _, _, y_p = pm.decompress_batch([e["string_list"] for e in ref], **dk)
    _, _, y_j = jm.decompress_batch([e["string_list"] for e in port], **dk)
    np.testing.assert_array_equal(y_p, y_port)  # exact round trip
    np.testing.assert_allclose(np.asarray(y_j), y_port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family,actv", CASES)
def test_training_forward_loss_and_gradients_match_jax(family, actv):
    check_training_forward(*_models(
        "charm" if family == "charm" else "checkerboard", actv))


# ---------------- K1 runs for ReLU only ----------------------------------------

def test_fused_chain_takes_the_plain_convs_for_other_activations(
        monkeypatch):
    calls = []

    def k1(*args):
        calls.append(args)
        return torch.zeros(())

    monkeypatch.setattr(charm_uniform, "slice_transform", k1)
    pm = port_model(family_config("charm", "relu"))
    pm.codec_setup()
    packed = pm._packed
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (1, 4, 4, packed["mean0_w"].shape[3])).astype(np.float32))
    for actv in ACTVS:
        fused = charm_uniform._slice_transform(packed, "mean", 1, x, True,
                                               actv)
        plain = charm_uniform._slice_transform(packed, "mean", 1, x, False,
                                               actv)
        torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    assert not calls
    charm_uniform._slice_transform(
        {**packed, **charm_uniform.kernel_stacks(packed)}, "mean", 1, x,
        True, "relu")
    assert len(calls) == 1  # the ReLU chain does take K1

    calls.clear()
    for family in ("charm", "checkerboard"):
        opts = [family_config(family, "gelu", fused_slice_kernel=f)
                for f in (True, False)]
        models = []
        for opt in opts:
            m = port_model(opt)
            m.codec_setup()
            models.append(m)
        fused, plain = models
        plain.load_state_dict(fused.state_dict())
        plain.codec_setup()
        assert fused.fused_slice_kernel and fused.slice_actv == "gelu"
        assert not any(k.endswith("_wk") for k in fused._packed)
        ek, _ = codec_kwargs(fused)
        x = images(1, 64, 64, seed=4)
        a, b = fused.compress_batch(x, **ek), plain.compress_batch(x, **ek)
        assert a[0]["string_list"] == b[0]["string_list"]
    assert not calls


# ---------------- an AOT package of a gelu model --------------------------------

def _hits(model) -> int:
    return sum(c["hits"] for c in aot_counts(model).values())


def test_aot_package_of_a_gelu_model(tmp_path):
    pm, jm = actv_pair(family_config("charm", "gelu"))
    ek, dk = codec_kwargs(pm)
    record_serving_roundtrip(pm, 2, 64, 64, rate_ind=ek["rate_ind"],
                             beta=dk["beta"])
    path = str(tmp_path / "pkg")
    manifest = export_package(pm, path, platforms=("cpu",))
    pm._aot.recorder = None
    assert manifest["entries"] and not manifest["skipped"], manifest
    fresh = port_model(family_config("charm", "gelu"))
    fresh.load_state_dict(pm.state_dict())
    fresh.codec_setup()
    load_package(fresh, path)
    x = images(2, 64, 64, seed=3)
    live, ref = pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)
    got = fresh.compress_batch(x, **ek)
    assert _hits(fresh) > 0
    for a, b, j in zip(live, got, ref):
        assert a["string_list"] == b["string_list"] == \
            [bytes(s) for s in j["string_list"]]
    before = _hits(fresh)
    f_aot, _, y_aot = fresh.decompress_batch(
        [e["string_list"] for e in got], **dk)
    assert _hits(fresh) > before
    f_live, _, y_live = pm.decompress_batch(
        [e["string_list"] for e in live], **dk)
    np.testing.assert_array_equal(y_aot, y_live)
    np.testing.assert_array_equal(f_aot, f_live)

    # the same weights under ReLU: the package's programs traced gelu
    relu = port_model(family_config("charm", "relu"))
    relu.load_state_dict(pm.state_dict())
    relu.codec_setup()
    load_package(relu, path)
    relu.compress_batch(x, **ek)
    counts = aot_counts(relu)
    for name in ("charm_uniform", "decode_begin", "replay_pack"):
        assert counts[name]["hits"] == 0 and counts[name]["misses"] > 0
