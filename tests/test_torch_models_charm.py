"""The ELIC decoders and the two Charm model classes of the port that stage 1
and stage 2 of the recipe produce (``HyperpriorCharmModel``, elic_charm;
``InterpCaHyperpriorCharmModel``, interp_ca_elic_charm) against the JAX
package, on the CPU, at tiny widths (``tests/torch_pairs.py``).

* ``ElicDecoder`` / ``ElicInterpCaDecoder``, each with the transposed-conv
  and the pixel-shuffle up-conv, against the flax modules on seeded flax
  params (exported to the port): rtol 1e-4, atol 2e-4.
* Each class on the compressai wire at ``codec_precision`` ``highest`` and
  ``default`` (both f32 on a CPU), and ``InterpCaHyperpriorCharmModel`` on
  the device wire: ``[header, z, y]`` byte-identical to JAX's (two 64x64
  images at ``highest``, one 96x128 at ``default``), each package decodes
  the other's streams, the port's own round trip is exact, and a batch-1
  stream equals its batch-2 stream.
* The stage-1 -> stage-2 handoff: ``load_state_dict``'s partial merge loads
  and keeps the same tensors as JAX's.
* All six ``config/_base_/model/*.yaml`` build in the port at full width, and
  their ``state_dict`` maps one to one onto the flax tree.
"""

import os
from glob import glob

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.importers.torch_import import _convert
from crdr_tpu.importers.torch_import import \
    map_reference_name as jax_map_name
from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.subnet import build_subnet as jbuild
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.subnet import build_subnet as tbuild
from crdr_tpu_torch.utils.config import Config
from tests.torch_pairs import (codec_kwargs, images, jax_params,  # noqa: F401
                               one_torch_thread, pair, port_model,
                               tiny_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_CONFIGS = sorted(glob(os.path.join(ROOT, "config", "_base_", "model",
                                         "*.yaml")))
# (images, H, W) by codec_precision: each class meets both sizes, and each
# case compiles the JAX codec programs of one shape only
SIZES = {"highest": (2, 64, 64), "default": (1, 96, 128)}


# ---------------- the ELIC decoders ------------------------------------------

def _seeded_tree(shapes, seed):
    """Flax params of the given shapes, drawn with numpy (a compiled flax
    init costs ~16 s a decoder on the CPU): N(0, 1 / fan_in) kernels,
    N(0, 0.1) vectors."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 \
            else 0.1
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.mark.parametrize("kind,pixel_shuffle,use_tanh", [
    ("ElicDecoder", False, False), ("ElicDecoder", True, True),
    ("ElicInterpCaDecoder", False, True), ("ElicInterpCaDecoder", True, False)])
def test_elic_decoders_match_flax(kind, pixel_shuffle, use_tanh):
    rate = kind == "ElicInterpCaDecoder"
    opt = tiny_config("InterpCaHyperpriorCharmModel" if rate else
                      "HyperpriorCharmModel", pixel_shuffle=pixel_shuffle)
    dec = opt.subnet.decoder.to_dict()
    dec["use_tanh"] = use_tanh
    assert dec["type"] == kind
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 4, 6, 32)).astype(np.float32) * 3.0
    args = (jnp.asarray([0.75, 1.5], jnp.float32),) if rate else ()
    flax = jbuild(dec, "decoder")
    params = _seeded_tree(jax.eval_shape(flax.init, jax.random.PRNGKey(5),
                                         jnp.asarray(y), *args)["params"], 5)
    port = torch.nn.ModuleDict({"decoder": tbuild(dec, "decoder")})
    port.load_state_dict(export_state_dict({"decoder": params}, port, rate,
                                           False, pixel_shuffle))
    ref = np.asarray(jax.jit(flax.apply)({"params": params}, jnp.asarray(y),
                                         *args))
    with torch.no_grad():
        out = port["decoder"](torch.from_numpy(y.transpose(0, 3, 1, 2)),
                              *(torch.from_numpy(np.array(a)) for a in args))
    assert ref.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref,
                               rtol=1e-4, atol=2e-4)


# ---------------- the two Charm classes against JAX ----------------------------

CASES = [("HyperpriorCharmModel", "compressai", "highest"),
         ("HyperpriorCharmModel", "compressai", "default"),
         ("InterpCaHyperpriorCharmModel", "compressai", "highest"),
         ("InterpCaHyperpriorCharmModel", "compressai", "default"),
         ("InterpCaHyperpriorCharmModel", "device", "highest"),
         ("InterpCaHyperpriorCharmModel", "device", "default")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def streams(request):
    """The pair of one case and both packages' streams of both sizes."""
    cls, wire, prec = request.param
    pm, jm = pair(cls, wire_format=wire, device_wire_encoder="host",
                  codec_precision=prec)
    ek, _ = codec_kwargs(pm)
    n, h, w = SIZES[prec]
    x = images(n, h, w, seed=h + n)
    out = [(x, pm.compress_batch(x, **ek), jm.compress_batch(x, **ek))]
    return pm, jm, out


def test_streams_byte_identical_to_jax(streams):
    pm, _, out = streams
    for _, port, ref in out:
        for p, j in zip(port, ref):
            assert [bytes(s) for s in p["string_list"]] == \
                [bytes(s) for s in j["string_list"]]
            np.testing.assert_allclose(p["y_hat"], np.asarray(j["y_hat"]),
                                       rtol=1e-5, atol=1e-5)
    if pm.wire_format == "device":
        assert port[0]["string_list"][2][:4] == b"CRDW"
    # the y tables carry the rate over many symbols
    assert out[0][1][0]["pred_y_bpp"] > 10 * out[0][1][0]["pred_z_bpp"]


def test_each_package_decodes_the_others_streams(streams):
    pm, jm, out = streams
    _, dk = codec_kwargs(pm)
    for _, port, ref in out:
        _, _, y_p = pm.decompress_batch([e["string_list"] for e in ref], **dk)
        np.testing.assert_allclose(y_p, np.concatenate(
            [np.asarray(e["y_hat"]) for e in ref]), rtol=1e-5, atol=1e-5)
        _, _, y_j = jm.decompress_batch([e["string_list"] for e in port], **dk)
        np.testing.assert_allclose(np.asarray(y_j), np.concatenate(
            [e["y_hat"] for e in port]), rtol=1e-5, atol=1e-5)


def test_round_trip_exact_and_batch_invariant(streams):
    pm, _, out = streams
    ek, dk = codec_kwargs(pm)
    x, port, _ = out[0]
    fake, z_hat, y_hat = pm.decompress_batch([e["string_list"] for e in port],
                                             **dk)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in port]))
    np.testing.assert_array_equal(z_hat, np.concatenate(
        [e["z_hat"] for e in port]))
    assert fake.shape == x.shape and np.isfinite(fake).all()
    one = pm.compress(x[-1:], **ek)
    assert one["string_list"] == port[-1]["string_list"]


# ---------------- stage handoff ---------------------------------------------------

def test_stage1_to_stage2_partial_load_counts_match_jax():
    """A stage-1 (elic_charm) state loaded into a stage-2
    (interp_ca_elic_charm) model: the ELIC trunk, hyper pair, bottleneck and
    Charm load, the InterpCA layers keep their init, in both packages."""
    opt1 = tiny_config("HyperpriorCharmModel", seed=1)
    opt2 = tiny_config("InterpCaHyperpriorCharmModel", seed=2)
    pm1, pm2 = port_model(opt1), port_model(opt2)
    _, params1 = jax_params(pm1, opt1)
    jm2, params2 = jax_params(pm2, opt2)
    jm2.params = jax.device_put(params2)
    said = []
    jm2.logger = type("Log", (), {"info": staticmethod(said.append)})()
    jm2.load_state_dict({"params": params1})

    counts = pm2.load_state_dict(pm1.state_dict())
    assert said == [f"partial load: {counts['loaded']} tensors loaded, "
                    f"{counts['kept']} kept at init (new modules)"]
    n_ca = sum(1 for k in pm2.state_dict() if ".interp_ca_list." in k)
    assert counts["kept"] == n_ca > 0
    assert counts["loaded"] == len(pm1.state_dict())
    # and the same values: the merged port weights are JAX's merged tree
    _, merged = jax_params(pm2, opt2)
    flat = jax.tree_util.tree_leaves_with_path
    for (path, a), (_, b) in zip(flat(merged), flat(jax.device_get(
            jm2.params))):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert pm2.codec_z is None  # the codec asks for codec_setup() again
    with pytest.raises(RuntimeError, match="codec_setup"):
        pm2.compress(images(1, 64, 64, 0), rate_ind=1.0)


# ---------------- every model config at full width -----------------------------

@pytest.mark.parametrize("cfg_path", MODEL_CONFIGS,
                         ids=[os.path.basename(p) for p in MODEL_CONFIGS])
def test_model_config_builds_at_full_width(cfg_path):
    """The port builds the config and its ``state_dict`` maps one to one, by
    JAX's ``map_reference_name``, onto the flax tree of ``jax.eval_shape``,
    with equal shapes after the layout change."""
    pm = build_comp_model(Config.from_file(cfg_path), device="cpu")
    jm = jax_build(JaxConfig.from_file(cfg_path))
    assert type(pm).__name__ == type(jm).__name__
    kw = {k: jnp.zeros((1,), jnp.float32) for k, on in
          (("rate_ind", jm.use_rate), ("beta", jm.use_beta)) if on}
    tree = jax.eval_shape(lambda: jm.net.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
        is_train=False, **kw))["params"]
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    ps = bool(pm.net.subnet_opt["decoder"].get("pixel_shuffle", False))
    mapped = {}
    for name, t in pm.state_dict().items():
        path = jax_map_name(name, pm.use_rate, pm.use_beta, ps)
        assert path in flat, f"{name} -> {path}: no flax param"
        mapped[path] = name
        moved = _convert(np.broadcast_to(np.float32(0), tuple(t.shape)),
                         flat[path], path)
        assert moved.shape == tuple(flat[path]), name
    assert len(mapped) == len(pm.state_dict()) == len(flat)
    assert sum(t.numel() for t in pm.state_dict().values()) > 1e6
