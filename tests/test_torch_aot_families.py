"""AOT serving packages (``crdr_tpu_torch/runtime/aot.py``) of the two other
codec families, on the CPU against the JAX package: the checkerboard
(``tests/test_torch_checkerboard.py``'s ``cb_pair``, JAX's ``cb_opt``
widths) and the generic GDN model (``config/balle18_mean_scale.yaml`` at
``tests/test_torch_generic.py``'s tiny widths, K3's op in the transforms).

* a package recorded on one model at 2x64x64 on both wires, loaded into a
  fresh model on the same weights: streams byte-identical to the port's
  live streams and to JAX's, on each wire, decodes equal, hits on encode and
  decode, no miss at the recorded bucket but in ``rans_round``;
* the checkerboard's programs (``cb_*``), the generic ``generic_params``,
  and K3's op in the GDN model's ``encode_latents`` / ``decode_image``;
* K3's op forward and gradient through an exported GDN layer.
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.nn import GDN
from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                        load_package,
                                        record_serving_roundtrip)
from crdr_tpu_torch.utils.config import Config
from tests.test_torch_checkerboard import cb_config, cb_pair
from tests.test_torch_generic import _config, _edit
from tests.torch_pairs import (codec_kwargs, images,  # noqa: F401
                               one_torch_thread, port_model)

WIRES = ("compressai", "device")
N, H, W = 2, 64, 64
PROGRAMS = {"checkerboard": {"cb_begin", "cb_a_dev", "cb_b_dev", "cb_quant",
                             "cb_replay_pack", "cb_final"},
            "gdn": {"generic_params"}}


def _gdn_pair():
    """(port model, JAX model, a fresh port model) on the edited JAX init."""
    jm = jax_build(_config(JaxConfig))
    jm.init_params(input_size=64)
    params = _edit(jax.device_get(jm.params), 7)
    jm.params = jax.device_put(params)
    models = [build_comp_model(_config(Config), device="cpu")
              for _ in range(2)]
    for m in models:
        m.load_state_dict(export_state_dict(params, m.net, False, False))
    return models[0], jm, models[1]


def _set_wire(models, wire):
    for m in models:
        m.opt["wire_format"] = wire
        m.opt["device_wire_lanes"] = 16
        m.codec_setup()


@pytest.fixture(scope="module", params=["checkerboard", "gdn"])
def family(request, tmp_path_factory):
    if request.param == "checkerboard":
        pm, jm = cb_pair()
        fresh = port_model(cb_config())
        fresh.load_state_dict(pm.state_dict())
    else:
        pm, jm, fresh = _gdn_pair()
    ek, dk = codec_kwargs(pm)
    for wire in WIRES:
        _set_wire([pm], wire)
        record_serving_roundtrip(pm, N, H, W, rate_ind=ek.get("rate_ind", 0),
                                 beta=dk.get("beta", 0))
    path = str(tmp_path_factory.mktemp(request.param) / "pkg")
    manifest = export_package(pm, path, platforms=("cpu",))
    pm._aot.recorder = None
    assert manifest["entries"] and not manifest["skipped"], manifest
    names = {e["name"] for e in manifest["entries"]}
    assert PROGRAMS[request.param] <= names, names
    load_package(fresh, path)
    return request.param, pm, jm, fresh, path


@pytest.mark.parametrize("wire", WIRES)
def test_family_round_trip_through_a_package(family, wire):
    kind, pm, jm, fresh, path = family
    _set_wire([pm, jm, fresh], wire)
    ek, dk = codec_kwargs(pm)
    x = images(N, H, W, seed=8)
    live, ref = pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)
    got = fresh.compress_batch(x, **ek)
    for a, b, j in zip(live, got, ref):
        assert a["string_list"] == b["string_list"] == \
            [bytes(s) for s in j["string_list"]]
    hits = {n: c["hits"] for n, c in aot_counts(fresh).items()}
    assert hits["encode_latents"] and hits["encode_head"]
    f_live, _, y_live = pm.decompress_batch(
        [e["string_list"] for e in live], **dk)
    f_aot, _, y_aot = fresh.decompress_batch(
        [e["string_list"] for e in got], **dk)
    np.testing.assert_array_equal(y_live, y_aot)
    np.testing.assert_array_equal(f_live, f_aot)
    np.testing.assert_array_equal(y_aot, np.concatenate(
        [e["y_hat"] for e in got]))
    counts = aot_counts(fresh)
    assert counts["decode_image"]["hits"] > hits.get("decode_image", 0)
    for name in PROGRAMS[kind]:
        assert counts[name]["hits"] > 0, (name, counts)
    missed = {n for n, c in counts.items() if c["misses"]}
    assert missed <= {"rans_round"}, counts
    if kind == "gdn":  # three GDN in the analysis, three IGDN in the synthesis
        with open(os.path.join(path, "manifest.json")) as f:
            entries = json.load(f)["entries"]
        for e in entries:
            if e["name"] in ("encode_latents", "decode_image"):
                ep = torch.export.load(os.path.join(path, e["file"]))
                targets = [str(n.target) for n in ep.graph.nodes]
                assert targets.count("crdr.gdn.default") == 3, e["name"]


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_op_forward_and_gradient_through_an_export(inverse):
    """An exported GDN layer (training IR) holds K3's op; its forward and
    its gradient (the op's ``register_autograd``) equal the eager layer's."""
    torch.manual_seed(3)
    layer = GDN(8, inverse=inverse)
    layer.reset_parameters()
    with torch.no_grad():
        layer.gamma.add_(torch.rand(8, 8) * 0.05)
    x = torch.randn(2, 8, 5, 6)
    ep = torch.export.export(layer, (x,))
    assert "crdr.gdn.default" in {str(n.target) for n in ep.graph.nodes}
    xs = [x.clone().requires_grad_() for _ in range(2)]
    outs = [layer(xs[0]), ep.module()(xs[1])]
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    grads = [torch.autograd.grad(o.square().sum(), v)[0]
             for o, v in zip(outs, xs)]
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)
