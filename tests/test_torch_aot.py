"""AOT serving packages of the port (``crdr_tpu_torch/runtime/aot.py``)
against the JAX package's contract (``tests/test_aot.py``), on the CPU, at
the tiny widths of ``tests/test_comp_model.py::tiny_opt`` (the flagship
class, ``tests/torch_pairs.py``'s edits and weight transfer; JAX the
oracle):

* the counterparts of ``tests/test_aot.py``: a package recorded on one
  model and loaded into a fresh one gives streams byte-identical to the
  port's live streams and to JAX's, on both wires (E1's op inside the
  device wire's ``lane_wire`` program), and the same decoded ``y_hat`` and
  image, with ``aot_hits`` on encode and on decode and no miss at the
  recorded bucket but in the data-dependent ``rans_round``; an unseen
  shape serves live; the recorder is keyed by shape;
* a package recorded on model A serves model B (other weights) with B's
  live streams: it holds no weights;
* a serving mesh of two replicas dispatches each shard through the
  package;
* K1's op inside exported Charm programs (``fused_slice_kernel`` on);
* ``torch.library.opcheck`` of K1, K2, K3 and E1's ops on CPU tensors;
  K3's backward bit-equal to autograd of its plain twin (TF32 off);
* a call on another card than the recorded one looks up the recorded
  card's key;
* the manifest, the cuda platform (exported, or skipped with its error on
  a CPU-only build), and a package entry that fails to load raises.
"""

import json
import os
import shutil

import numpy as np
import pytest

import torch

from crdr_tpu_torch.runtime import aot
from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                        load_package,
                                        record_serving_roundtrip)
from tests.test_torch_aot_gpu import OPS, gdn_backward_check, op_args
from tests.torch_pairs import (codec_kwargs, images,  # noqa: F401
                               one_torch_thread, pair, port_model,
                               tiny_config)

CLASS = "BetaCondInterpCaHyperpriorCharmModel"
WIRES = ("compressai", "device")
N, H, W = 2, 64, 64


def _set_wire(models, wire):
    for m in models:
        m.opt["wire_format"] = wire
        m.opt["device_wire_lanes"] = 16
        m.codec_setup()


def _hits(model) -> int:
    return sum(c["hits"] for c in aot_counts(model).values())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port / JAX pair, a second port model on the same weights, and one
    package recorded on the first at 2x64x64 on both wires (the wires'
    shared programs recorded once)."""
    pm, jm = pair(CLASS)
    fresh = port_model(tiny_config(CLASS))
    fresh.load_state_dict(pm.state_dict())
    ek, dk = codec_kwargs(pm)
    for wire in WIRES:
        _set_wire([pm], wire)
        record_serving_roundtrip(pm, N, H, W, rate_ind=ek["rate_ind"],
                                 beta=dk["beta"])
    path = str(tmp_path_factory.mktemp("aot") / "pkg")
    manifest = export_package(pm, path, platforms=("cpu",))
    pm._aot.recorder = None
    return pm, jm, fresh, path, manifest


@pytest.mark.parametrize("wire", WIRES)
def test_aot_roundtrip_byte_identical(setup, wire):
    pm, jm, fresh, path, manifest = setup
    assert manifest["entries"] and not manifest["skipped"], manifest
    _set_wire([pm, jm, fresh], wire)
    load_package(fresh, path)
    ek, dk = codec_kwargs(pm)
    x = images(N, H, W, seed=3)
    live, ref = pm.compress_batch(x, **ek), jm.compress_batch(x, **ek)
    before = _hits(fresh)
    got = fresh.compress_batch(x, **ek)
    assert _hits(fresh) > before, "no encode dispatch used the package"
    for a, b, j in zip(live, got, ref):
        assert a["string_list"] == b["string_list"] == \
            [bytes(s) for s in j["string_list"]]
        np.testing.assert_array_equal(a["y_hat"], b["y_hat"])
    f_live, _, y_live = pm.decompress_batch(
        [e["string_list"] for e in live], **dk)
    before = _hits(fresh)
    f_aot, _, y_aot = fresh.decompress_batch(
        [e["string_list"] for e in got], **dk)
    assert _hits(fresh) > before, "no decode dispatch used the package"
    np.testing.assert_array_equal(y_live, y_aot)
    np.testing.assert_array_equal(f_live, f_aot)
    np.testing.assert_array_equal(y_aot, np.concatenate(
        [e["y_hat"] for e in got]))
    # at the recorded bucket only the lane words' length can miss
    missed = {n for n, c in aot_counts(fresh).items() if c["misses"]}
    assert missed <= {"rans_round"}, aot_counts(fresh)
    if wire == "device":
        assert aot_counts(fresh)["lane_wire"]["hits"] > 0


def test_aot_unseen_shape_falls_back_live(setup):
    pm, _, fresh, path, _ = setup
    _set_wire([pm, fresh], "compressai")
    load_package(fresh, path)
    ek, dk = codec_kwargs(pm)
    img = images(1, 128, 128, seed=1)  # never recorded: serves live
    hits = _hits(fresh)
    enc = fresh.compress_batch(img, **ek)
    fake, _, y_hat = fresh.decompress_batch([enc[0]["string_list"]], **dk)
    assert fake.shape[1] == 128 and _hits(fresh) == hits
    assert enc[0]["string_list"] == pm.compress_batch(img, **ek)[0][
        "string_list"]
    np.testing.assert_array_equal(y_hat, enc[0]["y_hat"])


def test_aot_recorder_is_shape_keyed(setup):
    pm = setup[0]
    _set_wire([pm], "compressai")
    try:
        rec = record_serving_roundtrip(pm, 1, 64, 64)
        n1 = len(rec.entries)
        record_serving_roundtrip(pm, 1, 64, 64)  # same shape: no new entries
        assert len(rec.entries) == n1
        record_serving_roundtrip(pm, 2, 64, 64)  # new batch: new signatures
        assert len(rec.entries) > n1
    finally:
        pm._aot.recorder = None


def test_package_serves_other_weights(setup):
    """The package holds programs only: model B (another seed) served from
    A's package gives B's live streams, not A's."""
    pm, _, _, path, manifest = setup
    b_live, b_aot = (port_model(tiny_config(CLASS, seed=8)) for _ in "ab")
    _set_wire([pm, b_live, b_aot], "compressai")
    load_package(b_aot, path)
    ek, dk = codec_kwargs(pm)
    x = images(N, H, W, seed=5)
    want, got = b_live.compress_batch(x, **ek), b_aot.compress_batch(x, **ek)
    assert _hits(b_aot) > 0
    assert [e["string_list"] for e in want] == [e["string_list"] for e in got]
    assert [e["string_list"] for e in want] != \
        [e["string_list"] for e in pm.compress_batch(x, **ek)]
    _, _, y_b = b_aot.decompress_batch([e["string_list"] for e in got], **dk)
    np.testing.assert_array_equal(y_b, np.concatenate(
        [e["y_hat"] for e in want]))
    total = sum(e["bytes"] for e in manifest["entries"])
    weights = sum(t.numel() * t.element_size()
                  for t in pm.net.state_dict().values())
    assert total < len(manifest["entries"]) * weights


def test_serving_mesh_dispatches_through_the_package(setup):
    pm, _, _, path, _ = setup
    mesh = port_model(tiny_config(CLASS, serving_devices=2))
    mesh.load_state_dict(pm.state_dict())
    _set_wire([pm, mesh], "compressai")
    assert len(mesh._replicas) == 2
    load_package(mesh, path)
    ek, dk = codec_kwargs(pm)
    x = images(2 * N, H, W, seed=6)  # one recorded bucket a replica
    want, got = pm.compress_batch(x, **ek), mesh.compress_batch(x, **ek)
    assert [e["string_list"] for e in want] == [e["string_list"] for e in got]
    counts = aot_counts(mesh)
    assert counts["encode_head"]["hits"] == 2  # one a replica's shard
    begins = counts["decode_begin"]["hits"]  # the encoders' replays
    _, _, y_m = mesh.decompress_batch([e["string_list"] for e in got], **dk)
    np.testing.assert_array_equal(y_m, np.concatenate(
        [e["y_hat"] for e in want]))
    assert aot_counts(mesh)["decode_begin"]["hits"] == begins + 2


def _charm_programs(model, z_sym):
    """decode_begin and one Charm step: the K1 op's programs."""
    hm, hs, support, mu, _, _, _ = model.decode_begin(z_sym)
    sym = torch.round(mu)
    return (model.charm_step(1, hm, hs, support, sym, mu),)


def test_k1_op_inside_exported_charm_programs(tmp_path):
    """``fused_slice_kernel`` on: decode_begin and the Charm step exported
    (platforms cpu and cuda), each graph calls ``crdr::slice_transform``,
    and the package's programs equal the live ones on a fresh model."""
    opt = tiny_config(CLASS, fused_slice_kernel=True, seed=9)
    a, b = port_model(opt), port_model(opt)
    for m in (a, b):
        m.codec_setup()
    z_sym = torch.from_numpy(np.random.default_rng(0).integers(
        -3, 4, (1, 1, 1, 16)).astype(np.float32))
    a._aot.recorder = aot.AotRecorder()
    with torch.no_grad():
        _charm_programs(a, z_sym)
    path = str(tmp_path / "k1")
    man = export_package(a, path, platforms=("cpu", "cuda"))
    names = {e["name"] for e in man["entries"] if e["platform"] == "cpu"}
    assert names == {"decode_begin", "charm_uniform"}, man
    for e in man["entries"]:
        ep = torch.export.load(os.path.join(path, e["file"]))
        targets = {str(n.target) for n in ep.graph.nodes}
        assert "crdr.slice_transform.default" in targets, e["name"]
    if not torch.backends.cuda.is_built():
        assert {(s["name"], s["platform"]) for s in man["skipped"]} == \
            {(n, "cuda") for n in names}
        assert all(s["error"] for s in man["skipped"])
    load_package(b, path)
    with torch.no_grad():
        live, got = _charm_programs(a, z_sym), _charm_programs(b, z_sym)
    assert _hits(b) == 2
    for x, y in zip(torch.utils._pytree.tree_leaves(live),
                    torch.utils._pytree.tree_leaves(got)):
        assert torch.equal(x, y)


def test_manifest_and_a_broken_entry_raises(setup, tmp_path):
    pm, _, fresh, path, manifest = setup
    assert manifest["format"] == "crdr-aot-torch-v1"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["platforms"] == ["cpu"]
    assert manifest["model_class"] == CLASS
    with open(os.path.join(path, aot.MANIFEST)) as f:
        assert json.load(f) == manifest
    for e in manifest["entries"]:
        assert set(e) == {"name", "platform", "key", "file", "bytes",
                          "tensors"}
        assert os.path.getsize(os.path.join(path, e["file"])) == e["bytes"]
    names = {e["name"] for e in manifest["entries"]}
    assert {"encode_latents", "encode_head", "decode_begin", "charm_uniform",
            "quantize_slice", "replay_pack", "decode_final", "decode_image",
            "lane_wire", "rans_round"} <= names
    broken = str(tmp_path / "broken")
    shutil.copytree(path, broken)
    entry = next(e for e in manifest["entries"]
                 if e["name"] == "encode_head")
    with open(os.path.join(broken, entry["file"]), "wb") as f:
        f.write(b"not a program")
    _set_wire([fresh], "compressai")
    load_package(fresh, broken)
    ek, _ = codec_kwargs(pm)
    with pytest.raises(Exception):
        fresh.compress_batch(images(N, H, W, seed=3), **ek)


@pytest.mark.parametrize("name", OPS)
def test_opcheck_on_cpu(name):
    torch.library.opcheck(getattr(torch.ops.crdr, name).default,
                          op_args(name))


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_is_autograd_of_the_twin(inverse):
    gdn_backward_check("cpu", inverse)


def test_moved_key_moves_one_card():
    """A replica's key on cuda:1 maps to the recorded cuda:0 key: the model
    and its cuda:1 tensors move, a CPU tensor and the scalars stay."""
    key = json.dumps(["p", "cuda:1", [True], "spec",
                      [["t", [2, 3], "float32", "cuda:1"],
                       ["t", [5], "int32", "cpu"], ["py", "int", 4]]])
    want = json.dumps(["p", "cuda:0", [True], "spec",
                       [["t", [2, 3], "float32", "cuda:0"],
                        ["t", [5], "int32", "cpu"], ["py", "int", 4]]])
    assert aot._moved_key(key, "cuda:0", "cuda:1") == want
    moved_all = json.loads(aot._moved_key(key, "cpu"))
    assert moved_all[1] == "cpu" and all(
        v[3] == "cpu" for v in moved_all[4] if v[0] == "t")
