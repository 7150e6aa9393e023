"""The port's serving stack on the CPU: the micro-batcher against the JAX
package's, the HTTP server, the serve CLIs, in-memory PNG, and the refusals.

* The batcher cases of ``tests/test_serving.py`` (coalescing, the lone
  request's window, grouping by shape and kind, mixed-beta vectors, errors
  reaching every waiter, buckets, ``max_batch``, the fixed default for an
  unset cond, a cancelled future), each run on both packages'
  ``MicroBatcher`` with the same request script and fake model: the same
  dispatch sequence from each, asserted call by call.
* The tiny flagship pair (``tests/torch_pairs.py::pair``) behind each
  package's ``MicroBatcher``, with the same images and mixed ``q`` /
  ``beta``: ``.bin``s byte-identical (so the quantized symbols are too);
  ``y_hat`` (symbols + mu) within 1e-5, the bound of
  ``tests/test_torch_models_charm.py``, since mu's last bits come from
  each package's own convs; the decoded uint8 images within one level, since the two
  packages run the synthesis convs in different libraries (the float bound
  of ``tests/test_torch_golden.py``, atol 2e-3, is half a level).  Under the
  serving config's options (K1, bf16 transforms) the packages' streams
  differ and do not cross-decode: a measured limit.
* The port's HTTP server on the tiny port model at ``device='cpu'``:
  concurrent compresses coalesce, each ``.bin`` is ``compress_batch`` of the
  image alone, each served PNG decodes (``decode_png`` and PIL) to the
  stream's own decode, a JPEG body (EXIF orientation 6, which PIL does not
  apply) is served as the stream of PIL's pixels, a malformed ``.bin`` and
  a malformed JPEG get a 400 and the connection keeps serving, keep-alive survives a 404 with a body,
  ``/healthz`` answers JSON; on both wires a corrupt y string beside a
  good one in a dispatch: garbage decoded, or a 400 that the dispatch's
  requests share, and the good stream served after.
* ``cli/serve.py::build_model`` from a config file (``--wire device -d
  cpu``), ``cli/serve_smoke.py`` at ``-d cpu``; ``cli/export_serving.py``
  at ``-d cpu``, then ``build_model`` with ``--aot_package`` serving from
  the package; a serving mesh of more GPUs than the machine has raises.
* ``encode_png`` / ``decode_png``: round trip, and cv2's (and PIL's) reads.
"""

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import cv2
from PIL import Image

from crdr_tpu.serving.batcher import MicroBatcher as JaxBatcher
from crdr_tpu_torch.cli import export_serving
from crdr_tpu_torch.cli import serve as serve_cli
from crdr_tpu_torch.cli import serve_smoke
from crdr_tpu_torch.runtime.aot import aot_counts
from crdr_tpu_torch.serving import MicroBatcher as PortBatcher
from crdr_tpu_torch.serving.http_server import make_server
from crdr_tpu_torch.utils.codec_utils import (pack_byte_strings,
                                              unpack_byte_strings)
from crdr_tpu_torch.utils.img_utils import (decode_png, encode_png,
                                            tensor_to_uint8)
from tests.test_serving import FakeModel, _container
from tests.torch_pairs import (BETA, images, one_torch_thread,  # noqa: F401
                               pair, port_model, tiny_config)

BATCHERS = {"jax": JaxBatcher, "port": PortBatcher}
IMG8 = np.zeros((8, 8, 3), np.uint8)


def _calls(model):
    """``model.calls`` with conditioning vectors as lists (comparable)."""
    return [(k, s, c.tolist() if isinstance(c, np.ndarray) else c)
            for k, s, c in model.calls]


# ---------------- the batcher: one request script, both packages ----------------

def case_coalesce(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=4, max_wait_s=0.25)
    futs = [b.submit_compress(IMG8, rate_ind=1.0) for _ in range(4)]
    outs = [f.result(timeout=10) for f in futs]
    b.close()
    assert [o["string_list"][2] for o in outs] == [b"y0", b"y1", b"y2", b"y3"]
    st = b.stats()
    assert st["batches"] == 1 and st["batch_hist"] == {4: 1}
    return model  # uniform conditioning collapses to a scalar


def case_lone_window(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=8, max_wait_s=0.05)
    t0 = time.perf_counter()
    b.compress(IMG8, rate_ind=0.0)
    assert time.perf_counter() - t0 < 5.0
    b.close()
    assert b.stats()["batch_hist"] == {1: 1}
    return model


def case_shape_and_kind(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=8, max_wait_s=0.2)
    futs = [b.submit_compress(IMG8, 0.0),
            b.submit_compress(np.zeros((16, 8, 3), np.uint8), 0.0),
            b.submit_compress(IMG8, 2.0),
            b.submit_decompress(_container(), beta=1.0)]
    for f in futs:
        f.result(timeout=10)
    b.close()
    return model


def case_mixed_beta(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=4, max_wait_s=0.25)
    futs = [b.submit_decompress(_container(), beta=v) for v in (0.0, 2.56)]
    imgs = [f.result(timeout=10) for f in futs]
    b.close()
    assert all(i.dtype == np.uint8 and i.shape == (8, 8, 3) for i in imgs)
    return model


def case_errors(Batcher):
    model = FakeModel(fail=True)
    b = Batcher(model, max_batch=4, max_wait_s=0.2)
    futs = [b.submit_compress(IMG8, 0.0) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            f.result(timeout=10)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit_compress(IMG8, 0.0)
    return model


def case_buckets(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=8, max_wait_s=0.25)
    assert b.batch_buckets == [1, 2, 4, 8]
    futs = [b.submit_compress(IMG8, 0.0) for _ in range(6)]
    for f in futs:
        f.result(timeout=10)
    b.close()
    b2 = Batcher(FakeModel(), max_batch=6, max_wait_s=0.01)
    assert b2.batch_buckets == [1, 2, 4, 6]
    b2.close()
    return model


def case_max_batch(Batcher):
    model = FakeModel(dispatch_sleep=0.05)
    b = Batcher(model, max_batch=2, max_wait_s=0.2)
    futs = [b.submit_compress(IMG8, 0.0) for _ in range(5)]
    for f in futs:
        f.result(timeout=10)
    b.close()
    return model


def case_unset_cond(Batcher):
    model = FakeModel()
    b = Batcher(model, max_batch=4, max_wait_s=0.2)
    b.compress(IMG8)  # alone: 0.0 reaches the model, never None
    futs = [b.submit_compress(IMG8, 2.0), b.submit_compress(IMG8, None)]
    for f in futs:
        f.result(timeout=10)
    b.close()
    return model


def case_cancelled(Batcher):
    model = FakeModel(dispatch_sleep=0.1)
    b = Batcher(model, max_batch=4, max_wait_s=0.2)
    futs = [b.submit_compress(IMG8, 0.0) for _ in range(3)]
    futs[0].cancel()  # a pending future: the cancel always wins here
    assert futs[1].result(timeout=10)["string_list"][2] == b"y1"
    assert futs[2].result(timeout=10)["string_list"][2] == b"y0"
    b.close()
    return model


# the dispatch sequence each script must make, in either package
CASES = {
    "coalesce": (case_coalesce, [("c", (4, 8, 8, 3), 1.0)]),
    "lone_window": (case_lone_window, [("c", (1, 8, 8, 3), 0.0)]),
    "shape_and_kind": (case_shape_and_kind, [
        ("c", (2, 8, 8, 3), [0.0, 2.0]), ("c", (1, 16, 8, 3), 0.0),
        ("d", 1, 1.0)]),
    "mixed_beta": (case_mixed_beta, [("d", 2, [0.0, 2.559999942779541])]),
    "errors": (case_errors, [("c", (2, 8, 8, 3), 0.0),
                             ("c", (1, 8, 8, 3), 0.0)]),
    "buckets": (case_buckets, [("c", (4, 8, 8, 3), 0.0),
                               ("c", (2, 8, 8, 3), 0.0)]),
    "max_batch": (case_max_batch, [("c", (2, 8, 8, 3), 0.0)] * 2
                  + [("c", (1, 8, 8, 3), 0.0)]),
    "unset_cond": (case_unset_cond, [("c", (1, 8, 8, 3), 0.0),
                                     ("c", (2, 8, 8, 3), [2.0, 0.0])]),
    "cancelled": (case_cancelled, [("c", (2, 8, 8, 3), 0.0),
                                   ("c", (1, 8, 8, 3), 0.0)]),
}


@pytest.mark.parametrize("package", sorted(BATCHERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_batcher_dispatches_as_jax(case, package):
    script, want = CASES[case]
    assert _calls(script(BATCHERS[package])) == want


def test_batcher_rejects_bad_arguments():
    with pytest.raises(ValueError, match="max_batch"):
        PortBatcher(FakeModel(), max_batch=0)
    with pytest.raises(ValueError, match="bucket 1"):
        PortBatcher(FakeModel(), max_batch=4, batch_buckets=[2, 4])
    b = PortBatcher(FakeModel())
    with pytest.raises(ValueError, match="one"):
        b.submit_compress(np.zeros((1, 8, 8, 3), np.uint8))
    b.close()


# ---------------- the tiny pair behind both batchers -----------------------------

QS = [0.0, 1.5, 2.0, 1.5]
BETAS = [0.0, 1.28, BETA, BETA]


def _serve_script(Batcher, model, imgs):
    """Four concurrent compresses (mixed q), then four concurrent
    decompresses of their streams (mixed beta), through one batcher."""
    b = Batcher(model, max_batch=4, max_wait_s=5.0)
    try:
        encs = [f.result(timeout=300) for f in
                [b.submit_compress(im, q) for im, q in zip(imgs, QS)]]
        decs = [f.result(timeout=300) for f in
                [b.submit_decompress(e["string_list"], bt)
                 for e, bt in zip(encs, BETAS)]]
        hist = b.stats()["batch_hist"]
    finally:
        b.close()
    return encs, decs, hist


def test_tiny_pair_through_both_batchers():
    pm, jm = pair("BetaCondInterpCaHyperpriorCharmModel")
    imgs = images(4, 64, 64, seed=11)
    p_encs, p_decs, p_hist = _serve_script(PortBatcher, pm, imgs)
    j_encs, j_decs, j_hist = _serve_script(JaxBatcher, jm, imgs)
    assert p_hist == j_hist == {4: 2}  # one mixed dispatch of each kind
    for pe, je in zip(p_encs, j_encs):
        assert pe["string_list"] == je["string_list"]
        np.testing.assert_allclose(pe["y_hat"], np.asarray(je["y_hat"]),
                                   rtol=1e-5, atol=1e-5)
    for i, (pd, jd) in enumerate(zip(p_decs, j_decs)):
        assert pd.dtype == jd.dtype == np.uint8 and pd.shape == jd.shape
        diff = np.abs(pd.astype(np.int16) - jd.astype(np.int16)).max()
        assert diff <= 1, f"image {i}: {diff} levels apart"
        # the port's served image is its decode of that stream alone (the
        # synthesis runs at a fixed batch with a beta row per image); JAX's
        # may differ from its own by a level, from its mixed-beta batch
        fake, _, _ = pm.decompress(p_encs[i]["string_list"], beta=BETAS[i])
        np.testing.assert_array_equal(pd, tensor_to_uint8(fake[0]))


def test_serving_config_streams_do_not_cross_packages():
    """The serving config's options (``crdr_throughput.yaml``: K1, bf16
    transforms) on the tiny pair.  On a CPU the JAX package runs the fused
    SliceTransform as plain f32 convs (``crdr_tpu/ops/charm_uniform.py``),
    the port as K1's bf16 twin: each package's own round trip is exact, but
    the streams differ and each package decodes the other's into other
    symbols.  A measured limit (ROADMAP.md, Queue 1 item 3): streams of
    this config are not interchangeable between the packages."""
    pm, jm = pair("BetaCondInterpCaHyperpriorCharmModel",
                  fused_slice_kernel=True, transform_dtype="bfloat16",
                  transform_precision="default")
    imgs = images(2, 64, 64, seed=3)
    p_enc = pm.compress_batch(imgs, rate_ind=1.5)
    j_enc = jm.compress_batch(imgs, rate_ind=1.5)
    p_y = np.concatenate([e["y_hat"] for e in p_enc])
    j_y = np.concatenate([np.asarray(e["y_hat"]) for e in j_enc])
    for model, encs, own in ((pm, p_enc, p_y), (jm, j_enc, j_y)):
        _, _, y_hat = model.decompress_batch([e["string_list"] for e in encs],
                                             beta=BETA)
        np.testing.assert_array_equal(np.asarray(y_hat), own)
    assert all(a["string_list"] != b["string_list"]
               for a, b in zip(p_enc, j_enc))
    _, _, y_pj = pm.decompress_batch([e["string_list"] for e in j_enc],
                                     beta=BETA)
    _, _, y_jp = jm.decompress_batch([e["string_list"] for e in p_enc],
                                     beta=BETA)
    assert np.abs(y_pj - j_y).max() >= 0.5  # a symbol apart, at least
    assert np.abs(np.asarray(y_jp) - p_y).max() >= 0.5


# ---------------- the HTTP server on the tiny port model -------------------------

@pytest.fixture(scope="module")
def tiny_model():
    model = port_model(tiny_config("BetaCondInterpCaHyperpriorCharmModel"))
    model.codec_setup()
    return model


def _start(model, **kw):
    srv = make_server(model, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_http_end_to_end_tiny_model(tiny_model):
    model = tiny_model
    imgs = images(3, 64, 64, seed=5)
    srv, base = _start(model, max_batch=4, max_wait_s=2.0)
    try:
        results = [None] * 3

        def one(i, q):
            results[i] = _post(base + f"/compress?q={q}",
                               encode_png(imgs[i]))

        threads = [threading.Thread(target=one, args=(i, q))
                   for i, q in enumerate((0.0, 1.0, 2.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert max(srv.batcher.stats()["batch_hist"]) >= 2
        for i, (status, headers, blob) in enumerate(results):
            assert status == 200 and headers["X-CRDR-Wire"] == "compressai"
            assert float(headers["X-CRDR-BPP"]) == pytest.approx(
                len(blob) * 8 / (64 * 64))
            alone = model.compress(imgs[i:i + 1], rate_ind=float(i))
            assert unpack_byte_strings(blob) == alone["string_list"]

            status, headers, png = _post(base + f"/decompress?beta={BETA}",
                                         blob)
            assert status == 200 and headers["Content-Type"] == "image/png"
            fake, _, _ = model.decompress(alone["string_list"], beta=BETA)
            direct = tensor_to_uint8(fake[0])
            np.testing.assert_array_equal(decode_png(png), direct)
            np.testing.assert_array_equal(
                np.asarray(Image.open(io.BytesIO(png)).convert("RGB")),
                direct)

        info = _get_json(base + "/healthz")
        assert info["status"] == "ok" and info["devices"] == ["cpu"]
        assert info["model"] == "BetaCondInterpCaHyperpriorCharmModel"
        assert info["batcher"]["requests"] == 6
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/decompress", b"\x01\x02")  # truncated container
        assert e.value.code == 400
        assert _get_json(base + "/stats")["status"] == "ok"
    finally:
        srv.shutdown()
    assert srv.batcher.stats()["queued"] == 0


def test_http_serves_a_jpeg_body(tiny_model):
    img = images(1, 64, 48, seed=9)[0]
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90, exif=exif.tobytes())
    body = buf.getvalue()
    pixels = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    assert pixels.shape == img.shape  # PIL leaves the orientation alone
    srv, base = _start(tiny_model, max_wait_s=0.01)
    try:
        status, headers, blob = _post(base + "/compress?q=1", body)
    finally:
        srv.shutdown()
    assert status == 200
    alone = tiny_model.compress(pixels[None], rate_ind=1.0)
    assert unpack_byte_strings(blob) == alone["string_list"]


@pytest.mark.parametrize("first,status,msg", [
    (("POST", "/no_such_route", b"X" * 4096), 404, "no route"),
    (("POST", "/compress?q=1", b"\xff\xd8\xff\xe0" + b"J" * 512), 400,
     "truncated data"),
    (("POST", "/compress?q=1", b"FORM" + b"G" * 64), 400, "not a PNG"),
])
def test_http_keepalive_after_an_error(tiny_model, first, status, msg):
    """An error response drains the body, so the next request on the same
    keep-alive connection is served."""
    srv, _ = _start(tiny_model, max_wait_s=0.01)
    try:
        conn = http.client.HTTPConnection(*srv.server_address, timeout=60)
        method, path, body = first
        conn.request(method, path, body=body)
        r1 = conn.getresponse()
        assert r1.status == status
        assert msg in json.loads(r1.read())["error"]
        conn.request("POST", "/compress?q=2",
                     body=encode_png(images(1, 64, 64, seed=2)[0]))
        r2 = conn.getresponse()
        assert r2.status == 200 and len(r2.read()) > 0
        conn.request("GET", "/healthz")
        r3 = conn.getresponse()
        assert r3.status == 200 and json.loads(r3.read())["status"] == "ok"
        conn.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_http_corrupt_y_string_beside_a_good_one(wire):
    """A .bin whose header and z string parse and whose y string is corrupt,
    sent with a good stream so that both share one dispatch.  Its second
    half flipped, it decodes to garbage (rANS does not notice) and the good
    stream still decodes to its own image; cut to 3 bytes, the decode
    raises and both requests get that 400 (the JAX package's rule: a failed
    dispatch fails each of its requests).  The server then serves the good
    stream alone."""
    model = port_model(tiny_config("BetaCondInterpCaHyperpriorCharmModel"))
    model.opt["wire_format"] = wire
    model.codec_setup()
    imgs = images(2, 64, 64, seed=11)
    good, other = (model.compress(imgs[i:i + 1], rate_ind=1.0)["string_list"]
                   for i in range(2))
    y = other[2]
    flipped = pack_byte_strings(other[:2] + [
        y[:len(y) // 2] + bytes(b ^ 0x5A for b in y[len(y) // 2:])])
    cut = pack_byte_strings(other[:2] + [y[:3]])
    direct = tensor_to_uint8(model.decompress(good, beta=BETA)[0][0])
    url = f"/decompress?beta={BETA}"
    srv, base = _start(model, max_batch=2, max_wait_s=2.0)
    try:
        def together(bad):
            out = {}

            def send(name, body):
                try:
                    out[name] = _post(base + url, body)
                except urllib.error.HTTPError as e:
                    out[name] = (e.code, {}, e.read())

            threads = [threading.Thread(target=send, args=a) for a in
                       (("bad", bad), ("good", pack_byte_strings(good)))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
                assert not t.is_alive()
            return out["bad"], out["good"]

        (s_bad, _, _), (s_good, _, png) = together(flipped)
        assert s_bad == 200 and s_good == 200
        np.testing.assert_array_equal(decode_png(png), direct)
        (s_bad, _, b_bad), (s_good, _, b_good) = together(cut)
        assert s_bad == 400 and s_good == 400
        assert json.loads(b_good) == json.loads(b_bad)
        assert srv.batcher.stats()["batch_hist"] == {2: 2}
        status, _, png = _post(base + url, pack_byte_strings(good))
        assert status == 200
        np.testing.assert_array_equal(decode_png(png), direct)
    finally:
        srv.shutdown()
    assert srv.batcher.stats()["queued"] == 0


# ---------------- the serve CLIs and the refusals --------------------------------

def _config_file(tmp_path, **extra):
    cfg = tiny_config("BetaCondInterpCaHyperpriorCharmModel", **extra)
    path = tmp_path / "tiny.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    return str(path)


def test_serve_build_model_from_config(tmp_path):
    args = serve_cli.parse_args([_config_file(tmp_path), "--wire", "device",
                                 "-d", "cpu"])
    model = serve_cli.build_model(args)
    assert model.wire_format == "device" and model.opt["is_train"] is False
    assert model.codec_y is not None and model.codec_z is not None
    assert str(model.device) == "cpu"
    # the device wire really runs: a round trip through the model
    img = images(1, 64, 64, seed=4)
    enc = model.compress(img, rate_ind=1.0)
    _, _, y_hat = model.decompress(enc["string_list"], beta=BETA)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    assert serve_cli.parse_args(["c.yaml"]).device == "cuda"


@pytest.mark.parametrize("extra,flags,match", [
    ({"serving_devices": 2}, [], "serving_devices"),
    ({"serving_devices": 2, "serving_partition": "spatial"}, [],
     "serving_partition: spatial"),
])
def test_serve_refuses_what_is_not_ported(tmp_path, monkeypatch, extra,
                                          flags, match):
    """A serving mesh of more GPUs than the machine has raises before the
    model is built (the card asked for, one card present).  The working
    meshes: tests/test_torch_serving_mesh.py."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = serve_cli.parse_args([_config_file(tmp_path, **extra)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match=match):
        serve_cli.build_model(args)


def test_serve_builds_with_an_aot_package(tmp_path, capsys):
    """``cli/export_serving.py`` at ``-d cpu`` prints its JSON line; then
    ``build_model(... --aot_package pkg)`` serves from the package: a
    request of the recorded bucket hits, and its stream equals the live
    model's."""
    cfg, pkg = _config_file(tmp_path), str(tmp_path / "pkg")
    res = export_serving.main([cfg, "--out", pkg, "--shapes", "1x64x64",
                               "--platforms", "cpu", "-q", "1.0", "-b",
                               str(BETA), "-d", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and res["programs"] > 0 and res["skipped"] == 0
    assert res["platforms"] == ["cpu"] and res["bytes"] > 0
    live = serve_cli.build_model(serve_cli.parse_args([cfg, "-d", "cpu"]))
    model = serve_cli.build_model(serve_cli.parse_args(
        [cfg, "-d", "cpu", "--aot_package", pkg]))
    assert model._aot.package is not None
    img = images(1, 64, 64, seed=4)
    enc = model.compress(img, rate_ind=1.0)
    assert enc["string_list"] == live.compress(img, rate_ind=1.0)[
        "string_list"]
    _, _, y_hat = model.decompress(enc["string_list"], beta=BETA)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    counts = aot_counts(model)
    assert counts["encode_head"]["hits"] == 1
    assert counts["decode_begin"]["hits"] == 2  # the encoder's replay too


def test_serve_smoke_cli_on_cpu(tmp_path, capsys):
    res = serve_smoke.main([_config_file(tmp_path), "--synthetic", "--size",
                            "64", "64", "--clients", "3", "--rounds", "2",
                            "--max_wait_ms", "200", "-d", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res)) and res["device"] == "cpu"
    assert sum(k * v for k, v in res["batch_hist"].items()) == 14
    assert res["value"] > 0 and res["compress_p95_ms"] >= res[
        "compress_p50_ms"]


# ---------------- PNG in memory ---------------------------------------------------

def test_encode_png_round_trips_and_cv2_reads_it():
    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3), np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    cv = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv[..., ::-1], img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    for bad in (img[..., 0], img[None], img[..., :2]):
        with pytest.raises(ValueError, match="encode_png"):
            encode_png(bad)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_png_matches_cv2(mode):
    """decode_png of PNGs in each colour type read_png takes (written by
    PIL) equals cv2's colour read."""
    ch = len(mode)
    rng = np.random.default_rng(ch)
    arr = rng.integers(0, 256, (19, 27, ch), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(buf, "PNG")
    data = buf.getvalue()
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(decode_png(data), want)


def test_decode_png_errors_name_the_source():
    with pytest.raises(ValueError, match="^request body: not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0", "request body")
    data = bytearray(encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="^PNG data: CRC"):
        decode_png(bytes(data))
