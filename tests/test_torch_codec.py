"""The port's codec under the serving (kernel) configuration, on the CPU.

``tiny_opt()`` with ``fused_slice_kernel: True`` and ``transform_dtype:
bfloat16``: on the CPU the K1 wrapper runs its plain twin, so these hold the
codec's structure (replay encode, batch independence, launch counts) that the
H100 run of chip_smoke.py holds with the kernel itself.
"""

import threading
import time

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models.codec import codec_numerics
from crdr_tpu_torch.ops import charm_uniform
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_comp_model import tiny_opt


def _opt(**kw):
    opt = ConfigDict(tiny_opt().to_dict())
    opt.update(fused_slice_kernel=True, transform_dtype="bfloat16", **kw)
    return opt


def _smooth(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = []
    for _ in range(n):
        f = rng.uniform(2, 7, 3)
        imgs.append(np.stack([np.sin(f[0] * xx + 1) * np.cos(f[1] * yy),
                              np.cos(f[2] * xx * yy), np.sin(3 * yy)], -1))
    return (np.stack(imgs) * 0.8).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    m = build_comp_model(_opt(), device="cpu")
    # move the scale heads off the 0.11 bound the random init leaves every
    # sigma at (there the 16-bit CDF quantization alone puts the real rate
    # ~15% under the prediction); a trained model never sits there
    with torch.no_grad():
        for st in m.net.context_model.scale_slice_transforms:
            st.model[4].bias += 0.5
    m.codec_setup()
    return m


@pytest.mark.parametrize("q", [0.0, 1.25, 2.0])
def test_round_trip_is_bit_exact(model, q):
    x = _smooth(1, 64, 128, seed=int(q * 4))
    enc = model.compress(x, rate_ind=q)
    fake, z_hat, y_hat = model.decompress(enc["string_list"], beta=1.28)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    np.testing.assert_array_equal(z_hat, enc["z_hat"])
    assert fake.shape == x.shape and np.isfinite(fake).all()
    assert model.header_handler.decode(enc["string_list"][0])["rate_ind"] == q


def test_real_bpp_within_5_percent_of_predicted(model):
    x = _smooth(1, 128, 192, seed=3)
    enc = model.compress(x, rate_ind=1.0)
    real = sum(len(s) for s in enc["string_list"][1:]) * 8 / (128 * 192)
    pred = enc["pred_y_bpp"] + enc["pred_z_bpp"]
    assert real == pytest.approx(pred, rel=0.05)


def test_batch_streams_equal_batch_1_streams(model):
    x = _smooth(2, 64, 128, seed=5)
    batch = model.compress_batch(x, rate_ind=[0.5, 1.5])
    for i in range(2):
        one = model.compress(x[i:i + 1], rate_ind=[0.5, 1.5][i])
        assert batch[i]["string_list"] == one["string_list"]
        np.testing.assert_array_equal(batch[i]["y_hat"], one["y_hat"])
    # a batch decode and the batch-1 decode give the encoder's y_hat
    _, _, y_b = model.decompress_batch([b["string_list"] for b in batch],
                                       beta=[0.0, 5.12])
    _, _, y_1 = model.decompress(batch[1]["string_list"], beta=5.12)
    np.testing.assert_array_equal(y_b, np.concatenate(
        [b["y_hat"] for b in batch]))
    np.testing.assert_array_equal(y_1, batch[1]["y_hat"])


def test_analysis_runs_at_a_fixed_batch(model, monkeypatch):
    """The analysis sees TRANSFORM_BATCH images per call whatever the batch
    (zero images pad the last call), so cuDNN makes one algorithm choice
    and an image's stream does not depend on its batch on the GPU either."""
    from crdr_tpu_torch.models.codec import TRANSFORM_BATCH

    sizes = []
    real = model.net.encode_latents
    monkeypatch.setattr(model.net, "encode_latents",
                        lambda x, *a: sizes.append(len(x)) or real(x, *a))
    x = _smooth(TRANSFORM_BATCH + 1, 64, 64, seed=8)
    batch = model.compress_batch(x, rate_ind=[0.5] * len(x))
    assert sizes == [TRANSFORM_BATCH, TRANSFORM_BATCH]
    sizes.clear()
    one = model.compress(x[-1:], rate_ind=0.5)
    assert sizes == [TRANSFORM_BATCH]
    assert one["string_list"] == batch[-1]["string_list"]


def test_synthesis_runs_at_a_fixed_batch(model, monkeypatch):
    """The synthesis sees TRANSFORM_BATCH images per call and one rate /
    beta row per image, so a decoded image equals its decode alone, whatever
    its batch and its neighbours' beta (on the H100, cuDNN's bf16 convs
    gave batch 2 and 8 other bits than batch 1, and a mixed-beta batch ran
    the beta MLP at another row count)."""
    from crdr_tpu_torch.models.codec import TRANSFORM_BATCH

    calls = []
    real = model.net.decode
    monkeypatch.setattr(model.net, "decode", lambda y, r, b, d: calls.append(
        (len(y), len(r), len(b))) or real(y, r, b, d))
    x = _smooth(TRANSFORM_BATCH + 1, 64, 64, seed=9)
    encs = model.compress_batch(x, rate_ind=[0.5, 1.0, 2.0, 0.0, 1.5])
    betas = [0.0, 1.28, 2.56, 5.12, 2.56]
    fake, _, _ = model.decompress_batch([e["string_list"] for e in encs],
                                        beta=betas)
    assert calls == [(TRANSFORM_BATCH,) * 3] * 2
    for i in (0, 3, 4):
        calls.clear()
        one, _, _ = model.decompress(encs[i]["string_list"], beta=betas[i])
        assert calls == [(TRANSFORM_BATCH,) * 3]
        np.testing.assert_array_equal(one[0], fake[i])
    uniform, _, _ = model.decompress_batch(
        [e["string_list"] for e in encs[:2]], beta=2.56)
    one, _, _ = model.decompress(encs[1]["string_list"], beta=2.56)
    np.testing.assert_array_equal(uniform[1], one[0])


def test_slice_transform_calls_per_direction(model, monkeypatch):
    """3 * num_slices SliceTransforms per batch and direction (the LRP
    discarded at slice 0 is skipped): 30 at the flagship's 10 slices."""
    calls = []
    real = charm_uniform.slice_transform
    monkeypatch.setattr(charm_uniform, "slice_transform",
                        lambda *a: calls.append(a[-1]) or real(*a))
    enc = model.compress_batch(_smooth(2, 64, 64), rate_ind=1.0)
    assert len(calls) == 3 * model.num_slices
    calls.clear()
    model.decompress_batch([e["string_list"] for e in enc], beta=1.0)
    assert len(calls) == 3 * model.num_slices


def test_uint8_io_pads_and_crops():
    m = build_comp_model(_opt(codec_uint8_io=True), device="cpu")
    m.codec_setup()
    x = np.random.default_rng(6).integers(0, 256, (1, 50, 70, 3),
                                          dtype=np.uint8)
    enc = m.compress(x, rate_ind=1.0)
    fake, _, y_hat = m.decompress(enc["string_list"], beta=0.0)
    assert fake.shape == (1, 50, 70, 3)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    # the reconstruction sits on the uint8 grid
    np.testing.assert_allclose((fake + 1.0) * 127.5,
                               np.round((fake + 1.0) * 127.5), atol=1e-3)
    # the device uint8 conversion equals the float path's
    f = m.compress((x.astype(np.float32) / 255.0 - 0.5) * 2.0, rate_ind=1.0)
    assert f["string_list"] == enc["string_list"]


def test_f32_config_round_trip():
    opt = ConfigDict(tiny_opt().to_dict())
    m = build_comp_model(opt, device="cpu")
    m.codec_setup()
    assert not m.fused_slice_kernel and m.transform_dtype is None
    x = _smooth(2, 64, 64, seed=7)
    encs = m.compress_batch(x, rate_ind=2.0)
    _, _, y_hat = m.decompress_batch([e["string_list"] for e in encs],
                                     beta=2.56)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in encs]))


def test_state_dict_uses_reference_names(model):
    keys = set(model.state_dict())
    for k in ("encoder.conv1.weight", "encoder.interp_ca_list.8.bias",
              "encoder.block1.block0.conv.0.weight",
              "decoder.conv4.weight", "decoder.mlp.2.weight",
              "decoder.block3.block2.proj_3.weight",
              "decoder.attn1.trunk_block.2.c3.bias",
              "hyperdecoder.hd_std.conv3.weight",
              "entropy_model_z._matrix4", "entropy_model_z.quantiles",
              "context_model.lrp_slice_transforms.3.model.4.bias"):
        assert k in keys, k
    assert tuple(model.state_dict()["encoder.interp_ca_list.0.weight"].shape) \
        == (3, 1, 16, 1, 1)


@pytest.mark.parametrize("key,value", [("codec_precision", "default"),
                                       ("wire_format", "device")])
def test_unported_codec_options_raise(key, value):
    """Named for the time the port refused these options; it checks that
    the port now runs them as JAX's function.
    codec_precision: default (config/crdr_fastchain.yaml) sets up with TF32
    in the chain and the transforms, and a precision name the port cannot
    map raises.  wire_format: device with JAX's default
    device_wire_encoder (device: the E1 lane encoder, its twin on the CPU)
    sets up and round-trips exactly; an encoder name it does not know
    raises."""
    m = build_comp_model(_opt(**{key: value}), device="cpu")
    if key == "codec_precision":
        m.codec_setup()
        assert m._chain_tf32 and m._transform_tf32
        m = build_comp_model(_opt(codec_precision="bfloat16_3x"), device="cpu")
        with pytest.raises(ValueError, match="precision"):
            m.codec_setup()
        return
    m.codec_setup()
    assert m.wire_format == "device" and m.device_wire_encoder == "device"
    enc = m.compress(_smooth(1, 64, 64, seed=6), rate_ind=1.0)
    assert enc["string_list"][2][:4] == b"CRDW"
    _, _, y_hat = m.decompress(enc["string_list"], beta=1.0)
    np.testing.assert_array_equal(y_hat, enc["y_hat"])
    m = build_comp_model(_opt(wire_format="device",
                              device_wire_encoder="tpu"), device="cpu")
    with pytest.raises(ValueError, match="device_wire_encoder"):
        m.codec_setup()


def test_codec_numerics_serializes_threads():
    """The process-wide flags are held by one codec call at a time: a second
    thread waits, and the first one's flags stay set until it leaves."""
    b = torch.backends.cudnn
    before = (b.deterministic, b.benchmark, b.allow_tf32)
    inside, release, seen = threading.Event(), threading.Event(), []

    def first():
        with codec_numerics():
            inside.set()
            release.wait(10)
            seen.append(("first", b.deterministic, b.allow_tf32))

    def second():
        inside.wait(10)
        with codec_numerics():
            seen.append(("second", b.deterministic, b.allow_tf32))

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    inside.wait(10)
    time.sleep(0.2)
    assert seen == []  # the second call waits for the first
    release.set()
    for t in threads:
        t.join(10)
    assert seen == [("first", True, False), ("second", True, False)]
    assert (b.deterministic, b.benchmark, b.allow_tf32) == before


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_comp_model(_opt())
