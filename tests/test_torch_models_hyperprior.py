"""The two hyperprior classes of the port that had no counterpart yet
(``InterpCaHyperpriorModel``, ``BetaCondInterpCaHyperpriorModel``), the
model-level entry points, the metrics and the checkpoint loader, against the
JAX package on the CPU at tiny widths (``tests/torch_pairs.py``).

* Each class on the compressai wire at ``codec_precision`` ``highest`` and
  ``default`` (both f32 on a CPU): ``[header, z, y]`` byte-identical to
  JAX's (two 64x64 images at ``highest``, one 96x128 at ``default``), each
  package decodes the other's streams.
* ``run_model``: bpp, qbpp, y_bpp, z_bpp at rtol 1e-5, ``fake_images`` at
  atol 5e-4; ``validation`` rows against JAX's DataFrame records (bpp rtol
  1e-5, PSNR within 1e-2 dB, MS-SSIM within 1e-4).
* ``calc_psnr`` exactly, and ``calc_ms_ssim`` (float64 in the port) within
  1e-10 of an independent float64 evaluation and 1e-5 of JAX's f32 value on
  the same arrays, at 5 scales and at fewer with odd sides.
* ``load_learned_weight``: a reference-style ``torch.save`` file (and the
  port's own ``.ckpt``) into a model of another seed gives the same streams,
  JAX's ``import_reference_checkpoint`` reads the same file to the same
  streams, and a JAX msgpack checkpoint raises.
"""

import numpy as np
import pytest

import jax
import torch

from crdr_tpu.utils import img_utils as jax_img
from crdr_tpu.utils.saver import save_pytree
from crdr_tpu_torch.utils import img_utils
from tests.torch_pairs import (BETA, Q, codec_kwargs, images,  # noqa: F401
                               jax_params, one_torch_thread, pair,
                               port_model, tiny_config)

# (images, H, W) by codec_precision: each class meets both sizes, and each
# case compiles the JAX codec programs of one shape only
SIZES = {"highest": (2, 64, 64), "default": (1, 96, 128)}
CASES = [(cls, prec) for cls in ("InterpCaHyperpriorModel",
                                 "BetaCondInterpCaHyperpriorModel")
         for prec in ("highest", "default")]


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def streams(request):
    cls, prec = request.param
    pm, jm = pair(cls, codec_precision=prec)
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
    assert pm.header_handler.decode(out[0][1][0]["string_list"][0])[
        "rate_ind"] == Q
    assert out[0][1][0]["pred_y_bpp"] > 10 * out[0][1][0]["pred_z_bpp"]


def test_each_package_decodes_the_others_streams(streams):
    pm, jm, out = streams
    _, dk = codec_kwargs(pm)
    for x, port, ref in out:
        fake, _, y_p = pm.decompress_batch([e["string_list"] for e in ref],
                                           **dk)
        np.testing.assert_allclose(y_p, np.concatenate(
            [np.asarray(e["y_hat"]) for e in ref]), rtol=1e-5, atol=1e-5)
        assert fake.shape == x.shape and np.isfinite(fake).all()
        _, _, y_j = jm.decompress_batch([e["string_list"] for e in port], **dk)
        np.testing.assert_allclose(np.asarray(y_j), np.concatenate(
            [e["y_hat"] for e in port]), rtol=1e-5, atol=1e-5)
        _, _, y_own = pm.decompress_batch([e["string_list"] for e in port],
                                          **dk)
        np.testing.assert_array_equal(y_own, np.concatenate(
            [e["y_hat"] for e in port]))


# ---------------- run_model and validation ---------------------------------------

@pytest.fixture(scope="module")
def beta_pair():
    return pair("BetaCondInterpCaHyperpriorModel")


@pytest.mark.parametrize("q,beta", [(0.0, 0.0), (Q, BETA)])
def test_run_model_matches_jax(beta_pair, q, beta):
    pm, jm = beta_pair
    x = img_utils.uint8_to_tensor(images(2, 70, 90, seed=4))  # padded to 128
    mine = pm.run_model(x, rate_ind=q, beta=beta, is_train=False)
    ref = jm.run_model(x, rate_ind=q, beta=beta, is_train=False)
    for k in ("bpp", "qbpp", "y_bpp", "z_bpp"):
        assert mine[k].shape == (2,)
        np.testing.assert_allclose(mine[k], np.asarray(ref[k]), rtol=1e-5)
    np.testing.assert_array_equal(mine["qbpp"], mine["bpp"])  # eval
    np.testing.assert_allclose(mine["fake_images"],
                               np.asarray(ref["fake_images"]), atol=5e-4)
    np.testing.assert_array_equal(mine["real_images"], ref["real_images"])
    np.testing.assert_allclose(mine["y_hat"], np.asarray(ref["y_hat"]),
                               rtol=1e-5, atol=1e-5)
    assert mine["fake_images"].shape == (2, 70, 90, 3)
    assert (mine["rate_ind"], mine["beta"]) == (q, beta)


def test_run_model_requires_rate_and_beta_and_refuses_training(beta_pair):
    pm, _ = beta_pair
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="rate_ind"):
        pm.run_model(x, beta=1.0, is_train=False)
    with pytest.raises(ValueError, match="beta"):
        pm.run_model(x, rate_ind=1.0, is_train=False)
    with pytest.raises(NotImplementedError, match="training forward"):
        pm.run_model(x, rate_ind=1.0, beta=1.0)


@pytest.mark.parametrize("cls", ["BetaCondInterpCaHyperpriorModel",
                                 "HyperpriorModel"])
def test_validation_rows_match_jax(beta_pair, cls, tmp_path):
    pm, jm = beta_pair if cls == "BetaCondInterpCaHyperpriorModel" \
        else pair(cls)
    data = [{"real_images": img_utils.uint8_to_tensor(
        images(1, 64, 96, seed=s))} for s in (5, 6, 7)]
    rows = pm.validation(data, max_sample_size=2, save_img=True,
                         save_dir=str(tmp_path))
    ref = jm.validation(data, max_sample_size=2).to_dict("records")
    assert len(rows) == len(ref) == 2
    for mine, theirs in zip(rows, ref):
        assert list(mine) == list(theirs)
        assert mine["idx"] == theirs["idx"]
        for k in mine:
            if k.startswith("bpp"):
                assert mine[k] == pytest.approx(theirs[k], rel=1e-5)
            elif k.startswith("psnr"):
                assert abs(mine[k] - theirs[k]) <= 1e-2
            elif k.startswith("ms_ssim"):
                assert abs(mine[k] - theirs[k]) <= 1e-4
    if pm.use_rate:
        assert [k for k in rows[0] if k.startswith("bpp")] == \
            [f"bpp_{q + 1}" for q in range(pm.rate_level)]
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert "sample_1_real.png" in saved and len(saved) == 2 * (
        1 + (pm.rate_level if pm.use_rate else 1))
    back = img_utils.imread(str(tmp_path / "sample_2_real.png"))
    np.testing.assert_array_equal(img_utils.tensor_to_uint8(back),
                                  img_utils.tensor_to_uint8(
                                      data[1]["real_images"][0]))


# ---------------- metrics ----------------------------------------------------------

def _ms_ssim_f64(real, fake):
    """MS-SSIM of [-1,1] NHWC images in float64 numpy: the reference's
    formula written out independently of both packages."""
    x, y = ((np.asarray(a, np.float64) + 1.0) / 2.0 for a in (real, fake))
    coords = np.arange(11) - 5.0
    win = np.exp(-coords ** 2 / (2 * 1.5 ** 2))
    win /= win.sum()

    def blur(a):  # separable, valid
        a = np.lib.stride_tricks.sliding_window_view(a, 11, axis=1) @ win
        return np.lib.stride_tricks.sliding_window_view(a, 11, axis=2) @ win

    weights = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    levels = 1
    while levels < 5 and min(x.shape[1:3]) // 2 ** levels >= 11:
        levels += 1
    weights = weights[:levels] / weights[:levels].sum()
    vals = []
    for i in range(levels):
        mx, my = blur(x), blur(y)
        sxx, syy = blur(x * x) - mx * mx, blur(y * y) - my * my
        sxy = blur(x * y) - mx * my
        cs = (2 * sxy + 0.03 ** 2) / (sxx + syy + 0.03 ** 2)
        ssim = (2 * mx * my + 0.01 ** 2) / (mx * mx + my * my + 0.01 ** 2) * cs
        if i < levels - 1:
            vals.append(np.maximum(cs.mean(axis=(1, 2)), 0.0))
            pads = ((0, 0), (0, x.shape[1] % 2), (0, x.shape[2] % 2), (0, 0))
            x, y = (np.pad(a, pads, mode="edge") for a in (x, y))
            x, y = ((a[:, 0::2, 0::2] + a[:, 1::2, 0::2] + a[:, 0::2, 1::2]
                     + a[:, 1::2, 1::2]) / 4.0 for a in (x, y))
    vals.append(np.maximum(ssim.mean(axis=(1, 2)), 0.0))
    return float(np.prod(np.stack(vals) ** weights[:, None, None], 0).mean())


@pytest.mark.parametrize("shape,noise", [
    ((2, 200, 180), 0.05), ((1, 64, 77), 0.1), ((1, 33, 45), 0.02),
    ((1, 41, 53), 0.05)])
def test_psnr_and_ms_ssim_match_jax(shape, noise):
    """PSNR is exact.  MS-SSIM: the port computes in float64 and equals an
    independent float64 evaluation to 1e-10; the JAX package's f32 value
    sits up to ~8e-6 from that on these smooth images (the variances
    E[x^2] - E[x]^2 cancel), so the port is held to JAX at 1e-5."""
    real = img_utils.uint8_to_tensor(images(*shape, seed=sum(shape)))
    rng = np.random.default_rng(1)
    fake = np.clip(real + rng.normal(0, noise, real.shape), -1, 1) \
        .astype(np.float32)
    if shape[0] == 1:  # HWC takes the same path
        real, fake = real[0], fake[0]
    assert img_utils.calc_psnr(real, fake) == jax_img.calc_psnr(real, fake)
    assert img_utils.calc_psnr(real, real) == float("inf")
    mine = img_utils.calc_ms_ssim(real, fake, device="cpu")
    assert abs(mine - _ms_ssim_f64(real[None] if real.ndim == 3 else real,
                                   fake[None] if fake.ndim == 3 else fake)) \
        <= 1e-10
    assert abs(mine - jax_img.calc_ms_ssim(real, fake)) <= 1e-5
    assert 0.0 < mine < 1.0
    assert img_utils.calc_ms_ssim(real, real, device="cpu") == \
        pytest.approx(1.0, abs=1e-12)


def test_ms_ssim_device_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        img_utils.calc_ms_ssim(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)))


def test_tensor_to_uint8_matches_jax():
    x = np.linspace(-1.2, 1.2, 4001, dtype=np.float32).reshape(1, 1, -1, 1)
    np.testing.assert_array_equal(img_utils.tensor_to_uint8(x),
                                  jax_img.tensor_to_uint8(x))


# ---------------- checkpoints ---------------------------------------------------------

@pytest.mark.parametrize("ext,prefix", [(".pth.tar", "module."),
                                        (".pt", ""), (".ckpt", "")])
def test_load_learned_weight_gives_the_same_streams(ext, prefix, tmp_path):
    opt = tiny_config("InterpCaHyperpriorModel", seed=7)
    src = port_model(opt)
    src.codec_setup()
    x = images(1, 64, 64, seed=9)
    want = src.compress(x, rate_ind=Q)["string_list"]
    path = str(tmp_path / f"model{ext}")
    torch.save({"comp_model": {prefix + k: v for k, v in
                               src.state_dict().items()}}, path)

    other = port_model(tiny_config("InterpCaHyperpriorModel", seed=99))
    other.codec_setup()
    assert other.compress(x, rate_ind=Q)["string_list"] != want
    counts = other.load_learned_weight(path)
    assert counts == {"loaded": len(src.state_dict()), "kept": 0}
    other.codec_setup()
    assert other.compress(x, rate_ind=Q)["string_list"] == want

    if ext == ".pth.tar":  # JAX's reference importer, on the same file
        jm, template = jax_params(src, opt)
        jm.params = template
        jm.load_learned_weight(path)
        jm.codec_setup()
        assert [bytes(s) for s in jm.compress(x, rate_ind=Q)["string_list"]] \
            == want


def test_load_learned_weight_refuses_a_jax_msgpack_checkpoint(tmp_path):
    pm = port_model(tiny_config("InterpCaHyperpriorModel"))
    _, params = jax_params(pm, tiny_config("InterpCaHyperpriorModel"))
    path = str(tmp_path / "jax.ckpt")
    save_pytree({"comp_model": {"params": jax.device_get(params)}}, path)
    with pytest.raises(ValueError, match="JAX package's saver"):
        pm.load_learned_weight(path)
