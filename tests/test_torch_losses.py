"""The port's losses against the JAX package's, on the CPU: MSE, L1,
MS-SSIM, the rate losses (HiFiC single and variable rate, with and without
schedules) and LPIPS (on JAX's ``init_lpips`` weights carried over by
``export_state_dict``, and on a weight file in the converter's format read
by both packages), within rtol 1e-5.  ``LPIPSLoss`` without weights and
without ``allow_random`` refuses to build, as JAX's does."""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.losses import build_loss as jax_loss
from crdr_tpu.metrics.lpips import LPIPSAlex as JaxLPIPS
from crdr_tpu.metrics.lpips import init_lpips as jax_init_lpips
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.losses import build_loss
from crdr_tpu_torch.metrics.lpips import LPIPSAlex
from tests.torch_pairs import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _images(n, h, w, seed):
    """Two [-1, 1] image batches a little apart, NHWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    real = np.stack([np.stack([np.sin(f * xx + 1) * np.cos(2 * f * yy),
                               np.cos(f * xx * yy), np.sin(3 * yy + f * xx)],
                              -1) for f in rng.uniform(2, 9, n)]) * 0.8
    fake = np.clip(real + rng.normal(0, 0.1, real.shape), -1, 1)
    return real.astype(np.float32), fake.astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("opt", [
    {"type": "MSELoss", "loss_weight": 150},
    {"type": "MSELoss", "loss_weight": 0.01, "mse_scale": "0_255"},
    {"type": "L1Loss", "loss_weight": 2.0},
    {"type": "MSSSIMLoss", "loss_weight": 3.0}], ids=lambda o: o["type"]
    + o.get("mse_scale", ""))
def test_distortion_losses_match_jax(opt):
    """MS-SSIM's loss is weight x (1 - MS-SSIM), which scales the f32
    rounding of MS-SSIM (a few 1e-6 in either package: the variances are
    differences of blurred moments) by 1 / (1 - MS-SSIM): MS-SSIM itself is
    held to rtol 1e-5 and the loss to the same error, weight x 1e-5."""
    # 178 x 178: all 5 MS-SSIM scales, and odd sides to pad between them
    real, fake = _images(2, 178, 178, 1)
    want = float(jax_loss(opt)(jnp.asarray(real), jnp.asarray(fake)))
    got = float(build_loss(opt)(_nchw(real), _nchw(fake)))
    if opt["type"] == "MSSSIMLoss":
        w = opt["loss_weight"]
        assert 1 - got / w == pytest.approx(1 - want / w, rel=RTOL)
        assert abs(got - want) <= w * RTOL
    else:
        assert got == pytest.approx(want, rel=RTOL)


SCHED = {"lambda_schedule": {"vals": [2.0, 1.0], "steps": [50]},
         "target_rate_schedule": {"vals": [1.5, 1.0, 0.5], "steps": [20, 70]}}


@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("variable", [False, True])
def test_rate_losses_match_jax(variable, scheduled):
    if variable:
        opt = {"type": "HificVariableRateLoss", "lambda_A": [3.4, 1.3, 0.4],
               "lambda_B": 0.015625, "target_rate": [0.08, 0.16, 0.36]}
    else:
        opt = {"type": "HificRateLoss", "lambda_A": 0.05,
               "lambda_B": 0.015625, "target_rate": 1.5}
    if scheduled:
        opt.update(SCHED)
    jl, tl = jax_loss(opt), build_loss(opt)
    bpp = np.asarray([0.7, 0.9], np.float32)
    seen = set()
    for itr in (1, 30, 80):
        mults = tl.schedule_mults(itr)
        assert mults == jl.schedule_mults(itr)
        for q in ((0.01, 0.05), (0.3, 0.35), (1.4, 1.7), (2.5, 3.0)):
            qbpp = np.asarray(q, np.float32)
            for ri in ((0.0, 1.0, 2.0) if variable else (0.0,)):
                want = float(jl(jnp.asarray(bpp), jnp.asarray(qbpp),
                                rate_ind=jnp.asarray([ri]),
                                lambda_mult=mults[0], target_mult=mults[1]))
                got = float(tl(torch.from_numpy(bpp),
                               torch.from_numpy(qbpp), rate_ind=ri,
                               lambda_mult=mults[0], target_mult=mults[1]))
                assert got == pytest.approx(want, rel=RTOL)
                seen.add(round(want / float(bpp.mean()), 6))
    assert len(seen) >= 2  # both sides of the switch


def test_rate_loss_and_validation_match_jax():
    bpp = np.asarray([0.7, 0.9], np.float32)
    opt = {"type": "RateLoss", "loss_weight": 0.3}
    assert float(build_loss(opt)(torch.from_numpy(bpp))) == pytest.approx(
        float(jax_loss(opt)(jnp.asarray(bpp))), rel=RTOL)
    for bad in ({"type": "HificRateLoss", "lambda_A": 0.01, "lambda_B": 0.05,
                 "target_rate": 1.0},
                {"type": "HificVariableRateLoss", "lambda_A": [1.0, 2.0],
                 "lambda_B": 0.01, "target_rate": [0.1, 0.2]},
                {"type": "HificRateLoss", "lambda_A": 0.05, "lambda_B": 0.01,
                 "target_rate": 1.0,
                 "lambda_schedule": {"vals": [1.0], "steps": [5]}}):
        with pytest.raises(ValueError):
            build_loss(bad)
        with pytest.raises(AssertionError):
            jax_loss(bad)


def _torchvision_like(variables):
    """JAX's LPIPS variables as the converter's weight blob: torchvision
    AlexNet ``features.K`` and lpips ``lin{i}.model.1`` state dicts."""
    p = jax.device_get(variables["params"])
    alex = {}
    for k, name in ((0, "conv0"), (3, "conv3"), (6, "conv6"), (8, "conv8"),
                    (10, "conv10")):
        alex[f"features.{k}.weight"] = np.asarray(
            p["alex"][name]["weight"]).transpose(3, 2, 0, 1).copy()
        alex[f"features.{k}.bias"] = np.asarray(p["alex"][name]["bias"])
    lin = {f"lin{i}.model.1.weight": np.asarray(
        p[f"lin{i}"]["weight"]).transpose(3, 2, 0, 1).copy()
        for i in range(5)}
    return {"alexnet": alex, "lpips": lin}


def test_lpips_matches_jax_on_exported_weights():
    variables = jax_init_lpips(jax.random.PRNGKey(4))
    mod = LPIPSAlex()
    mod.load_state_dict(export_state_dict(jax.device_get(
        variables["params"]), mod, False, False))
    real, fake = _images(2, 64, 96, 2)
    want = np.asarray(JaxLPIPS().apply(variables, jnp.asarray(real),
                                       jnp.asarray(fake)))
    with torch.no_grad():
        got = mod(_nchw(real), _nchw(fake)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_lpips_loss_reads_the_weight_file_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.delenv("CRDR_ALLOW_RANDOM_LPIPS", raising=False)
    variables = jax_init_lpips(jax.random.PRNGKey(5))
    path = str(tmp_path / "lpips_alex.pkl")
    with open(path, "wb") as f:
        pickle.dump(_torchvision_like(variables), f)
    opt = {"type": "LPIPSLoss", "loss_weight": 0.5, "weights_path": path}
    real, fake = _images(2, 64, 64, 3)
    want = float(jax_loss(opt)(jnp.asarray(real), jnp.asarray(fake)))
    loss = build_loss(opt)
    assert not any(p.requires_grad for p in loss.parameters())  # frozen
    got = float(loss(_nchw(real), _nchw(fake)))
    assert got == pytest.approx(want, rel=RTOL)
    # the environment variable names the same file
    monkeypatch.setenv("CRDR_LPIPS_WEIGHTS", path)
    got_env = float(build_loss({"type": "LPIPSLoss", "loss_weight": 0.5})(
        _nchw(real), _nchw(fake)))
    assert got_env == got


def test_lpips_loss_refuses_to_build_without_weights(tmp_path, monkeypatch):
    monkeypatch.delenv("CRDR_ALLOW_RANDOM_LPIPS", raising=False)
    monkeypatch.delenv("CRDR_LPIPS_WEIGHTS", raising=False)
    opt = {"type": "LPIPSLoss", "loss_weight": 1.0}
    with pytest.raises(FileNotFoundError, match="allow_random"):
        build_loss(opt)
    with pytest.raises(FileNotFoundError, match="allow_random"):
        jax_loss(opt)
    assert build_loss({**opt, "allow_random": True}) is not None
    # a weight file that holds anything but numpy arrays is refused
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"alexnet": {}, "lpips": {"x": print}}, f)
    with pytest.raises(pickle.UnpicklingError):
        build_loss({**opt, "weights_path": path})
