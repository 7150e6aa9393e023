"""The port's training forwards against the JAX package's, on the CPU.

Each case runs ``net.apply(..., is_train=True, rng=key)`` in JAX and the
port's ``net(x, rate_ind, beta, noise)`` on the same weights, the same
images and JAX's own noise: the port's noise source replays JAX's key tree
(``split(rng, 3)``: the bottleneck's draw on key 0, in its (C, 1, N*H*W)
layout; the hyperprior's y draw on key 1, or ``fold_in(key 1, i)`` for
context-model slice i).  The loss is the RD trainer's distortion + rate
(MSE x 150 + the HiFiC rate loss), and the gradients of both packages are
taken of it: ``jax.value_and_grad`` and ``backward``.

Held: ``fake_images``, ``y_hat``, ``z_hat``, the likelihoods and the
q-likelihoods within rtol 1e-4, atol 2e-4; the loss within rtol 1e-4; every
parameter's gradient within a relative L2 error of 1e-3 (JAX's gradient
tree carried to the port's names and layouts by ``export_state_dict``);
the aux loss and its gradient on ``quantiles`` likewise.

Cases: Charm (the stage-1 class ``HyperpriorCharmModel`` and the stage-2
``InterpCaHyperpriorCharmModel``), the checkerboard, a hyperprior class with
the STE conditional and bottleneck and with the plain ones, and Balle18
(the GDN twin, ``config/balle18_mean_scale.yaml`` at tiny widths).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.losses import build_loss as jax_loss
from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.models.codec_common import _rate_summary as jax_rate_summary
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu.utils.img_utils import uint8_to_tensor
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.losses import build_loss
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models.comp_model import _rate_summary
from crdr_tpu_torch.utils.config import Config
from tests.test_torch_generic import _config as balle18_config
from tests.test_torch_generic import _edit as balle18_edit
from tests.torch_pairs import (images, jax_params,  # noqa: F401
                               one_torch_thread, port_model, tiny_config)

RTOL, ATOL = 1e-4, 2e-4
GRAD_REL = 1e-3
RATE_IND, BETA = 1.0, 2.56
MSE = {"type": "MSELoss", "loss_weight": 150}
RATE = {"type": "HificRateLoss", "lambda_A": 0.05, "lambda_B": 0.015625,
        "target_rate": 1.5}
VAR_RATE = {"type": "HificVariableRateLoss", "lambda_A": [3.4, 1.3, 0.4],
            "lambda_B": 0.015625, "target_rate": [0.08, 0.16, 0.36]}
CB = {"type": "ElicCheckerboardCharmContextModel", "num_slices": 2,
      "hyper_out_ch": 64, "bottleneck_y": 32, "max_support_slices": 2}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _models(case, actv=None):
    """(port model, JAX model, JAX params) on the same weights; ``actv``
    sets the context model's SliceTransform activation."""
    if case == "balle18":
        jm = jax_build(balle18_config(JaxConfig))
        jm.init_params(input_size=64)
        params = balle18_edit(jax.device_get(jm.params), 7)
        pm = build_comp_model(balle18_config(Config), device="cpu")
        pm.load_state_dict(export_state_dict(params, pm.net, False, False))
        return pm, jm, params
    model_type, extra = {
        "charm": ("HyperpriorCharmModel", None),
        "charm_rate": ("InterpCaHyperpriorCharmModel", None),
        "checkerboard": ("InterpCaHyperpriorCharmModel", CB),
        "hyperprior_ste": ("HyperpriorModel", None),
        "hyperprior_plain": ("HyperpriorModel", "plain"),
    }[case]
    opt = tiny_config(model_type).to_dict()
    if extra == "plain":
        opt["subnet"]["entropy_model_y"]["type"] = \
            "GaussianMeanScaleConditional"
        opt["subnet"]["entropy_model_z"]["type"] = "EntropyBottleneck"
    elif extra is not None:
        opt["subnet"]["context_model"] = dict(extra)
    if actv is not None:
        opt["subnet"]["context_model"]["slice_transform_kwargs"] = {
            "actv": actv}
    opt = Config(opt)
    pm = port_model(opt)
    jm, params = jax_params(pm, opt)
    return pm, jm, params


def _jax_noise(key, out, num_slices):
    """JAX's training-forward draws, NCHW, by the port's noise names."""
    rngs = jax.random.split(key, 3)
    z = np.asarray(out["latent_code"]["z"])
    n, h, w, c = z.shape
    zn = np.asarray(jax.random.uniform(rngs[0], (c, 1, n * h * w),
                                       jnp.float32, -0.5, 0.5))
    given = {"z": torch.from_numpy(np.ascontiguousarray(
        zn.reshape(c, n, h, w).transpose(1, 0, 2, 3)))}
    y = np.asarray(out["latent_code"]["y"])
    if num_slices is None:
        given["y"] = _nchw(jax.random.uniform(rngs[1], y.shape, jnp.float32,
                                              -0.5, 0.5))
    else:
        shape = y.shape[:3] + (y.shape[3] // num_slices,)
        for i in range(num_slices):
            given[f"y{i}"] = _nchw(jax.random.uniform(
                jax.random.fold_in(rngs[1], i), shape, jnp.float32, -0.5,
                0.5))
    return given


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.linalg.norm(b)
    return np.linalg.norm(a - b) / ref if ref > 0 else np.linalg.norm(a)


@pytest.mark.parametrize("case", ["charm", "charm_rate", "checkerboard",
                                  "hyperprior_ste", "hyperprior_plain",
                                  "balle18"])
def test_training_forward_loss_and_gradients_match_jax(case):
    check_training_forward(*_models(case))


def check_training_forward(pm, jm, params) -> None:
    """The port's training forward, loss, gradients and aux loss against
    JAX's on the same weights and noise (module doc)."""
    x = uint8_to_tensor(images(2, 64, 64, 5))
    rate_opt = VAR_RATE if pm.use_rate else RATE
    kw = {}
    if jm.use_rate:
        kw["rate_ind"] = jnp.asarray([RATE_IND], jnp.float32)
    if jm.use_beta:
        kw["beta"] = jnp.asarray([BETA], jnp.float32)
    j_dist, j_rate = jax_loss(MSE), jax_loss(rate_opt)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        out = jm.net.apply({"params": p}, jnp.asarray(x), is_train=True,
                           rng=key, **kw)
        s = jax_rate_summary(out, 64 * 64)
        loss = j_dist(jnp.asarray(x), out["fake_images"]) + j_rate(
            s["bpp"], s["qbpp"], rate_ind=kw.get("rate_ind"))
        return loss, out

    (j_loss, j_out), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    j_aux, j_aux_grads = jax.value_and_grad(lambda p: jm.net.apply(
        {"params": p}, method=lambda n: n.aux_loss()))(params)

    given = _jax_noise(key, j_out, pm.num_slices if pm.use_charm else None)

    def noise(name, like):
        assert given[name].shape == like.shape, name
        return given[name]

    net = pm.net.train().requires_grad_(True)
    ri = torch.tensor([RATE_IND]) if pm.use_rate else None
    bt = torch.tensor([BETA]) if pm.use_beta else None
    xt = _nchw(x)
    out = net(xt, ri, bt, noise)
    s = _rate_summary(out, 64 * 64)
    loss = build_loss(MSE)(xt, out["fake_images"]) + build_loss(rate_opt)(
        s["bpp"], s["qbpp"], rate_ind=RATE_IND)
    loss.backward()

    for key_ in ("fake_images",):
        np.testing.assert_allclose(_nhwc(out[key_]), np.asarray(j_out[key_]),
                                   rtol=RTOL, atol=ATOL)
    for group in ("quantized_code", "likelihoods", "q_likelihoods"):
        for k in ("y", "z"):
            np.testing.assert_allclose(
                _nhwc(out[group][k]), np.asarray(j_out[group][k]),
                rtol=RTOL, atol=ATOL, err_msg=f"{group}.{k}")
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=RTOL)

    ref = export_state_dict(jax.device_get(j_grads), net, pm.use_rate,
                            pm.use_beta)
    checked = 0
    for name, p in net.named_parameters():
        mine = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel_l2(mine, ref[name]) <= GRAD_REL, name
        checked += float(np.abs(ref[name].numpy()).max() > 0)
    assert checked > 0.8 * len(ref)  # most parameters get a gradient

    net.zero_grad()
    aux = net.aux_loss()
    aux.backward()
    assert float(aux.detach()) == pytest.approx(float(j_aux), rel=RTOL)
    ref_aux = export_state_dict(jax.device_get(j_aux_grads), net,
                                pm.use_rate, pm.use_beta)
    q = net.entropy_model_z.quantiles
    assert _rel_l2(q.grad, ref_aux["entropy_model_z.quantiles"]) <= GRAD_REL
    assert np.abs(ref_aux["entropy_model_z.quantiles"].numpy()).max() > 0
    for name, p in net.named_parameters():  # the aux loss trains quantiles only
        if name != "entropy_model_z.quantiles":
            assert p.grad is None or not p.grad.any(), name
