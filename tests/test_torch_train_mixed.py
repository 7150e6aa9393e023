"""Mixed-precision training (``mixed_precision: True``, the setting of every
``endurance_*``, ``real_*`` and stage-3 recipe) against the JAX package's,
on the CPU at tiny widths.

The RD trainer's ``_g_losses`` of both packages runs one bf16 training
forward (the batch cast to bf16, each conv casting its weights to its
input's dtype) on the same weights and JAX's own noise, drawn in the
latents' dtype as JAX draws it (bf16 for z and y); the loss is the
distortion + rate of the stage recipes (their LPIPS sees the f32 fake, as
in f32 training, and is left out).  Cases: the stage-1 class
``HyperpriorCharmModel``, the stage-2 ``InterpCaHyperpriorCharmModel`` and
the flagship ``BetaCondInterpCaHyperpriorCharmModel``.

Held:

* every stage's dtype equals JAX's under its promotion rules: the
  analysis and hyper-analysis bf16, the quantized latents, the
  likelihoods, the hyper-synthesis, the Charm slice transforms and the
  synthesis f32, so the output that reaches the discriminator
  (``fake_images``) is f32; each conv / deconv / dense layer of the port
  against the flax module's captured output, by the exporter's names;
* the latents, the outputs, the losses and every gradient (JAX's
  ``value_and_grad``), within bounds set from a measurement (one CPU run
  of this test, the largest of the three cases, then a margin of about
  2x):

  ===============================  ==========  ========
  quantity                         measured    bound
  ===============================  ==========  ========
  latents y / z, relative L2       1.07e-2     2.5e-2
  quantized y rounded apart        6.25%       12.5%
  ``fake_images`` max abs error    7.24e-2     0.15
  likelihoods y / z, relative L2   1.88e-2     4e-2
  losses, relative                 5.73e-3     1.2e-2
  gradients, worst relative L2     0.199       0.4
  gradients, median relative L2    2.09e-2     4e-2
  ===============================  ==========  ========

  bf16 keeps 8 significant bits: at |y| up to 62 (the tiny model's
  analysis is scaled up so that y spans several bins) a bf16 y is off by
  up to 0.125, so the two packages' y, which round in other places, agree
  to 1e-2 and the STE rounds 5-6% of y to another integer; the synthesis
  and every gradient then differ by that step of the function, the worst
  one 20% (a first decoder layer).  The f32 forward of
  ``tests/test_torch_train_forward.py`` agrees to 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.importers.torch_import import map_reference_name
from crdr_tpu.losses import build_loss as jax_loss
from crdr_tpu.trainer.rd_trainer import RateDistortionTrainer as JaxRD
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu.utils.img_utils import uint8_to_tensor
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.nn import Conv2d, ConvTranspose2d, Dense
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths
from tests.test_torch_train_forward import _rel_l2
from tests.test_torch_trainer import STAGES, _train_dict
from tests.torch_pairs import (images, jax_params,  # noqa: F401
                               one_torch_thread, port_model, tiny_config)

RATE_IND, BETA = 1.0, 2.56
LATENT_REL, APART = 2.5e-2, 0.125
FAKE_ATOL = 0.15
LIK_REL = 4e-2
LOSS_REL = 1.2e-2
GRAD_REL_WORST, GRAD_REL_MEDIAN = 0.4, 4e-2
CASES = {1: "HyperpriorCharmModel", 2: "InterpCaHyperpriorCharmModel",
         3: "BetaCondInterpCaHyperpriorCharmModel"}


def jax_noise(key, out, num_slices):
    """JAX's training-forward draws in the latents' dtype, NCHW, by the
    port's noise names (``tests/test_torch_train_forward.py``'s key tree)."""
    rngs = jax.random.split(key, 3)
    z, y = out["latent_code"]["z"], out["latent_code"]["y"]

    def nchw(a):
        return torch.from_numpy(np.asarray(a, np.float32).transpose(
            0, 3, 1, 2).copy()).to(_torch_dtype(a.dtype))

    n, h, w, c = z.shape
    zn = jax.random.uniform(rngs[0], (c, 1, n * h * w), z.dtype, -0.5, 0.5)
    given = {"z": nchw(zn.reshape(c, n, h, w).transpose(1, 2, 3, 0))}
    shape = y.shape[:3] + (y.shape[3] // num_slices,)
    for i in range(num_slices):
        given[f"y{i}"] = nchw(jax.random.uniform(
            jax.random.fold_in(rngs[1], i), shape, y.dtype, -0.5, 0.5))
    return given


def _torch_dtype(dt):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(dt)]


def _rd_cfg(tmp_path, stage):
    opt = _train_dict(tmp_path, stage, exp=f"mixed{stage}")
    tiny = tiny_config(CASES[stage]).to_dict()
    opt["model_type"], opt["subnet"] = tiny["model_type"], tiny["subnet"]
    opt["loss"].pop("perceptual_loss")
    opt["loss"]["rate_loss"] = STAGES[1 if stage == 1 else 2][1]
    opt["mixed_precision"] = True
    cfg = Config(opt)
    fill_paths(cfg)
    return cfg


def _port_layer_dtypes(net, run):
    """{module name: output dtype} of the port's conv / deconv / dense
    layers over ``run()``."""
    got, hooks = {}, []

    def hook(name):
        def record(m, inp, out):
            got.setdefault(name, out.dtype)
        return record

    for name, m in net.named_modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Dense)):
            hooks.append(m.register_forward_hook(hook(name)))
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return got, out


def _jax_layer_dtypes(jm, params, x, kw, key):
    """{flax module path (dots): output dtype} of every module, from
    ``capture_intermediates`` under ``eval_shape``."""
    _, st = jax.eval_shape(lambda p: jm.net.apply(
        {"params": p}, x, is_train=True, rng=key, capture_intermediates=True,
        mutable=["intermediates"], **kw), params)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            st["intermediates"]):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if "__call__" in keys and keys[-1] == "0":
            out.setdefault(".".join(keys[:keys.index("__call__")]),
                           str(leaf.dtype))
    return out


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_bf16_training_forward_matches_jax(tmp_path, stage):
    cfg = _rd_cfg(tmp_path, stage)
    tr = build_trainer(cfg, device="cpu")
    opt = tiny_config(CASES[stage])
    tr.comp_model.load_state_dict(port_model(opt).state_dict(), strict=True)
    pm = tr.comp_model
    jm, params = jax_params(pm, opt)
    jt = object.__new__(JaxRD)
    jt.opt = JaxConfigDict(cfg.to_dict())
    jt.comp_model = jm
    jt.distortion_loss = jax_loss(cfg.loss.distortion_loss.to_dict())
    jt.rate_loss = jax_loss(cfg.loss.rate_loss.to_dict())
    jt.perceptual_loss = None

    u8 = images(2, 64, 64, 5)
    x = jnp.asarray(uint8_to_tensor(u8))
    ri = jnp.asarray([RATE_IND], jnp.float32)
    bt = jnp.asarray([BETA], jnp.float32)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        losses, out, _ = jt._g_losses(p, x, ri, bt, key, jnp.ones((2,)))
        return sum(losses.values()), (losses, out)

    (j_loss, (j_losses, j_out)), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    # every stage's dtype is JAX's
    kw = {k: v for k, v, on in (("rate_ind", ri, jm.use_rate),
                                ("beta", bt, jm.use_beta)) if on}
    j_dtypes = _jax_layer_dtypes(jm, params, x.astype(jnp.bfloat16), kw, key)
    noise = jax_noise(key, j_out, pm.num_slices)
    queue = {k: [v] for k, v in noise.items()}
    replay = lambda name, like: queue[name].pop(0).to(like.dtype)
    batch = tr.put_batch(u8)
    net = pm.net
    got, (losses, out, _) = _port_layer_dtypes(net, lambda: tr._g_losses(
        batch, RATE_IND, BETA, replay, (1.0, 1.0)))
    assert not any(queue.values())
    for name, like in noise.items():
        assert like.dtype == torch.bfloat16, name  # z and y are bf16 in both
    checked = 0
    for name, dt in got.items():
        path = map_reference_name(f"{name}.weight", pm.use_rate, pm.use_beta)
        path = path[:-len(".weight")]
        assert path in j_dtypes, f"{name} -> {path}: not captured by flax"
        assert str(dt).replace("torch.", "") == j_dtypes[path], name
        checked += 1
    assert checked == len(got) > 50
    stages = {"encoder": "bfloat16", "hyperencoder": "bfloat16",
              "hyperdecoder": "float32", "decoder": "float32",
              "context_model": "float32"}
    for stage_name, dt in stages.items():
        assert j_dtypes[stage_name] == dt, stage_name
        mods = [n for n in got if n.startswith(stage_name + ".")]
        assert mods and all(str(got[n]).endswith(dt) for n in mods), \
            stage_name
    for group in ("latent_code", "quantized_code", "likelihoods",
                  "q_likelihoods"):
        for k in ("y", "z"):
            assert str(out[group][k].dtype).replace("torch.", "") == \
                str(j_out[group][k].dtype), f"{group}.{k}"
    assert out["fake_images"].dtype == torch.float32 == \
        _torch_dtype(j_out["fake_images"].dtype)

    def nchw(a):
        return np.asarray(a, np.float32).transpose(0, 3, 1, 2)

    latent_err = max(_rel_l2(out["latent_code"][k].detach().float().numpy(),
                             nchw(j_out["latent_code"][k])) for k in ("y", "z"))
    apart = float(np.mean(np.abs(out["quantized_code"]["y"].detach().numpy()
                                 - nchw(j_out["quantized_code"]["y"])) > 0.5))
    total = sum(losses.values())
    net.zero_grad()
    total.backward()

    fake_err = float(np.abs(out["fake_images"].detach().numpy()
                            - nchw(j_out["fake_images"])).max())
    lik_err = max(_rel_l2(out["likelihoods"][k].detach().numpy(),
                          nchw(j_out["likelihoods"][k])) for k in ("y", "z"))
    loss_err = max(abs(float(losses[k]) - float(v)) / abs(float(v))
                   for k, v in j_losses.items())
    ref = export_state_dict(jax.device_get(j_grads), net, pm.use_rate,
                            pm.use_beta)
    errs = {n: _rel_l2(p.grad if p.grad is not None else torch.zeros_like(p),
                       ref[n]) for n, p in net.named_parameters()
            if np.abs(ref[n].numpy()).max() > 0}
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"stage {stage} bf16: latents rel L2 {latent_err:.3e}, y rounded "
          f"apart {apart:.3e}, fake max abs {fake_err:.3e}, likelihood "
          f"rel L2 {lik_err:.3e}, loss rel {loss_err:.3e}, gradients "
          f"worst {worst[1]:.3e} ({worst[0]}), median "
          f"{np.median(list(errs.values())):.3e} over {len(errs)}")
    assert latent_err <= LATENT_REL
    assert apart <= APART
    assert fake_err <= FAKE_ATOL
    assert lik_err <= LIK_REL
    assert loss_err <= LOSS_REL
    assert worst[1] <= GRAD_REL_WORST, worst
    assert np.median(list(errs.values())) <= GRAD_REL_MEDIAN
    assert len(errs) > 0.8 * len(ref)
