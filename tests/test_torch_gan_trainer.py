"""The port's GAN trainers on the CPU at tiny widths (64x64, batch 2; the
flagship class at main_ch 16, a module list of three CLIC21
sub-discriminators at main_ch 8), held against the JAX package's.

One step of ``MultirateBetaCondHrrGanRateDistortionTrainer`` at a low rate
(the anchor is the net's output at ``rate_ind + 1``) and at the top rate
(the anchor is the batch), and one step of each of the vanilla, RGAN and
RaGAN trainers, against JAX's trainer pieces (``_anchor_images``,
``_g_losses``, ``_d_apply``, ``_g_adv``, ``_d_loss``) under
``jax.value_and_grad``, on the same weights (the port's model, JAX's D and
LPIPS init carried over) and JAX's own noise (the anchor's key tree, then
G's): G's losses and D's within rtol 1e-4, every gradient of G and of D
within a relative L2 error of 1e-3 (the f32 tolerances of
``tests/test_torch_train_forward.py``).  Then the step's contract: D's
``.grad`` stays empty through G's backward, the NaN skip holds G, D and
both of D's Adam moments but moves D's state as JAX does, a save -> load
-> continue is bit-equal with D included, and the train CLI runs two
stage-3 steps, writes D's checkpoint and auto-resumes.
"""

import functools
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.losses import build_loss as jax_loss
from crdr_tpu.metrics.lpips import init_lpips as jax_init_lpips
from crdr_tpu.subnet.discriminator import build_discriminator as jax_build_d
from crdr_tpu.trainer import gan_trainer as jax_gan
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu.utils.img_utils import uint8_to_tensor
from crdr_tpu_torch.cli.train import main
from crdr_tpu_torch.importers.jax_params import (export_discriminator_state,
                                                 export_state_dict)
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths
from crdr_tpu_torch.utils.registry import TRAINER_REGISTRY
from tests.test_torch_train_forward import _jax_noise, _rel_l2
from tests.test_torch_trainer import _batches, _train_dict, uint8_like_nan
from tests.torch_pairs import (images, jax_params,  # noqa: F401
                               one_torch_thread, port_model, tiny_config)

RTOL, GRAD_REL = 1e-4, 1e-3
BETA = 2.56
STAGE3 = "MultirateBetaCondHrrGanRateDistortionTrainer"
TRAINERS = ["GANRateDistortionTrainer", "RGANRateDistortionTrainer",
            "RaGANRateDistortionTrainer", "BetaCondRGANRateDistortionTrainer",
            "MultirateHighRateRGANRateDistortionTrainer", STAGE3]
MODEL = "BetaCondInterpCaHyperpriorCharmModel"
ADV_MODEL = "InterpCaHyperpriorModel"  # the adversarial modes' model
D_OPT = {"type": "ModuleListDiscriminator",
         "_subd_type": "CLIC21GVAEDiscriminator", "_num_subd": 3, "in_ch": 3,
         "out_ch": 1, "main_ch": 8, "norm_type": "none"}


def gan_dict(tmp_path, trainer=STAGE3, exp="gan", model=MODEL, **extra):
    """A stage-3 recipe at tiny widths (``tests/test_torch_trainer.py``'s
    with the flagship class, or ``model``), its GAN weight raised so that
    ``adv`` counts."""
    opt = _train_dict(tmp_path, 3, exp)
    tiny = tiny_config(model).to_dict()
    opt["model_type"], opt["subnet"] = tiny["model_type"], tiny["subnet"]
    opt["trainer"] = {"type": trainer}
    opt["discriminator"] = dict(D_OPT)
    opt["loss"]["perceptual_loss"]["loss_weight"] = 0.390625
    opt["loss"]["gan_loss"] = {"type": "VanillaGANLoss", "loss_weight": 0.05}
    opt["optim"]["d_optimizer"] = {"type": "Adam", "lr": 1e-4}
    opt["optim"]["d_scheduler"] = {"type": "MultiStepLR", "milestones": [3],
                                   "gamma": 0.1}
    opt.update(extra)
    return opt


def gan_cfg(tmp_path, trainer=STAGE3, exp="gan", **extra):
    cfg = Config(gan_dict(tmp_path, trainer, exp, **extra))
    fill_paths(cfg)
    return cfg


class Replay:
    """A noise source handing out given draws by name, in call order."""

    def __init__(self, *draws):
        self.queue = {}
        for d in draws:
            for k, v in d.items():
                self.queue.setdefault(k, []).append(v)
        self.generator = torch.Generator()

    def __call__(self, name, like):
        t = self.queue[name].pop(0)
        assert t.shape == like.shape, name
        return t.to(like.dtype)

    def drained(self):
        return not any(self.queue.values())


# JAX's three adversarial modes in one jitted program (one trace, one
# compile), the stage-3 trainer in another; results kept by (group, rate)
ADV = {"GANRateDistortionTrainer": "vanilla",
       "RGANRateDistortionTrainer": "rgan", "RaGANRateDistortionTrainer": "ragan"}
_JAX_STEPS, _JAX_RESULTS = {}, {}


def pair(tmp_path, trainer=STAGE3, model=MODEL):
    """(port trainer on the CPU, JAX trainer pieces, JAX params, D
    variables): the tiny model's weights in both, JAX's D and LPIPS init in
    the port."""
    cfg = gan_cfg(tmp_path, trainer, model=model)
    tr = build_trainer(cfg, device="cpu")
    opt = tiny_config(model)
    tr.comp_model.load_state_dict(port_model(opt).state_dict(), strict=True)
    jm, params = jax_params(tr.comp_model, opt)
    group = "adv" if trainer in ADV else trainer
    if group not in _JAX_STEPS:
        jt = jax_pieces(trainer, jm, cfg)
        modes = list(ADV.values()) if group == "adv" else [jt.adv_mode]
        _JAX_STEPS[group] = jt, jax.jit(lambda *a: _jax_modes(jt, modes, *a))
    jt = _JAX_STEPS[group][0]
    jt.adv_mode = ADV.get(trainer, jt.adv_mode)
    tr.perceptual_loss.module.load_state_dict(export_state_dict(
        jax.device_get(jt.perceptual_loss.variables["params"]),
        tr.perceptual_loss.module, False, False))
    variables = _d_variables()
    tr.discriminator.load_state_dict(export_discriminator_state(
        variables, tr.discriminator), strict=True)
    return tr, jt, params, variables


def jax_pieces(trainer, jm, cfg):
    """JAX's trainer of that name without its set-up (no loader, no init):
    the model, the losses (LPIPS on ``init_lpips(PRNGKey(4))``) and D."""
    jt = object.__new__(getattr(jax_gan, trainer))
    jt.opt = JaxConfigDict(cfg.to_dict())
    jt.comp_model = jm
    lo = cfg.loss.to_dict()
    jt.distortion_loss = jax_loss(lo["distortion_loss"])
    jt.rate_loss = jax_loss(lo["rate_loss"])
    jt.perceptual_loss = jax_loss(lo["perceptual_loss"])
    jt.perceptual_loss.variables = _lpips_variables()
    jt.gan_loss = jax_loss(lo["gan_loss"])
    jt.discriminator = jax_build_d(D_OPT)
    return jt


@functools.lru_cache(maxsize=None)
def _lpips_variables():
    return jax.jit(jax_init_lpips)(jax.random.PRNGKey(4))


@functools.lru_cache(maxsize=None)
def _d_variables():
    """JAX's D init (``PRNGKey(1)``), every sub-discriminator touched."""
    d = jax_build_d(D_OPT)
    return dict(jax.device_get(jax.jit(lambda k: d.init(
        k, jnp.zeros((1, 64, 64, 3)), rate_ind=0))(jax.random.PRNGKey(1))))


def jax_step(jt, params, variables, x, rate_ind, beta, key):
    """JAX's step_fn up to the updates (gan_trainer.py:160-240), jitted:
    G's and D's losses, gradients, the G forward's output and the anchor,
    and the (anchor, G) keys.  The inputs are the same in every case of a
    group (the seeded weights, batch and key), so its results are kept."""
    group = "adv" if type(jt).__name__ in ADV else type(jt).__name__
    mode = jt.adv_mode  # (a trace leaves another mode set)
    if (group, rate_ind) not in _JAX_RESULTS:
        _JAX_RESULTS[group, rate_ind] = _JAX_STEPS[group][1](
            params, variables, x, jnp.asarray([rate_ind], jnp.float32),
            jnp.asarray([beta], jnp.float32), key)
    log, g_grads, d_grads, out, anchor = \
        _JAX_RESULTS[group, rate_ind][mode]
    return ({k: float(v) for k, v in log.items()}, g_grads, d_grads, out,
            anchor, tuple(jax.random.split(key))[::-1])


def _jax_modes(jt, modes, *args):
    out = {}
    for mode in modes:  # a trace-time switch of the pieces' mode
        jt.adv_mode = mode
        out[mode] = _jax_step(jt, *args)
    return out


def _jax_step(jt, params, variables, x, ri, bt, key):
    sg = jax.lax.stop_gradient
    mults = jnp.ones((2,), jnp.float32)
    d_params = variables["params"]
    d_stats = {k: v for k, v in variables.items() if k != "params"}
    rng_g, rng_anchor = jax.random.split(key)
    anchor = sg(jt._anchor_images(params, x, ri, bt, rng_anchor))

    def g_loss_fn(p):
        losses, out, _ = jt._g_losses(p, x, ri, bt, rng_g, mults)
        y_hat = out["quantized_code"]["y"]
        fake_pred, _ = jt._d_apply(sg(d_params), d_stats,
                                   out["fake_images"], ri, y_hat)
        anchor_pred, _ = jt._d_apply(sg(d_params), d_stats, anchor, ri, y_hat)
        losses["adv"] = jt._g_adv(fake_pred, anchor_pred)
        if jt._beta_weighting():
            total = losses["distortion"] + losses["rate"] + bt[0] * (
                losses["perceptual"] + losses["adv"])
        else:
            total = sum(losses.values())
        return total, (losses, out)

    (total, (losses, out)), g_grads = jax.value_and_grad(
        g_loss_fn, has_aux=True)(params)
    fake_sg, y_sg = sg(out["fake_images"]), sg(out["quantized_code"]["y"])

    def d_loss_fn(dp):
        real_pred, s1 = jt._d_apply(dp, d_stats, x, ri, y_sg)
        fake_pred, _ = jt._d_apply(dp, s1, fake_sg, ri, y_sg)
        l_real, l_fake = jt._d_loss(real_pred, fake_pred)
        return l_real + l_fake, {"d_real": l_real, "d_fake": l_fake,
                                 "out_d_real": jnp.mean(real_pred),
                                 "out_d_fake": jnp.mean(fake_pred)}

    (d_total, d_log), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(
        d_params)
    log = {**losses, "total": total, "d_total": d_total, **d_log}
    return log, g_grads, d_grads, out, anchor


def port_step(tr, u8, rate_ind, beta, noise):
    """One port step at the given controls and noise; counts the net's
    forwards.  Returns (log, the number of forwards)."""
    tr.sample_controls = lambda itr: (rate_ind, beta, (1.0, 1.0))
    tr.comp_model.noise = noise
    calls = []
    hook = tr.comp_model.net.register_forward_hook(
        lambda *a: calls.append(1))
    try:
        log = tr.optimize_parameters(1, {"real_images": u8})
    finally:
        hook.remove()
    return log, len(calls)


def _held(tr, ref_log, g_grads, d_grads, variables, log):
    for k, v in ref_log.items():
        assert log[k] == pytest.approx(v, rel=RTOL, abs=1e-7), k
    net = tr.comp_model.net
    ref = export_state_dict(jax.device_get(g_grads), net, True,
                            tr.comp_model.use_beta)
    got = 0
    for name, p in net.named_parameters():
        if name.endswith("quantiles"):  # its .grad is the aux step's
            continue
        mine = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel_l2(mine, ref[name]) <= GRAD_REL, name
        got += float(np.abs(ref[name].numpy()).max() > 0)
    assert got > 0.8 * len(ref)
    dref = export_discriminator_state(
        {"params": jax.device_get(d_grads),
         "batch_stats": variables.get("batch_stats", {})}, tr.discriminator)
    # the RGAN head bias's gradient is exactly 0 (the real and fake halves
    # cancel): there, f32 noise against noise, 5e-5 of the largest gradient
    top = max(float(np.linalg.norm(v.numpy())) for v in dref.values())
    moved = 0
    for name, p in tr.discriminator.named_parameters():
        mine = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float(np.linalg.norm((mine - dref[name]).numpy()))
        assert err <= GRAD_REL * float(np.linalg.norm(dref[name].numpy())) \
            + 5e-5 * top, name
        moved += p.grad is not None
    assert moved == len(dref) // 3  # the picked rate's sub-D only


@pytest.mark.parametrize("trainer,rate_ind", [
    (STAGE3, 0.0), (STAGE3, 2.0),
    ("GANRateDistortionTrainer", 1.0), ("RGANRateDistortionTrainer", 1.0),
    ("RaGANRateDistortionTrainer", 1.0)])
def test_gan_step_matches_jax_value_and_grad(tmp_path, trainer, rate_ind):
    tr, jt, params, variables = pair(tmp_path, trainer, MODEL if trainer ==
                                     STAGE3 else ADV_MODEL)
    u8 = images(2, 64, 64, 5)
    x = jnp.asarray(uint8_to_tensor(u8))
    key = jax.random.PRNGKey(3)
    ref_log, g_grads, d_grads, j_out, anchor, (k_anchor, k_g) = jax_step(
        jt, params, variables, x, rate_ind, BETA, key)
    ns = tr.comp_model.num_slices if tr.comp_model.use_charm else None
    top = rate_ind + 1 > tr.comp_model.rate_level - 1
    hrr = trainer == STAGE3
    draws = [_jax_noise(k_g, j_out, ns)]
    if hrr and not top:
        draws.insert(0, _jax_noise(k_anchor, j_out, ns))
    noise = Replay(*draws)
    log, forwards = port_step(tr, u8, rate_ind, BETA, noise)
    assert noise.drained()
    # the anchor: the batch at the top rate (one forward), else a forward
    assert forwards == (2 if hrr and not top else 1)
    if hrr and top or not hrr:
        np.testing.assert_array_equal(np.asarray(anchor), np.asarray(x))
    _held(tr, ref_log, g_grads, d_grads, variables, log)
    assert {"adv", "d_real", "d_fake", "d_total", "out_d_real",
            "out_d_fake"} <= set(log)


def test_every_gan_trainer_builds_from_its_name(tmp_path):
    for name in TRAINERS:
        assert name in TRAINER_REGISTRY.keys()
        tr = build_trainer(gan_cfg(tmp_path, name, exp=name), device="cpu")
        assert type(tr).__name__ == name
        assert tr.adv_mode == getattr(jax_gan, name).adv_mode
        assert tr._beta_weighting() == getattr(jax_gan, name)._beta_weighting(
            None)


def test_d_grad_is_empty_after_the_g_backward(tmp_path):
    tr = build_trainer(gan_cfg(tmp_path), device="cpu")
    x = tr.put_batch(_batches(tr, 1)[0]["real_images"])
    l_total, *_ = tr.gan_g_losses(x, 0.0, BETA)
    l_total.backward()
    assert all(p.grad is None for p in tr.discriminator.parameters())
    assert all(p.requires_grad for p in tr.discriminator.parameters())
    assert tr.comp_model.net.decoder.conv4.weight.grad is not None


def _snapshot(tr):
    out = {f"g.{k}": v.detach().clone()
           for k, v in tr.comp_model.net.named_parameters()}
    out.update({f"d.{k}": v.detach().clone()
                for k, v in tr.discriminator.state_dict().items()})
    for label, o in (("gopt", tr.g_opt), ("aux", tr.aux_opt),
                     ("dopt", tr.d_opt)):
        out.update({f"{label}.{k}": v.clone() for k, v in o.state.items()})
    return out


def test_nan_skip_holds_g_d_and_d_adam_but_moves_d_state(tmp_path):
    """JAX holds D's params and optimizer with G's skip flag, not D's
    stats (gan_trainer.py:246-256): a BatchNorm D's running moments move on
    a skipped step."""
    d_bn = dict(D_OPT, norm_type="BN")
    tr = build_trainer(gan_cfg(tmp_path, discriminator=d_bn), device="cpu")
    data = _batches(tr, 2)
    assert tr.optimize_parameters(1, data[0]) is not None
    before = _snapshot(tr)
    bad = {"real_images": uint8_like_nan(data[1]["real_images"])}
    assert tr.optimize_parameters(2, bad) is None  # skipped
    after = _snapshot(tr)
    stats = [k for k in after if k.endswith((".mean", ".var"))]
    assert stats
    for k, v in after.items():
        if k in stats:
            continue
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(after[k], before[k]) for k in stats)
    assert int(tr.d_opt.state["count"]) == 1


def _all_state(tr):
    out = _snapshot(tr)
    out["noise"] = tr.noise.generator.get_state()
    return out


def test_save_load_continue_is_bit_equal_with_d(tmp_path):
    a = build_trainer(gan_cfg(tmp_path), device="cpu")
    data = _batches(a, 4)
    for i in range(2):
        a.optimize_parameters(i + 1, data[i])
    a.save(2)
    ckpt = os.path.join(str(tmp_path), "gan", "model")
    assert os.path.exists(os.path.join(ckpt, "discriminator_iter2.ckpt"))
    for i in range(2, 4):
        a.optimize_parameters(i + 1, data[i])

    b = build_trainer(gan_cfg(tmp_path, start_iter=2), device="cpu")
    assert b.step == 2
    for i in range(2, 4):
        b.optimize_parameters(i + 1, data[i])
    sa, sb = _all_state(a), _all_state(b)
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.comp_model.sample_rate_ind() == b.comp_model.sample_rate_ind()

    # without load_discriminator D and its optimizer keep their init
    c = build_trainer(gan_cfg(tmp_path, exp="c"), device="cpu")
    d0 = {k: v.clone() for k, v in c.discriminator.state_dict().items()}
    c.load_checkpoint("gan", 2, load_discriminator=False)
    for k, v in c.discriminator.state_dict().items():
        assert torch.equal(v, d0[k]), k
    assert int(c.d_opt.state["count"]) == 0 and int(c.g_opt.state["count"]) == 2


def test_a_d_checkpoint_that_does_not_fit_keeps_d_at_init(tmp_path):
    """As JAX's ``_restore_like``: reported and D left whole at its init,
    or, with ``strict_resume``, an error."""
    a = build_trainer(gan_cfg(tmp_path), device="cpu")
    a.optimize_parameters(1, _batches(a, 1)[0])
    a.save(1)
    wider = dict(D_OPT, main_ch=16)
    b = build_trainer(gan_cfg(tmp_path, exp="b", discriminator=wider),
                      device="cpu")
    d0 = {k: v.clone() for k, v in b.discriminator.state_dict().items()}
    b.load_checkpoint("gan", 1)
    for k, v in b.discriminator.state_dict().items():
        assert torch.equal(v, d0[k]), k
    c = build_trainer(gan_cfg(tmp_path, exp="c", discriminator=wider,
                              strict_resume=True), device="cpu")
    with pytest.raises(ValueError, match="strict_resume"):
        c.load_checkpoint("gan", 1)


def test_cli_trains_stage3_writes_d_and_resumes(tmp_path):
    opt = gan_dict(tmp_path / "ck", exp="cli_gan")
    opt.pop("exp")
    cfg_path = str(tmp_path / "cli_gan.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opt, f)
    args = [cfg_path, "-d", "cpu", "-ti", "2", "-s", "2", "-l", "1",
            "-e", "1000"]
    main(args)
    job = tmp_path / "ck" / "cli_gan"
    for name in ("comp_model_iter2.ckpt", "training_state_iter2.ckpt",
                 "discriminator_iter2.ckpt"):
        assert (job / "model" / name).exists(), name
    d2 = torch.load(job / "model" / "discriminator_iter2.ckpt",
                    weights_only=True)["discriminator"]
    main([cfg_path, "-d", "cpu", "-ti", "3", "-s", "1", "-l", "1", "-e",
          "1000", "--auto_resume"])
    assert (job / "model" / "discriminator_iter3.ckpt").exists()
    d3 = torch.load(job / "model" / "discriminator_iter3.ckpt",
                    weights_only=True)["discriminator"]
    assert set(d2) == set(d3) and any(not torch.equal(d2[k], d3[k])
                                      for k in d2)
    with open(job / "log_loss.csv") as f:
        rows = f.read().splitlines()
    assert rows[0].split(",").count("out_d_real") == 1 and len(rows) == 4
