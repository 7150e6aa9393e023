"""GAN trainers: vanilla, relativistic (RGAN / RaGAN) and the multi-rate
high-rate-relative (HRRGAN) beta-conditioned trainer of stage 3 (counterpart
of ``crdr_tpu/trainer/gan_trainer.py``; reference src/trainer/*.py).

A step, as JAX's ``step_fn`` (:160-259), run eagerly with no host sync:

1. the anchor, from the pre-step parameters, without a graph (the net in
   train mode, its own noise draws, drawn first): the batch itself for the
   vanilla / RGAN / RaGAN trainers and, for HRRGAN, the net's output at
   ``rate_ind + 1``, or the batch at the top rate (decided on the host).  It
   gets the f32 batch, as JAX's does; only the G forward's batch goes to
   bf16 under ``mixed_precision``;
2. the G step: the training forward and its losses, plus ``adv`` from D's
   logits on the fake and (detached) on the anchor, with D's parameters
   frozen (``requires_grad`` off while D runs, so its ``.grad`` stays empty)
   and its state held (``update_stats=False``).  ``l_total`` is the sum of
   the losses, or ``distortion + rate + beta * (perceptual + adv)`` for the
   beta-conditioned trainers.  Then the G optimizer and the aux step on the
   updated parameters, as the RD trainer does;
3. the D step: D on the true batch, then on the detached fake, its state
   chained real -> fake; ``real * 0.5 + fake * 0.5`` with the RGAN / RaGAN
   stop-gradients; D's own optimizer (``optim.d_optimizer`` /
   ``d_scheduler``, no clipping).  G's skip flag also holds D's parameters
   and D's optimizer state, not D's state (BatchNorm's moments, spectral
   norm's ``u`` / ``sigma``), as in JAX.

The log adds ``adv``, ``d_real``, ``d_fake``, ``d_total``, ``out_d_real``
and ``out_d_fake`` (the mean logits) as device scalars.

Data parallel (``base_trainer.py``): G's and D's flat gradient buffers are
averaged over the ranks, ``rate_ind`` (which picks D's conditioning) comes
from the shared host sequence, and RaGAN's mean logits are the global
batch's (the trainer's ``batch_mean``, with its gradient).  A
discriminator with BatchNorm (``norm_type: BN``) raises on more than one
rank: its statistics would be the rank's, where JAX's SPMD takes the
global batch's.

D is built at construction from ``opt.discriminator``, every parameter drawn
from a generator seeded with ``seed + 1`` (JAX inits D with
``PRNGKey(seed + 1)``; the values differ).  A checkpoint adds
``discriminator_iter{N}.ckpt`` (``{"discriminator": D's state_dict}``,
parameters and state; kept past the next save with
``keep_discriminator``), and the training state adds D's optimizer state.
``load_checkpoint(load_discriminator=True)`` restores both, so a resume is
bit-equal with D included.  JAX saves D's params and stats and restores its
params only, D's optimizer starting afresh; the port keeps the resume
bit-equal instead.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..losses import build_loss
from ..nn.norm import BatchNorm2D
from ..subnet.discriminator import build_discriminator
from ..utils.path import PathHandler
from ..utils.registry import TRAINER_REGISTRY
from ..utils.saver import load_checkpoint
from .optimizer import build_optimizer
from .rd_trainer import RateDistortionTrainer

Tensor = torch.Tensor


@TRAINER_REGISTRY.register()
class GANRateDistortionTrainer(RateDistortionTrainer):
    adv_mode = "vanilla"  # vanilla | rgan | ragan

    def set_models(self) -> None:
        super().set_models()
        g = torch.Generator(device=self.device).manual_seed(
            int(self.opt.get("seed", 0)) + 1)
        with self.device:
            self.discriminator = build_discriminator(self.opt.discriminator,
                                                     g)
        if self.world > 1 and any(isinstance(m, BatchNorm2D)
                                  for m in self.discriminator.modules()):
            raise NotImplementedError(
                f"a discriminator with BatchNorm (norm_type: BN) on "
                f"{self.world} ranks: its statistics would be each rank's, "
                "not the global batch's")
        self.discriminator.requires_grad_(True)

    def set_losses(self) -> None:
        super().set_losses()
        self.gan_loss = build_loss(self.opt.loss.gan_loss)

    def set_optimizer_scheduler(self) -> None:
        super().set_optimizer_scheduler()
        optim_opt = self.opt.optim
        self.d_opt = build_optimizer(
            list(self.discriminator.named_parameters()),
            optim_opt.d_optimizer, optim_opt.get("d_scheduler"),
            grad_mean=self.grad_mean)

    def optimizers(self):
        return super().optimizers() + [self.d_opt]

    def print_models(self) -> None:
        super().print_models()
        self.logger.info(str(self.discriminator))

    # ------------------ D and the adversarial terms ------------------

    def d_apply(self, x: Tensor, rate_ind: float, y_hat: Tensor,
                update_stats: bool) -> Tensor:
        """D's logits on ``x`` (``_d_apply``)."""
        return self.discriminator(
            x, rate_ind if self.comp_model.use_rate else None, y_hat,
            update_stats=update_stats)

    def _g_adv(self, fake_pred: Tensor, anchor_pred: Tensor) -> Tensor:
        """G's adversarial loss from D(fake) (live) and D(anchor)."""
        anchor_pred = anchor_pred.detach()
        loss = self.gan_loss
        if self.adv_mode == "vanilla":
            return loss(fake_pred, is_real=True, is_disc=False)
        if self.adv_mode == "rgan":
            return (loss(anchor_pred - fake_pred, is_real=False, is_disc=False)
                    + loss(fake_pred - anchor_pred, is_real=True,
                           is_disc=False)) / 2.0
        if self.adv_mode == "ragan":
            mean = self.batch_mean
            return (loss(anchor_pred - mean(fake_pred), is_real=False,
                         is_disc=False)
                    + loss(fake_pred - mean(anchor_pred), is_real=True,
                           is_disc=False)) / 2.0
        raise ValueError(self.adv_mode)

    def _d_loss(self, real_pred: Tensor, fake_pred: Tensor):
        """(real, fake) halves of D's loss."""
        loss = self.gan_loss
        if self.adv_mode == "vanilla":
            real, fake = real_pred, fake_pred
        elif self.adv_mode == "rgan":
            real = real_pred - fake_pred.detach()
            fake = fake_pred - real_pred.detach()
        elif self.adv_mode == "ragan":
            real = real_pred - self.batch_mean(fake_pred.detach())
            fake = fake_pred - self.batch_mean(real_pred.detach())
        else:
            raise ValueError(self.adv_mode)
        return (loss(real, is_real=True, is_disc=True) * 0.5,
                loss(fake, is_real=False, is_disc=True) * 0.5)

    def _anchor_images(self, batch: Tensor, rate_ind: float,
                       beta: float) -> Tensor:
        """The 'real' reference of the adversarial comparison."""
        return batch

    def _beta_weighting(self) -> bool:
        """Whether l_total = dist + rate + beta * (percep + adv)."""
        return False

    # ------------------ the step ------------------

    def gan_g_losses(self, batch: Tensor, rate_ind: float, beta: float,
                     mults=(1.0, 1.0)):
        """The anchor, then the G forward with its losses and ``adv``:
        (l_total, losses, the net's output, the rate summary)."""
        with torch.no_grad():
            anchor = self._anchor_images(batch, rate_ind, beta)
        losses, out, summary = self._g_losses(batch, rate_ind, beta,
                                              self.noise, mults)
        y_hat = out["quantized_code"]["y"].detach()
        self.discriminator.requires_grad_(False)
        try:
            fake_pred = self.d_apply(out["fake_images"], rate_ind, y_hat,
                                     False)
            anchor_pred = self.d_apply(anchor, rate_ind, y_hat, False)
        finally:
            self.discriminator.requires_grad_(True)
        losses["adv"] = self._g_adv(fake_pred, anchor_pred)
        if self._beta_weighting():
            l_total = losses["distortion"] + losses["rate"] + beta * (
                losses["perceptual"] + losses["adv"])
        else:
            l_total = sum(losses.values())
        return l_total, losses, out, summary

    def gan_d_losses(self, batch: Tensor, fake: Tensor, y_hat: Tensor,
                     rate_ind: float) -> Dict[str, Tensor]:
        """D on the true batch, then on the (detached) fake, its state
        chained: the D step's loss terms and mean logits."""
        real_pred = self.d_apply(batch, rate_ind, y_hat, True)
        fake_pred = self.d_apply(fake, rate_ind, y_hat, True)
        l_real, l_fake = self._d_loss(real_pred, fake_pred)
        return {"d_real": l_real, "d_fake": l_fake, "d_total": l_real + l_fake,
                "out_d_real": torch.mean(real_pred),
                "out_d_fake": torch.mean(fake_pred)}

    def optimize_parameters_device(self, itr: int, data: Dict
                                   ) -> Dict[str, Tensor]:
        if self.micro_batches > 1:
            raise NotImplementedError("micro_batches: the rate-distortion "
                                      "trainer's alone")
        batch = self.put_batch(data["real_images"])
        rate_ind, beta, mults = self.sample_controls(itr)
        l_total, losses, out, summary = self.gan_g_losses(batch, rate_ind,
                                                          beta, mults)
        log, skip = self._g_update([l_total], [losses], [summary])
        d = self.gan_d_losses(batch, out["fake_images"].detach(),
                              out["quantized_code"]["y"].detach(), rate_ind)
        self.d_opt.zero_grad()
        d["d_total"].backward()
        self.d_opt.step(skip)
        log.update({k: v.detach() for k, v in d.items()})
        self.step += 1
        return log

    # ------------------ save / load ------------------

    def training_state(self) -> Dict:
        return {**super().training_state(),
                "d_opt_state": self.d_opt.state_dict()}

    def save(self, current_iter: int) -> None:
        super().save(current_iter)
        if self.rank != 0:
            return
        state = {k: v.detach().cpu()
                 for k, v in self.discriminator.state_dict().items()}
        self.model_saver.save({"discriminator": state}, "discriminator",
                              current_iter,
                              keep=self.opt.get("keep_discriminator", False))

    def load_checkpoint(self, exp: str, itr: int, load_optimizer: bool = True,
                        load_discriminator: bool = True, **kwargs) -> None:
        """As the RD trainer's, and with ``load_discriminator`` D's
        parameters and state and (with ``load_optimizer``) D's optimizer
        state.  A D checkpoint that does not fit D raises with
        ``strict_resume``, else is reported and D keeps its init."""
        self._load_d = load_discriminator
        super().load_checkpoint(exp, itr, load_optimizer=load_optimizer,
                                **kwargs)
        if not load_discriminator:
            return
        path = PathHandler(self.opt.ckpt_root, exp).get_ckpt_path(
            "discriminator", itr)
        try:
            ckpt = load_checkpoint(path)
        except FileNotFoundError:
            self.logger.warning(f"no discriminator checkpoint at {path}")
            return
        saved, own = ckpt["discriminator"], self.discriminator.state_dict()
        shapes = lambda sd: {k: tuple(v.shape) for k, v in sd.items()}
        if shapes(saved) != shapes(own):
            msg = ("the discriminator checkpoint does not fit the "
                   "discriminator (the model changed between save and "
                   "resume)")
            if self.opt.get("strict_resume", False):
                raise ValueError(msg + " (strict_resume is set)")
            self.logger.warning(msg + "; it keeps its init")
            return
        self.discriminator.load_state_dict(saved, strict=True)

    def _restore_training_state(self, ts: Dict) -> None:
        super()._restore_training_state(ts)
        if getattr(self, "_load_d", True):
            self._restore_optimizer("d_opt_state", self.d_opt, ts)


@TRAINER_REGISTRY.register()
class RGANRateDistortionTrainer(GANRateDistortionTrainer):
    adv_mode = "rgan"


@TRAINER_REGISTRY.register()
class RaGANRateDistortionTrainer(GANRateDistortionTrainer):
    adv_mode = "ragan"


@TRAINER_REGISTRY.register()
class BetaCondRGANRateDistortionTrainer(RGANRateDistortionTrainer):
    """RGAN against the true images, perceptual + adv weighted by beta
    (reference beta_cond_rgan_rate_distortion_trainer.py:48)."""

    def _beta_weighting(self) -> bool:
        return True


@TRAINER_REGISTRY.register()
class MultirateHighRateRGANRateDistortionTrainer(RGANRateDistortionTrainer):
    """HRRGAN: the relativistic anchor is the model's own output at
    rate_ind + 1, or the true image at the top rate."""

    relative_score_rate_delta = 1

    def _anchor_images(self, batch: Tensor, rate_ind: float,
                       beta: float) -> Tensor:
        model = self.comp_model
        high = rate_ind + self.relative_score_rate_delta
        if high > model.rate_level - 1:
            return batch
        full = lambda v: torch.full((1,), float(v), dtype=batch.dtype,
                                    device=batch.device)
        out = model.net(batch, full(high),
                        full(beta) if model.use_beta else None, self.noise)
        return out["fake_images"]


@TRAINER_REGISTRY.register()
class MultirateBetaCondHrrGanRateDistortionTrainer(
        MultirateHighRateRGANRateDistortionTrainer):
    """Stage 3: HRRGAN + the beta-weighted loss
    (reference multirate_hr_rgan_beta_cond_rate_distortion_trainer.py:31-64)."""

    def _beta_weighting(self) -> bool:
        return True
