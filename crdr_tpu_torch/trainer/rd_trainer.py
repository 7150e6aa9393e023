"""Rate-distortion trainer, stages 1 and 2 (counterpart of
``crdr_tpu/trainer/rd_trainer.py``; reference rate_distortion_trainer.py).

A step: the training forward (noise / STE quantization) -> distortion +
rate (+ perceptual) losses -> gradients -> the clipped main optimizer step
-> the aux loss on the *updated* parameters -> the aux step on
``quantiles``, with the NaN / Inf / >1e4 skip keeping the whole state
(parameters, both optimizers' moments and step counts).  ``rate_ind`` /
``beta`` are sampled on the host from the model's numpy generator, the
noise on the device from the model's ``torch.Generator``.

The main optimizer covers every parameter but ``quantiles`` and the aux
optimizer ``quantiles`` only.  JAX's main optimizer covers ``quantiles``
too, but their main-loss gradient is exactly zero (the bottleneck's
medians are detached), and Adam leaves a parameter with zero gradients
where it is, so the update is the same.

A checkpoint is two ``torch.save`` files: ``comp_model_iter{N}.ckpt``
(``{"iter", "comp_model": state_dict}``, which ``load_learned_weight`` reads
for the stage handoff) and ``training_state_iter{N}.ckpt`` (both
optimizers' states and the numpy and torch generators' states), so the
parameters, both optimizers, the noise and the sampled controls go on
bit for bit after a resume; the data order starts again from the seed, as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..losses import build_loss
from ..models.comp_model import _rate_summary
from ..utils.path import PathHandler
from ..utils.registry import TRAINER_REGISTRY
from ..utils.saver import load_checkpoint
from .base_trainer import BaseTrainer
from .optimizer import build_optimizer

Tensor = torch.Tensor


def _is_quantiles(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


@TRAINER_REGISTRY.register()
class RateDistortionTrainer(BaseTrainer):
    def set_losses(self) -> None:
        loss_opt = self.opt.loss
        self.distortion_loss = build_loss(loss_opt.distortion_loss)
        self.rate_loss = build_loss(loss_opt.rate_loss)
        if loss_opt.get("perceptual_loss"):
            self.perceptual_loss = build_loss(loss_opt.perceptual_loss).to(
                self.device)
        else:
            self.logger.warning("perceptual_loss is NOT built")
            self.perceptual_loss = None

    def set_optimizer_scheduler(self) -> None:
        optim_opt = self.opt.optim
        named = list(self.comp_model.net.named_parameters())
        self.g_opt = build_optimizer(
            [(n, p) for n, p in named if not _is_quantiles(n)],
            optim_opt.g_optimizer, optim_opt.get("g_scheduler"),
            optim_opt.get("clip_max_norm", None))
        self.aux_opt = build_optimizer(
            [(n, p) for n, p in named if _is_quantiles(n)],
            optim_opt.aux_optimizer) if optim_opt.get("aux_optimizer") \
            else None

    # ------------------ the step ------------------

    def _g_losses(self, batch: Tensor, rate_ind: float, beta: float, noise,
                  mults=(1.0, 1.0)):
        """The training forward and the G-side losses on an NCHW f32 batch
        (f64 for a reference step, the net and losses cast to it): (losses,
        the net's output, the rate summary)."""
        model = self.comp_model
        full = lambda v: torch.full((1,), float(v), dtype=batch.dtype,
                                    device=self.device)
        x_in = batch.to(torch.bfloat16) \
            if self.opt.get("mixed_precision", False) else batch
        out = model.net(x_in, full(rate_ind) if model.use_rate else None,
                        full(beta) if model.use_beta else None, noise)
        summary = _rate_summary(out, batch.shape[2] * batch.shape[3])
        fake = out["fake_images"].to(batch.dtype)
        losses = {
            "distortion": self.distortion_loss(batch, fake),
            "rate": self.rate_loss(summary["bpp"], summary["qbpp"],
                                   rate_ind=rate_ind, lambda_mult=mults[0],
                                   target_mult=mults[1]),
        }
        if self.perceptual_loss is not None:
            losses["perceptual"] = self.perceptual_loss(batch, fake)
        return losses, out, summary

    def sample_controls(self, itr: int):
        """(rate_ind, beta, schedule multipliers) of iteration ``itr``."""
        model = self.comp_model
        rate_ind = model.sample_rate_ind() if model.use_rate else 0.0
        beta = model.sample_beta() if model.use_beta else 0.0
        mults = self.rate_loss.schedule_mults(itr) \
            if hasattr(self.rate_loss, "schedule_mults") else (1.0, 1.0)
        return rate_ind, beta, mults

    def optimize_parameters_device(self, itr: int, data: Dict
                                   ) -> Dict[str, Tensor]:
        """One optimization step; its log as device scalars (no host
        sync)."""
        batch = self.put_batch(data["real_images"])
        rate_ind, beta, mults = self.sample_controls(itr)
        losses, _, summary = self._g_losses(batch, rate_ind, beta,
                                            self.noise, mults)
        log, _ = self._g_update(sum(losses.values()), losses, summary)
        self.step += 1
        return log

    def _g_update(self, l_total: Tensor, losses: Dict[str, Tensor],
                  summary: Dict[str, Tensor]):
        """The backward of ``l_total``, the main optimizer step, then the aux
        loss and step on the updated parameters, both held where the loss is
        anomalous: (the log as device scalars, the skip flag)."""
        self.g_opt.zero_grad()
        l_total.backward()
        skip = self.loss_anomaly_flag(l_total.detach())
        self.g_opt.step(skip)
        log = {**{k: v.detach() for k, v in losses.items()},
               "total": l_total.detach(),
               "qbpp": torch.mean(summary["qbpp"]).detach(),
               "bpp": torch.mean(summary["bpp"]).detach(), "skipped": skip}
        if self.aux_opt is not None:
            aux = self.comp_model.net.aux_loss()
            self.aux_opt.zero_grad()
            aux.backward()
            self.aux_opt.step(skip)
            log["aux"] = aux.detach()
        return log, skip

    # ------------------ save / load ------------------

    def training_state(self) -> Dict:
        """The optimizers' states, the step and the generators' states."""
        return {
            "step": self.step,
            "opt_state": self.g_opt.state_dict(),
            "aux_opt_state": self.aux_opt.state_dict()
            if self.aux_opt is not None else None,
            "np_rng": self.comp_model._np_rng.bit_generator.state,
            "noise_rng": self.noise.generator.get_state(),
        }

    def save(self, current_iter: int) -> None:
        state = {k: v.detach().cpu()
                 for k, v in self.comp_model.state_dict().items()}
        self.model_saver.save({"comp_model": state}, "comp_model",
                              current_iter, keep=True)
        self.model_saver.save(self.training_state(), "training_state",
                              current_iter,
                              keep=self.opt.get("keep_training_state", False))

    def load_checkpoint(self, exp: str, itr: int, load_optimizer: bool = True,
                        **kwargs) -> None:
        """The parameters of iteration ``itr`` of experiment ``exp`` and,
        with ``load_optimizer``, its training state: both optimizers, the
        step, the generators.  An optimizer state that does not fit the
        model (the model changed between save and resume) raises with
        ``strict_resume``, else is reported and left fresh."""
        ph = PathHandler(self.opt.ckpt_root, exp)
        ckpt = load_checkpoint(ph.get_ckpt_path("comp_model", itr))
        self.comp_model.load_state_dict(ckpt["comp_model"], strict=True)
        self.step = itr
        if load_optimizer:
            ts_path = ph.get_ckpt_path("training_state", itr)
            try:
                ts = load_checkpoint(ts_path)
            except FileNotFoundError:
                self.logger.warning(f"no training state at {ts_path}")
            else:
                self._restore_training_state(ts)
        self.logger.info(f"checkpoint loaded: exp={exp} iter={itr}")

    def _restore_training_state(self, ts: Dict) -> None:
        for name, optim in (("opt_state", self.g_opt),
                            ("aux_opt_state", self.aux_opt)):
            self._restore_optimizer(name, optim, ts)
        self.comp_model._np_rng.bit_generator.state = ts["np_rng"]
        self.noise.generator.set_state(ts["noise_rng"])
        self.step = int(ts["step"])

    def _restore_optimizer(self, name: str, optim, ts: Dict) -> None:
        """``ts[name]`` into ``optim``; one that does not fit raises with
        ``strict_resume``, else is reported and ``optim`` starts afresh."""
        if optim is None or ts.get(name) is None:
            return
        try:
            optim.load_state_dict(ts[name])
        except ValueError as e:
            msg = (f"optimizer state '{name}' does not match the current "
                   f"parameters ({e}): the model changed between save and "
                   "resume")
            if self.opt.get("strict_resume", False):
                raise ValueError(msg + " (strict_resume is set)") from e
            self.logger.warning(msg + "; this optimizer starts afresh")
