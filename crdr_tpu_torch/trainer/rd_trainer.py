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

``micro_batches`` k > 1 (an attribute, 1 by default) takes each batch in k
blocks as k data-parallel ranks take their rows (``base_trainer.py``), in
one process: block j's forward on its rows of the batch's noise (the
generator rewound for each), the rate loss's switch on the mean of the
blocks' mean qbpp, each block's loss gradient added into the buffers and
divided by k, the skip and the logs on the mean over the blocks.  With two
blocks the parameters are bit for bit those of two ranks (one batch of
all the rows sums in other orders): the one-process reference of the
data-parallel tests.  Every block's graph is held until the backward, so it
saves no memory.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..entropy import UniformNoise
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


def _mean(values: List[Tensor]) -> Tensor:
    """The mean of per-block device scalars (one block: itself)."""
    return values[0] if len(values) == 1 else sum(values) / len(values)


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
            optim_opt.get("clip_max_norm", None), self.grad_mean)
        self.aux_opt = build_optimizer(
            [(n, p) for n, p in named if _is_quantiles(n)],
            optim_opt.aux_optimizer, grad_mean=self.grad_mean) \
            if optim_opt.get("aux_optimizer") else None

    def optimizers(self):
        return [o for o in (self.g_opt, self.aux_opt) if o is not None]

    # ------------------ the step ------------------

    def _g_losses(self, batch: Tensor, rate_ind: float, beta: float, noise,
                  mults=(1.0, 1.0)):
        """The training forward and the G-side losses on an NCHW f32 batch
        (f64 for a reference step, the net and losses cast to it): (losses,
        the net's output, the rate summary)."""
        out, summary, fake = self._g_forward(batch, rate_ind, beta, noise)
        return self._g_terms(batch, fake, summary, rate_ind, mults,
                             self.batch_mean), out, summary

    def _g_forward(self, batch: Tensor, rate_ind: float, beta: float, noise):
        """The training forward: (the net's output, the rate summary, the
        reconstruction in the batch's dtype)."""
        model = self.comp_model
        full = lambda v: torch.full((1,), float(v), dtype=batch.dtype,
                                    device=self.device)
        x_in = batch.to(torch.bfloat16) \
            if self.opt.get("mixed_precision", False) else batch
        out = model.net(x_in, full(rate_ind) if model.use_rate else None,
                        full(beta) if model.use_beta else None, noise)
        summary = _rate_summary(out, batch.shape[2] * batch.shape[3])
        return out, summary, out["fake_images"].to(batch.dtype)

    def _g_terms(self, batch: Tensor, fake: Tensor, summary, rate_ind: float,
                 mults, batch_mean) -> Dict[str, Tensor]:
        """The G-side losses of a forward; the rate loss switches on
        ``batch_mean`` of the detached qbpp."""
        losses = {
            "distortion": self.distortion_loss(batch, fake),
            "rate": self.rate_loss(summary["bpp"], summary["qbpp"],
                                   rate_ind=rate_ind, lambda_mult=mults[0],
                                   target_mult=mults[1],
                                   batch_mean=batch_mean),
        }
        if self.perceptual_loss is not None:
            losses["perceptual"] = self.perceptual_loss(batch, fake)
        return losses

    def _block_losses(self, batch: Tensor, rate_ind: float, beta: float,
                      mults):
        """The G-side losses of ``batch`` in ``micro_batches`` blocks
        (module doc): (each block's losses, each block's rate summary)."""
        k = self.micro_batches
        gen = self.noise.generator
        start = gen.get_state()
        blocks = []
        for j, block in enumerate(batch.chunk(k)):
            gen.set_state(start)
            noise = UniformNoise(gen, self.rank * k + j, self.world * k)
            blocks.append((block, *self._g_forward(block, rate_ind, beta,
                                                   noise)[1:]))
        q = self.batch_mean(_mean([torch.mean(s["qbpp"].detach())
                                   for _, s, _ in blocks]))
        return ([self._g_terms(b, f, s, rate_ind, mults, lambda _: q)
                 for b, s, f in blocks], [s for _, s, _ in blocks])
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
        """One optimization step (in ``micro_batches`` blocks: module doc);
        its log as device scalars (no host sync)."""
        batch = self.put_batch(data["real_images"])
        rate_ind, beta, mults = self.sample_controls(itr)
        if self.micro_batches > 1:
            losses, summaries = self._block_losses(batch, rate_ind, beta,
                                                   mults)
        else:
            one, _, summary = self._g_losses(batch, rate_ind, beta,
                                             self.noise, mults)
            losses, summaries = [one], [summary]
        log, _ = self._g_update([sum(ls.values()) for ls in losses], losses,
                                summaries)
        self.step += 1
        return log

    def _g_update(self, totals: List[Tensor],
                  losses: List[Dict[str, Tensor]],
                  summaries: List[Dict[str, Tensor]]):
        """The backward of each block's total loss (one block but with
        ``micro_batches``), the gradients' mean over the blocks, the main
        optimizer step, then the aux loss and step on the updated
        parameters, both held where the blocks' mean loss is anomalous:
        (the log, the blocks' means as device scalars; the skip flag)."""
        self.g_opt.zero_grad()
        for t in totals:
            t.backward()
        if len(totals) > 1:
            torch._foreach_div_([p.grad for p in self.g_opt.params
                                 if p.grad is not None], len(totals))
        l_total = _mean([t.detach() for t in totals])
        skip = self.loss_anomaly_flag(l_total)
        self.g_opt.step(skip)
        log = {**{k: _mean([ls[k].detach() for ls in losses])
                  for k in losses[0]},
               "total": l_total,
               "qbpp": _mean([torch.mean(s["qbpp"]).detach()
                              for s in summaries]),
               "bpp": _mean([torch.mean(s["bpp"]).detach()
                             for s in summaries]), "skipped": skip}
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
        """The checkpoint of ``current_iter``, from rank 0 alone."""
        if self.rank != 0:
            return
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
