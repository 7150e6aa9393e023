"""Optimizer / LR-schedule construction from config: optax's arithmetic on
flat device buffers (counterpart of ``crdr_tpu/trainer/optimizer.py``,
which builds them on optax; reference
src/trainer/optimizer/build_optimizer_scheduler.py).

``Optimizer`` is ``chain(clip_by_global_norm, adam / adamw / sgd)`` with its
learning-rate schedule (``MultiStepLR``: optax's
``piecewise_constant_schedule``; ``CosineLR``: ``cosine_decay_schedule``),
over a list of parameters.  It copies optax's formulas, not
``torch.optim``'s:

* clipping scales by ``max_norm / norm`` only where ``norm >= max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6`` always);
* Adam's bias corrections divide the moments, ``eps`` is added outside the
  square root, and the step is ``-lr(count) * update``, where ``count`` is
  the number of steps taken so far (the schedule's milestones count steps
  taken, not calls).

The parameters live in one flat buffer, built with the optimizer: each is
a view into it, starting ``ALIGN`` elements apart (512 bytes, as the
caching allocator aligns a tensor, so the convolutions see the pointers
they would see without it; the padding stays zero).  A step copies the
gradients into a second flat buffer in one ``_foreach_copy_`` and updates
the parameters in place, a few dozen kernel launches whatever the
parameter count.  ``step(skip)`` takes a 0-dim bool device tensor and,
where it is set, keeps the whole state: the parameters, the moments and
the step count (so the LR schedule does not advance either).  The skip is
decided on the device, and a step makes no host sync.

In a data-parallel run ``grad_mean`` (``parallel/distributed.py::
all_reduce_mean_``) averages the flat gradient buffer over the ranks, one
collective a step, before the clip and the update, so every rank takes the
same step (the global batch's gradient).

``paramwise_opt`` (per-key-substring LR multipliers, first match wins) keys
on the port's parameter names, the reference torch names (the JAX package
matches its flax paths).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
ALIGN = 128  # elements between the starts of two parameters' views


def lr_schedule(base_lr: float, sched_opt: Optional[Dict]):
    """``count`` (an int64 device tensor) -> the LR as an f32 device
    tensor."""
    if not sched_opt:
        return lambda count: torch.full((), base_lr, dtype=torch.float32,
                                        device=count.device)
    stype = sched_opt.get("type", "MultiStepLR")
    if stype == "MultiStepLR":
        milestones = sorted(int(m) for m in sched_opt.get("milestones", []))
        gamma = float(sched_opt.get("gamma", 0.1))

        def multistep(count):
            v = torch.full((), base_lr, dtype=torch.float32,
                           device=count.device)
            for m in milestones:
                v = torch.where(count >= m, v * gamma, v)
            return v
        return multistep
    if stype == "CosineLR":
        decay_steps = float(sched_opt["decay_steps"])
        alpha = float(sched_opt.get("alpha", 0.0))

        def cosine(count):
            t = torch.clamp(count.to(torch.float32), max=decay_steps)
            decay = 0.5 * (1 + torch.cos(math.pi * t / decay_steps))
            return base_lr * ((1 - alpha) * decay + alpha)
        return cosine
    raise ValueError(f"unknown scheduler type: {stype}")


class Optimizer:
    def __init__(self, named_params: Sequence[Tuple[str, nn.Parameter]],
                 optim_opt: Dict, sched_opt: Optional[Dict] = None,
                 clip_max_norm: Optional[float] = None,
                 grad_mean: Optional[Callable[[Tensor], Tensor]] = None):
        self.grad_mean = grad_mean
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        if not self.params:
            raise ValueError("an optimizer over no parameters")
        self.otype = optim_opt.get("type", "Adam")
        if self.otype not in ("Adam", "AdamW", "SGD"):
            raise ValueError(f"unknown optimizer type: {self.otype}")
        base_lr = float(optim_opt.get("lr", 1e-4))
        if self.otype == "Adam":
            self.b1, self.b2 = (float(b) for b in
                                optim_opt.get("betas", (0.9, 0.999)))
            self.eps = float(optim_opt.get("eps", 1e-8))
        else:  # optax.adamw / optax.sgd take the library's defaults
            self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.weight_decay = float(optim_opt.get("weight_decay", 1e-2))
        self.momentum = float(optim_opt.get("momentum", 0.0))
        self.lr = lr_schedule(base_lr, sched_opt)
        self.clip = float(clip_max_norm) if clip_max_norm else None
        p0 = self.params[0]
        self.sizes = [p.numel() for p in self.params]
        self.offsets, n = [], 0
        for size in self.sizes:
            self.offsets.append(n)
            n += -(-size // ALIGN) * ALIGN
        self.flat = torch.zeros(n, dtype=torch.float32, device=p0.device)
        self.flat_grad = torch.zeros_like(self.flat)
        self.grads = []
        with torch.no_grad():
            for p, off, size in zip(self.params, self.offsets, self.sizes):
                view = self.flat[off:off + size].view_as(p)
                view.copy_(p)
                p.data = view
                self.grads.append(self.flat_grad[off:off + size].view_as(p))
        self.lr_mult = self._paramwise(optim_opt.get("paramwise_opt"), n, p0)
        self.state = {"count": torch.zeros((), dtype=torch.int64,
                                           device=p0.device)}
        moments = ("mu", "nu") if self.otype in ("Adam", "AdamW") \
            else ("trace",)
        for k in moments:
            self.state[k] = torch.zeros(n, dtype=torch.float32,
                                        device=p0.device)

    def _paramwise(self, rules, n: int, p0: Tensor) -> Optional[Tensor]:
        """Per-element LR multipliers of ``paramwise_opt``, or None."""
        if not rules:
            return None
        mult = torch.ones(n, dtype=torch.float32)
        for name, off, size in zip(self.names, self.offsets, self.sizes):
            for r in rules:
                if r["key"] in name:
                    mult[off:off + size] = float(r.get("lr_mult", 1.0))
                    break
        return mult.to(p0.device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, skip: Optional[Tensor] = None) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0);
        where ``skip`` (0-dim bool, on the device) is set, nothing
        changes."""
        have = [i for i, q in enumerate(self.params) if q.grad is not None]
        if len(have) < len(self.params):
            self.flat_grad.zero_()
        if have:
            torch._foreach_copy_([self.grads[i] for i in have],
                                 [self.params[i].grad for i in have])
        if self.grad_mean is not None:
            self.grad_mean(self.flat_grad)
        st = self.state
        g, p = self.flat_grad, self.flat
        if self.clip is not None:
            norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.clip, g, g / norm * self.clip)
        count = st["count"]
        count_inc = count + 1
        new = {"count": count_inc}
        if "mu" in st:
            new["mu"] = (1 - self.b1) * g + self.b1 * st["mu"]
            new["nu"] = (1 - self.b2) * (g * g) + self.b2 * st["nu"]
            c = count_inc.to(torch.float32)
            mu_hat = new["mu"] / (1 - torch.pow(self.b1, c))
            nu_hat = new["nu"] / (1 - torch.pow(self.b2, c))
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.otype == "AdamW":
                u = u + self.weight_decay * p
        else:
            new["trace"] = g + self.momentum * st["trace"]
            u = new["trace"]
        step = -self.lr(count)
        if self.lr_mult is not None:
            step = step * self.lr_mult
        p_new = p + step * u
        if skip is not None:
            p_new = torch.where(skip, p, p_new)
            new = {k: torch.where(skip, st[k], v) for k, v in new.items()}
        self.state = new
        p.copy_(p_new)

    def state_dict(self) -> Dict[str, Tensor]:
        """The state, with the parameters' sizes (the padded buffers alone
        would not tell two layouts apart)."""
        return {"sizes": torch.tensor(self.sizes),
                **{k: v.detach().cpu() for k, v in self.state.items()}}

    def load_state_dict(self, state: Dict[str, Tensor]) -> None:
        """Raises ValueError when ``state`` does not fit these parameters."""
        sizes = state.get("sizes")
        if sizes is None or sizes.tolist() != self.sizes or \
                set(state) - {"sizes"} != set(self.state) or any(
                tuple(state[k].shape) != tuple(v.shape)
                for k, v in self.state.items()):
            raise ValueError(
                f"optimizer state {({k: tuple(v.shape) for k, v in state.items()})}"
                f" does not fit {({k: tuple(v.shape) for k, v in self.state.items()})}"
                f" over parameters of sizes {self.sizes}")
        self.state = {k: state[k].to(v.device, v.dtype)
                      for k, v in self.state.items()}


def build_optimizer(named_params: Sequence[Tuple[str, nn.Parameter]],
                    optim_opt: Dict, sched_opt: Optional[Dict] = None,
                    clip_max_norm: Optional[float] = None,
                    grad_mean: Optional[Callable[[Tensor], Tensor]] = None
                    ) -> Optimizer:
    return Optimizer(named_params, optim_opt, sched_opt, clip_max_norm,
                     grad_mean)
