"""Rate losses (counterpart of ``crdr_tpu/losses/rate_loss.py``; reference
src/losses/rate_loss.py).

The HiFiC lambda switch (``lambda_A if qbpp > target else lambda_B``) stays
on the device (``torch.where`` on the detached mean qbpp), so a step makes
no host sync.  The per-rate-level lists are indexed on the host with the
step's ``rate_ind`` (a number, sampled on the host), and the schedules are
resolved on the host from the iteration (``schedule_mults``), as in JAX.
The switch compares the mean qbpp of the *global* batch: in a
data-parallel run the trainer passes ``batch_mean``, the mean over the
ranks (``parallel/distributed.py::batch_mean``), so every rank picks the
same lambda, the one JAX picks over the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

import torch

from ..utils.registry import LOSS_REGISTRY


def _check_schedule(schedule: Optional[Dict]) -> None:
    if schedule is None:
        return
    if "vals" not in schedule or "steps" not in schedule or \
            len(schedule["vals"]) != len(schedule["steps"]) + 1:
        raise ValueError(f"a schedule needs len(vals) == len(steps) + 1: "
                         f"{schedule}")


def get_scheduled_params(param: float, schedule: Dict, step: int) -> float:
    vals, steps = schedule["vals"], schedule["steps"]
    idx = int(np.where(step < np.array(list(steps) + [step + 1]))[0][0])
    return param * vals[idx]


def _switch(bpp, qbpp, la, lb, tgt, batch_mean=None):
    mean_q = (batch_mean or torch.mean)(qbpp.detach())
    weight = torch.where(mean_q > tgt, la, lb)
    return weight * torch.mean(bpp)


@LOSS_REGISTRY.register()
class RateLoss:
    def __init__(self, loss_weight: float):
        self.lamb_rate = loss_weight

    def __call__(self, bpp, qbpp=None, **kwargs):
        return self.lamb_rate * torch.mean(bpp)


@LOSS_REGISTRY.register()
class HificRateLoss:
    """lambda_A when the quantized bpp exceeds the target, else lambda_B."""

    def __init__(self, lambda_A: float, lambda_B: float, target_rate: float,
                 lambda_schedule: Optional[Dict] = None,
                 target_rate_schedule: Optional[Dict] = None):
        if not lambda_A > lambda_B:
            raise ValueError(
                f"expected lambda_A > lambda_B, got {lambda_A} <= {lambda_B}")
        self.lambda_A = lambda_A
        self.lambda_B = lambda_B
        self.target_rate = target_rate
        _check_schedule(lambda_schedule)
        _check_schedule(target_rate_schedule)
        self.lambda_schedule = lambda_schedule
        self.target_rate_schedule = target_rate_schedule

    def schedule_mults(self, current_iter: int):
        """(lambda multiplier, target multiplier) at this iteration."""
        lm = get_scheduled_params(1.0, self.lambda_schedule, current_iter) \
            if self.lambda_schedule else 1.0
        tm = get_scheduled_params(1.0, self.target_rate_schedule,
                                  current_iter) \
            if self.target_rate_schedule else 1.0
        return lm, tm

    def __call__(self, bpp, qbpp, lambda_mult=1.0, target_mult=1.0,
                 batch_mean=None, **kwargs):
        return _switch(bpp, qbpp, self.lambda_A * lambda_mult,
                       self.lambda_B * lambda_mult,
                       self.target_rate * target_mult, batch_mean)


@LOSS_REGISTRY.register()
class HificVariableRateLoss(HificRateLoss):
    """Per-rate-level lambda_A / lambda_B / target lists indexed by
    ``rate_ind`` (a number)."""

    def __init__(self, lambda_A: List[float],
                 lambda_B: Union[List[float], float],
                 target_rate: List[float],
                 lambda_schedule: Optional[Dict] = None,
                 target_rate_schedule: Optional[Dict] = None):
        if isinstance(lambda_B, float):
            lambda_B = [lambda_B] * len(lambda_A)
        if not len(lambda_A) == len(lambda_B) == len(target_rate):
            raise ValueError("lambda_A, lambda_B and target_rate differ in "
                             "length")
        if sorted(target_rate) != list(target_rate) or \
                sorted(lambda_A, reverse=True) != list(lambda_A) or \
                any(a <= b for a, b in zip(lambda_A, lambda_B)):
            raise ValueError("need target_rate ascending, lambda_A "
                             "descending and lambda_A > lambda_B")
        self.lambda_A = list(lambda_A)
        self.lambda_B = list(lambda_B)
        self.target_rate = list(target_rate)
        _check_schedule(lambda_schedule)
        _check_schedule(target_rate_schedule)
        self.lambda_schedule = lambda_schedule
        self.target_rate_schedule = target_rate_schedule

    def __call__(self, bpp, qbpp, rate_ind, lambda_mult=1.0,
                 target_mult=1.0, batch_mean=None, **kwargs):
        i = int(rate_ind)
        return _switch(bpp, qbpp, self.lambda_A[i] * lambda_mult,
                       self.lambda_B[i] * lambda_mult,
                       self.target_rate[i] * target_mult, batch_mean)
