"""Trainer construction (counterpart of ``crdr_tpu/trainer/__init__.py``;
reference src/trainer/__init__.py:10): the rate-distortion trainer (stages
1 and 2) and the six GAN trainers (stage 3)."""

from __future__ import annotations

from ..utils.registry import TRAINER_REGISTRY
from . import gan_trainer, rd_trainer  # noqa: F401  (registration)
from .base_trainer import BaseTrainer


def build_trainer(opt, device=None) -> BaseTrainer:
    """The trainer of ``opt.trainer.type`` on ``device``: the GPU unless
    the caller passes ``device="cpu"`` (or the config's ``device`` says
    so); without a GPU the default raises."""
    return TRAINER_REGISTRY.get(opt.trainer.type)(opt, device)
