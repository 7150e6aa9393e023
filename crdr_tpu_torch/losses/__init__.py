"""Loss construction (counterpart of ``crdr_tpu/losses/__init__.py``;
reference src/losses/__init__.py:13).  The port has the rate-distortion
losses and LPIPS; the GAN losses come with stage 3."""

from __future__ import annotations

import copy
from typing import Dict

from ..utils.config import ConfigDict
from ..utils.registry import LOSS_REGISTRY

from . import distortion_loss, perceptual_loss, rate_loss  # noqa: F401


def build_loss(opt: Dict):
    opt = copy.deepcopy(dict(opt))
    loss_type = opt.pop("type")
    opt = {k: (v.to_dict() if isinstance(v, ConfigDict) else v)
           for k, v in opt.items()}
    return LOSS_REGISTRY.get(loss_type)(**opt)
