"""Loss construction (counterpart of ``crdr_tpu/losses/__init__.py``;
reference src/losses/__init__.py:13): the rate-distortion losses, LPIPS and
the GAN losses of stage 3."""

from __future__ import annotations

import copy
from typing import Dict

from ..utils.config import ConfigDict
from ..utils.registry import LOSS_REGISTRY

from . import (distortion_loss, gan_loss, perceptual_loss,  # noqa: F401
               rate_loss)


def build_loss(opt: Dict):
    opt = copy.deepcopy(dict(opt))
    loss_type = opt.pop("type")
    opt = {k: (v.to_dict() if isinstance(v, ConfigDict) else v)
           for k, v in opt.items()}
    return LOSS_REGISTRY.get(loss_type)(**opt)
