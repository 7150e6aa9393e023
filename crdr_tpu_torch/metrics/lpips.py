"""LPIPS (alex): the AlexNet feature stack + linear heads, NCHW.

Counterpart of ``crdr_tpu/metrics/lpips.py`` (the `lpips` package's
architecture, used by the reference at src/losses/perceptual_loss.py:11-30):
inputs in [-1, 1] are shifted / scaled by fixed constants, passed through
the 5 AlexNet conv stages, unit-normalized per channel, weighted by the
learned 1x1 heads, spatially averaged and summed.

The modules carry the flax tree's names (``alex.conv0`` ... ``alex.conv10``,
``lin0`` ... ``lin4``), so ``importers/jax_params.py::export_state_dict``
maps JAX's LPIPS variables onto them.  Real weights come from a torchvision
AlexNet and the lpips package's heads through ``load_lpips_params``; no
network access is assumed.  Without them the module runs on a seeded random
init (``init_lpips``) for smoke tests, and is NOT a perceptual metric.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv2d

# lpips scaling layer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision AlexNet.features index -> (name, in, out, kernel, stride, pad)
_ALEX = {0: ("conv0", 3, 64, 11, 4, 2), 3: ("conv3", 64, 192, 5, 1, 2),
         6: ("conv6", 192, 384, 3, 1, 1), 8: ("conv8", 384, 256, 3, 1, 1),
         10: ("conv10", 256, 256, 3, 1, 1)}
_ALEX_CH = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features, returning the 5 post-ReLU stages."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in _ALEX.values():
            setattr(self, name, Conv2d(cin, cout, k, s, p))

    def forward(self, x: torch.Tensor):
        outs = []
        for i, (name, *_) in enumerate(_ALEX.values()):
            if i in (1, 2):  # max-pool after the first two stages
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, name)(x))
            outs.append(x)
        return outs


class LPIPSAlex(nn.Module):
    """LPIPS-alex distance between two [-1, 1] NCHW images: [N]."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, ch in enumerate(_ALEX_CH):
            setattr(self, f"lin{i}", Conv2d(ch, 1, 1, 1, 0, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.alex((x - self.shift) / self.scale)
        fy = self.alex((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a * torch.rsqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            head = getattr(self, f"lin{i}")((a - b) ** 2)
            total = total + torch.mean(head, dim=(1, 2, 3))
        return total


def init_lpips(seed: int = 0, device=None) -> LPIPSAlex:
    """An LPIPS module on a seeded random init (torch-default
    initializers, drawn from a ``torch.Generator`` on ``device``)."""
    with torch.device(device or "cpu"):
        mod = LPIPSAlex()
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    for m in mod.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(g)
    return mod


def load_lpips_params(alexnet_state: Dict, lpips_state: Dict
                      ) -> Dict[str, torch.Tensor]:
    """``LPIPSAlex``'s state_dict from a torchvision AlexNet state_dict
    (``features.*`` conv weights, OIHW as they are) and the lpips package's
    ``LPIPS(net='alex')`` state_dict (1x1 heads ``lin{i}.model.1.weight``
    or ``lins.{i}.model.1.weight``)."""
    out = {}
    for idx, (name, *_) in _ALEX.items():
        for kind in ("weight", "bias"):
            out[f"alex.{name}.{kind}"] = torch.from_numpy(np.asarray(
                alexnet_state[f"features.{idx}.{kind}"], np.float32))
    for i in range(len(_ALEX_CH)):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in lpips_state:
                out[f"lin{i}.weight"] = torch.from_numpy(
                    np.asarray(lpips_state[cand], np.float32))
                break
        else:
            raise KeyError(f"lin{i} head not found in lpips state dict")
    return out
