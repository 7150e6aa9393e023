"""DISTS (Ding et al. 2020), NCHW (counterpart of
``crdr_tpu/metrics/dists.py``).

Used by the reference's calc_metrics on [0, 1] inputs
(calc_metrics.py:195-216).  A VGG16 backbone with Hanning-windowed L2
pooling between its stages; per stage, texture (means) and structure
(variances, covariance) similarities weighted by the learned ``alpha`` /
``beta``.  Real weights come from the official DISTS state dict (pickled as
numpy arrays, ``CRDR_DISTS_WEIGHTS``) through ``load_dists_params``;
``init_dists`` gives a seeded random init for smoke tests, NOT the metric.
The modules carry the flax tree's names (``vgg.conv0`` ... ``vgg.conv28``,
``alpha``, ``beta``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv2d

_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
# VGG16 conv layout per stage (torchvision feature indices)
_STAGES = [
    [(0, 64), (2, 64)],
    [(5, 128), (7, 128)],
    [(10, 256), (12, 256), (14, 256)],
    [(17, 512), (19, 512), (21, 512)],
    [(24, 512), (26, 512), (28, 512)],
]
_CHANNELS = [3, 64, 128, 256, 512, 512]


def _hanning_kernel() -> torch.Tensor:
    win = np.hanning(5)[1:-1]
    k2 = np.outer(win, win)
    return torch.from_numpy((k2 / k2.sum()).astype(np.float32))


class VGG16Stages(nn.Module):
    """[N, 3, H, W] in [0, 1] -> [input, stage1 .. stage5] features."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage in _STAGES:
            for idx, ch in stage:
                setattr(self, f"conv{idx}", Conv2d(cin, ch, 3, 1, 1))
                cin = ch
        self.register_buffer("mean", torch.tensor(_VGG_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_VGG_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("window", _hanning_kernel(), persistent=False)

    def l2_pool(self, x: torch.Tensor) -> torch.Tensor:
        """Hanning-windowed L2 pooling (DISTS' downsampling), stride 2."""
        c = x.shape[1]
        kern = self.window.to(x.dtype).expand(c, 1, 3, 3)
        y = F.conv2d(x * x, kern, None, 2, 1, groups=c)
        return torch.sqrt(y + 1e-12)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [x]
        h = (x - self.mean) / self.std
        for si, stage in enumerate(_STAGES):
            if si > 0:
                h = self.l2_pool(h)
            for idx, _ in stage:
                h = torch.relu(getattr(self, f"conv{idx}")(h))
            outs.append(h)
        return outs


class DISTS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Stages()
        total = sum(_CHANNELS)
        self.alpha = nn.Parameter(torch.full((total,), 0.1))
        self.beta = nn.Parameter(torch.full((total,), 0.1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [0, 1] NCHW.  Returns the per-image distance [N]."""
        fx, fy = self.vgg(x), self.vgg(y)
        w_sum = torch.sum(self.alpha) + torch.sum(self.beta)
        c1 = c2 = 1e-6
        dist1 = dist2 = 0.0
        off = 0
        for a, b in zip(fx, fy):
            ch = a.shape[1]
            al = self.alpha[off:off + ch] / w_sum
            be = self.beta[off:off + ch] / w_sum
            off += ch
            mu_a = torch.mean(a, dim=(2, 3), keepdim=True)
            mu_b = torch.mean(b, dim=(2, 3), keepdim=True)
            var_a = torch.mean((a - mu_a) ** 2, dim=(2, 3))
            var_b = torch.mean((b - mu_b) ** 2, dim=(2, 3))
            cov = torch.mean((a - mu_a) * (b - mu_b), dim=(2, 3))
            mu_a, mu_b = mu_a[:, :, 0, 0], mu_b[:, :, 0, 0]
            s_text = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
            s_struct = (2 * cov + c2) / (var_a + var_b + c2)
            dist1 = dist1 + torch.sum(al * s_text, dim=-1)
            dist2 = dist2 + torch.sum(be * s_struct, dim=-1)
        return 1.0 - (dist1 + dist2)


def load_dists_params(state: Dict) -> Dict[str, torch.Tensor]:
    """The official DISTS state dict -> ``DISTS``' state dict.  The official
    module registers the VGG16 layers under their torchvision feature
    indices (``stage2.5.weight`` is features[5], ``vgg.conv5`` here); its
    L2-pooling filters are rebuilt, not loaded."""
    out = {}
    for k, v in state.items():
        v = torch.from_numpy(np.array(v, np.float32))
        parts = k.split(".")
        if k.startswith("stage") and parts[-1] in ("weight", "bias"):
            out[f"vgg.conv{int(parts[1])}.{parts[-1]}"] = v
        elif k in ("alpha", "beta"):
            out[k] = v.reshape(-1)
    return out


def init_dists(seed: int = 0, device=None) -> DISTS:
    """DISTS on a seeded random init (torch-default conv initializers from
    a ``torch.Generator`` on ``device``; alpha = beta = 0.1)."""
    with torch.device(device or "cpu"):
        mod = DISTS()
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    for m in mod.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(g)
    return mod.eval().requires_grad_(False)


def seeded_dists_state(seed: int = 0) -> Dict[str, np.ndarray]:
    """A state dict in the official DISTS layout (``stageK.<index>.weight``,
    ``alpha`` / ``beta`` as [1, C, 1, 1]) drawn from ``seed`` with numpy: a
    stand-in for smoke runs and tests, NOT the metric."""
    rng = np.random.default_rng(seed)
    out = {}
    cin = 3
    for si, stage in enumerate(_STAGES):
        for idx, ch in stage:
            out[f"stage{si + 1}.{idx}.weight"] = (
                rng.standard_normal((ch, cin, 3, 3))
                * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
            out[f"stage{si + 1}.{idx}.bias"] = (
                rng.standard_normal(ch) * 0.01).astype(np.float32)
            cin = ch
    total = sum(_CHANNELS)
    for k in ("alpha", "beta"):
        out[k] = rng.uniform(0.01, 0.2, (1, total, 1, 1)).astype(np.float32)
    return out
