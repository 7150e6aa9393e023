"""GDN (NCHW), the normalization of the Balle18 transforms.

Counterpart of ``crdr_tpu/nn/norm.py`` (``NonNegativeParam``, ``GDN``;
CompressAI's formulation): ``y = x * (beta + gamma . x^2)^(-1/2)``, or
``^(+1/2)`` for the inverse, with non-negative reparameterized ``beta`` /
``gamma`` stored as ``sqrt(value + pedestal)``.  ``state_dict`` holds
exactly ``beta`` [C] and ``gamma`` [C_out, C_in]; the pedestal and the bound
are constants.  The forward is K3 (``ops/gdn.py``) on the card, its plain
twin on the CPU.  ``ChannelNorm2D`` / ``InstanceNorm2D`` (HiFiC) are not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..entropy.ops import lower_bound
from ..ops.gdn import gdn

_REPARAM_OFFSET = 2.0 ** -18


class NonNegativeParam:
    """CompressAI NonNegativeParametrizer: store sqrt(x + pedestal), recover
    lower_bound(stored)^2 - pedestal."""

    def __init__(self, minimum: float = 0.0):
        self.pedestal = _REPARAM_OFFSET ** 2
        self.bound = (minimum + _REPARAM_OFFSET ** 2) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp(x + self.pedestal, min=self.pedestal))

    def __call__(self, stored: torch.Tensor) -> torch.Tensor:
        return lower_bound(stored, self.bound) ** 2 - self.pedestal


class GDN(nn.Module):
    """Generalized divisive normalization; ``inverse`` gives IGDN."""

    def __init__(self, ch: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.gamma_init = gamma_init
        self._beta_rp = NonNegativeParam(beta_min)
        self._gamma_rp = NonNegativeParam()
        self.beta = nn.Parameter(torch.empty(ch))
        self.gamma = nn.Parameter(torch.empty(ch, ch))

    def reset_parameters(self, generator=None) -> None:
        """Deterministic (``generator`` is not drawn from): beta = 1 and
        gamma = gamma_init * I, reparameterized, as ``norm.py`` initializes."""
        with torch.no_grad():
            self.beta.copy_(self._beta_rp.init(torch.ones_like(self.beta)))
            eye = torch.eye(self.gamma.shape[0], dtype=self.gamma.dtype,
                            device=self.gamma.device)
            self.gamma.copy_(self._gamma_rp.init(self.gamma_init * eye))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdn(x, self._beta_rp(self.beta), self._gamma_rp(self.gamma),
                   self.inverse)
