"""Fully-factorized learned entropy model ("entropy bottleneck") for z.

Counterpart of ``crdr_tpu/entropy/bottleneck.py``, with CompressAI's
parameter names (``_matrixK``, ``_biasK``, ``_factorK``, ``quantiles``) so the
reference ``state_dict`` loads as it is.  The forward takes NCHW z:

* eval (no ``noise``): hard rounding around the median;
* training (``noise``, U(-0.5, 0.5) in z's NCHW layout): the likelihood of
  the noisy z, which is also the output; ``SteEntropyBottleneck`` outputs
  ``ste_round(z - median) + median`` instead;
* ``loss()``: the aux loss that pushes ``quantiles`` to the target tail
  mass, with the density's filters detached (their gradient is the main
  loss's), so it trains ``quantiles`` only.

The codec state ``EntropyBottleneckCodec`` builds the 16-bit CDF tables with
the same torch-f32 arithmetic as the JAX package (and CompressAI), so the
integers are identical.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ENTROPYMODEL_REGISTRY
from .ops import at_least_f32, lower_bound, ste_round

LIKELIHOOD_BOUND = 1e-9


def _logits_cumulative(params: Dict[str, torch.Tensor], x: torch.Tensor,
                       nfilters: int) -> torch.Tensor:
    """c(x) logits for inputs shaped (C, 1, N) (or (C, 1, 3): the
    quantiles)."""
    logits = x
    for i in range(nfilters + 1):
        logits = torch.matmul(F.softplus(params[f"_matrix{i}"]), logits) \
            + params[f"_bias{i}"]
        if i < nfilters:
            logits = logits + torch.tanh(params[f"_factor{i}"]) \
                * torch.tanh(logits)
    return logits


@ENTROPYMODEL_REGISTRY.register()
class EntropyBottleneck(nn.Module):
    """Factorized bottleneck (NCHW inputs)."""

    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9):
        super().__init__()
        self.channels, self.filters = channels, tuple(filters)
        self.init_scale, self.tail_mass = init_scale, tail_mass
        ext = (1,) + self.filters + (1,)
        for i in range(len(self.filters) + 1):
            self.register_parameter(
                f"_matrix{i}", nn.Parameter(torch.empty(channels, ext[i + 1],
                                                        ext[i])))
            self.register_parameter(
                f"_bias{i}", nn.Parameter(torch.empty(channels, ext[i + 1], 1)))
            if i < len(self.filters):
                self.register_parameter(
                    f"_factor{i}",
                    nn.Parameter(torch.empty(channels, ext[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))
        # the aux loss's logit targets at the quantiles (not in state_dict)
        target = math.log(2.0 / tail_mass - 1.0)
        self.register_buffer("_aux_target",
                             torch.tensor([-target, 0.0, target]),
                             persistent=False)

    def reset_parameters(self, generator=None) -> None:
        ext = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1.0 / (len(self.filters) + 1))
        with torch.no_grad():
            for i in range(len(self.filters) + 1):
                init = math.log(math.expm1(1.0 / scale / ext[i + 1]))
                getattr(self, f"_matrix{i}").fill_(init)
                getattr(self, f"_bias{i}").uniform_(-0.5, 0.5,
                                                    generator=generator)
                if i < len(self.filters):
                    getattr(self, f"_factor{i}").zero_()
            self.quantiles.copy_(torch.tensor(
                [-self.init_scale, 0.0, self.init_scale]).expand_as(
                    self.quantiles))

    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.named_parameters() if k != "quantiles"}

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1].detach()

    def likelihood(self, x_chn: torch.Tensor) -> torch.Tensor:
        """Likelihood of values shaped (C, 1, N); computed in f32 at least."""
        x_chn = at_least_f32(x_chn)
        nf = len(self.filters)
        p = self._params()
        lower = _logits_cumulative(p, x_chn - 0.5, nf)
        upper = _logits_cumulative(p, x_chn + 0.5, nf)
        sign = -torch.sign(lower + upper)
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lower_bound(lik, LIKELIHOOD_BOUND)

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NCHW.  Eval (``noise`` None): round around the medians.
        Training: ``x + noise`` (``noise`` NCHW, U(-0.5, 0.5)).  Returns
        (x_hat, likelihood), NCHW."""
        n, c, h, w = x.shape
        assert c == self.channels

        def chn(t):
            return t.permute(1, 0, 2, 3).reshape(c, 1, -1)

        if noise is None:
            med = self.medians()[:, None, None]
            out = torch.round(chn(x) - med) + med
        else:
            out = chn(x) + chn(noise)
        lik = self.likelihood(out)

        def back(t):
            return t.reshape(c, n, h, w).permute(1, 0, 2, 3)

        return back(out), back(lik)

    def loss(self) -> torch.Tensor:
        """The aux loss: |c(quantiles) - target| summed, the filters
        detached."""
        p = {k: v.detach() for k, v in self._params().items()}
        logits = _logits_cumulative(p, self.quantiles, len(self.filters))
        return torch.abs(logits - self._aux_target).sum()


@ENTROPYMODEL_REGISTRY.register()
class SteEntropyBottleneck(EntropyBottleneck):
    """Noise for the likelihood, straight-through rounding around the
    medians for the output (reference entropy_bottleneck.py:19-30);
    identical to the base in eval."""

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_hat, lik = super().forward(x, noise)
        if noise is None:
            return x_hat, lik
        med = self.medians()[None, :, None, None]
        return ste_round(x - med) + med, lik


# ---------------------------------------------------------------------------
# Host-side codec state (CDF tables + rANS calls)
# ---------------------------------------------------------------------------

class EntropyBottleneckCodec:
    """Builds integer CDF tables from trained params and entropy-codes z.

    Mirrors CompressAI ``EntropyBottleneck.update`` / ``compress`` /
    ``decompress``.  Symbols are serialized in channel-major (C, H, W) order
    (stream-layout parity with the reference)."""

    def __init__(self, params: Dict[str, np.ndarray],
                 filters: Tuple[int, ...] = (3, 3, 3, 3)):
        # params: {name: array} of the (Ste)EntropyBottleneck module
        self.params = {k: np.asarray(v, np.float32) for k, v in params.items()}
        self.filters = tuple(filters)
        self.quantized_cdf = None
        self.cdf_length = None
        self.offset = None

    @property
    def channels(self) -> int:
        return self.params["quantiles"].shape[0]

    def update(self) -> None:
        from ..runtime import pmf_to_quantized_cdf

        q = self.params["quantiles"]
        medians = q[:, 0, 1]
        minima = np.maximum(np.ceil(medians - q[:, 0, 0]).astype(np.int32), 0)
        maxima = np.maximum(np.ceil(q[:, 0, 2] - medians).astype(np.int32), 0)
        pmf_start = medians - minima
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())

        pmf, tail = self._pmf(pmf_start, max_length)

        C = self.channels
        cdf = np.zeros((C, max_length + 2), dtype=np.int32)
        for c in range(C):
            p = np.concatenate([pmf[c, :pmf_length[c]], [tail[c]]])
            row = pmf_to_quantized_cdf(p.astype(np.float32), 16)
            cdf[c, :len(row)] = row
        self.quantized_cdf = cdf
        self.cdf_length = (pmf_length + 2).astype(np.int32)
        self.offset = (-minima).astype(np.int32)

    def _pmf(self, pmf_start: np.ndarray, max_length: int):
        """PMF rows from the logits chain in torch f32 on the CPU, the
        arithmetic CompressAI's ``update`` uses: quantized CDFs are
        ulp-sensitive."""
        with torch.no_grad():
            samples = torch.arange(max_length, dtype=torch.float32)
            samples = samples[None, None, :] + torch.from_numpy(
                np.asarray(pmf_start, np.float32))[:, None, None]
            p = {k: torch.from_numpy(v) for k, v in self.params.items()}
            nf = len(self.filters)
            lower = _logits_cumulative(p, samples - 0.5, nf)
            upper = _logits_cumulative(p, samples + 0.5, nf)
            sign = -torch.sign(lower + upper)
            pmf = torch.abs(torch.sigmoid(sign * upper) -
                            torch.sigmoid(sign * lower))[:, 0, :].numpy()
            tail = (torch.sigmoid(lower[:, 0, 0]) +
                    torch.sigmoid(-upper[:, 0, -1])).numpy()
        return pmf, tail

    def _indexes(self, h: int, w: int) -> np.ndarray:
        c = self.channels
        return np.broadcast_to(
            np.arange(c, dtype=np.int32)[:, None], (c, h * w)).reshape(-1)

    def compress_symbols(self, symbols: np.ndarray) -> list:
        """Entropy-code centered integer symbols (NHWC), one string each."""
        from ..runtime import rans_encode_with_indexes

        assert self.quantized_cdf is not None, "call update() first"
        n, h, w, c = symbols.shape
        symbols = symbols.astype(np.int32).transpose(0, 3, 1, 2).reshape(n, -1)
        indexes = self._indexes(h, w)
        return [rans_encode_with_indexes(symbols[i], indexes,
                                         self.quantized_cdf, self.cdf_length,
                                         self.offset)
                for i in range(n)]

    def decompress(self, strings: list, size: Tuple[int, int]) -> np.ndarray:
        """Centered integer symbols as float NHWC."""
        from ..runtime import rans_decode_with_indexes

        assert self.quantized_cdf is not None
        h, w = size
        c = self.channels
        indexes = self._indexes(h, w)
        out = np.zeros((len(strings), c, h, w), dtype=np.float32)
        for i, s in enumerate(strings):
            sym = rans_decode_with_indexes(s, indexes, self.quantized_cdf,
                                           self.cdf_length, self.offset)
            out[i] = sym.reshape(c, h, w).astype(np.float32)
        return out.transpose(0, 2, 3, 1)
