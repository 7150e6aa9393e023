"""The composed compression network as one ``nn.Module`` (NCHW).

Counterpart of ``crdr_tpu/models/net.py``.  Submodule names are the
reference's own (encoder, decoder, hyperencoder, hyperdecoder,
entropy_model_z, entropy_model_y, context_model), so ``state_dict`` keys are
the reference torch names.  The forward is the eval forward (rounding, the
reconstruction clamped) without a noise source, and the training forward
(noise / STE quantization, no clamp) with one (``entropy/ops.py``; JAX's
``split(rng, 3)`` becomes the names ``"z"`` and ``"y"`` / ``"y{i}"``).  In
training the quantized likelihoods (``q_likelihoods``) are the rounded
ones, detached; in eval they are the likelihoods themselves (y and z are
rounded either way).  ``aux_loss`` is the bottleneck's quantile loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..subnet import build_subnet


class CompNet(nn.Module):
    def __init__(self, subnet_opt: Dict[str, Any], use_rate: bool = False,
                 use_beta: bool = False, use_charm: bool = False,
                 img_range_01: bool = False):
        super().__init__()
        self.subnet_opt = subnet_opt
        self.use_rate, self.use_beta = use_rate, use_beta
        self.use_charm, self.img_range_01 = use_charm, img_range_01
        self.encoder = build_subnet(subnet_opt["encoder"], "encoder")
        self.decoder = build_subnet(subnet_opt["decoder"], "decoder")
        self.hyperencoder = build_subnet(subnet_opt["hyperencoder"],
                                         "hyperencoder")
        self.hyperdecoder = build_subnet(subnet_opt["hyperdecoder"],
                                         "hyperdecoder")
        self.entropy_model_z = build_subnet(subnet_opt["entropy_model_z"],
                                            "entropy_model")
        self.entropy_model_y = build_subnet(subnet_opt["entropy_model_y"],
                                            "entropy_model")
        if use_charm:
            self.context_model = build_subnet(subnet_opt["context_model"],
                                              "context_model")

    # ---- building-block calls ---------------------------------------------

    def encode(self, x: torch.Tensor, rate_ind=None, encoder=None):
        encoder = encoder or self.encoder
        return encoder(x, rate_ind) if self.use_rate else encoder(x)

    def decode(self, y_hat: torch.Tensor, rate_ind=None, beta=None,
               decoder=None):
        decoder = decoder or self.decoder
        if self.use_beta:
            return decoder(y_hat, rate_ind, beta)
        if self.use_rate:
            return decoder(y_hat, rate_ind)
        return decoder(y_hat)

    def encode_latents(self, x: torch.Tensor, rate_ind=None, encoder=None,
                       hyperencoder=None):
        """Analysis + hyper-analysis (compress step 1).  ``encoder`` /
        ``hyperencoder`` override the modules (the codec's bf16 copies)."""
        y = self.encode(x, rate_ind, encoder)
        z = (hyperencoder or self.hyperencoder)(y)
        return y, z

    def hyper_decode(self, z_hat: torch.Tensor) -> torch.Tensor:
        return self.hyperdecoder(z_hat)

    def z_likelihood_eval(self, z: torch.Tensor) -> torch.Tensor:
        return self.entropy_model_z(z)[1]

    def aux_loss(self) -> torch.Tensor:
        """The entropy bottleneck's aux loss (reference base_model.py:68-78)."""
        return self.entropy_model_z.loss()

    # ---- forward (eval / training) -------------------------------------------

    def forward(self, x: torch.Tensor, rate_ind: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None,
                noise: Optional[Callable] = None) -> Dict:
        train = noise is not None
        y = self.encode(x, rate_ind)
        z = self.hyperencoder(y)
        z_hat, z_likelihood = self.entropy_model_z(
            z, noise("z", z) if train else None)
        hyper_out = self.hyperdecoder(z_hat)
        if self.use_charm:
            res = self.context_model(y, hyper_out, self.entropy_model_y,
                                     noise, calc_q_likelihood=train)
            y_hat, y_likelihood = res[:2]
            y_q_likelihood = res[2] if train else y_likelihood
        else:
            y_hat, y_likelihood = self.entropy_model_y(
                y, hyper_out, noise("y", y) if train else None)
            y_q_likelihood = self.entropy_model_y(y, hyper_out)[1].detach() \
                if train else y_likelihood
        fake_images = self.decode(y_hat, rate_ind, beta)
        if train:
            z_q_likelihood = self.entropy_model_z(z)[1].detach()
        else:
            lo = 0.0 if self.img_range_01 else -1.0
            fake_images = torch.clamp(fake_images, lo, 1.0)
            z_q_likelihood = z_likelihood
        return {
            "fake_images": fake_images,
            "likelihoods": {"y": y_likelihood, "z": z_likelihood},
            "latent_code": {"y": y, "z": z},
            "quantized_code": {"y": y_hat, "z": z_hat},
            "q_likelihoods": {"y": y_q_likelihood, "z": z_q_likelihood},
        }
