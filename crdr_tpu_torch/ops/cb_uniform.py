"""Uniform-shape checkerboard decode: two phases a slice, one code path for
every slice.

Counterpart of ``crdr_tpu/ops/cb_uniform.py`` (``pack_cb_weights``,
``cb_phase_a``, ``cb_phase_b``, ``cb_reconstruct_last``).  The mean, scale
and LRP SliceTransforms share Charm's packed, zero-padded layout
(``ops/charm_uniform.py``; with ``fused_slice_kernel`` and ReLU they run
K1); the per-slice spatial 5x5 convs are stacked.  NHWC tensors.

Reconstruction contract:
  y_a  = (sym_a + mu) * amask
  mu_c = mu + d_mu * (1 - amask); sigma_c likewise (spatial conv on y_a)
  y_na = (sym_na + mu_c) * (1 - amask)
  y    = y_a + y_na + 0.5 * tanh(lrp([hyper_mean | support | y_a + y_na]))

As the port's Charm step does, the phases skip work JAX computes and
discards: phase A at slice 0 runs no LRP, and the last slice is finished by
``cb_reconstruct_last`` (JAX's phase A at ``i == num_slices`` computes the
same y and dead parameters).  The support buffer is updated in place.  The
spatial conv runs one image at a time, f32 (``_conv_nhwc``), so its result
does not depend on the batch.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

import torch

from ..entropy import build_indexes
from ..subnet.context_model.checkerboard import anchor_mask
from .charm_uniform import _slice_transform, pack_charm_weights
from .slice_transform import _conv_nhwc

Tensor = torch.Tensor


def pack_cb_weights(cm_state: Mapping[str, Tensor], num_slices: int,
                    slice_ch: int, hyper_ch: int,
                    max_support: int) -> Dict[str, np.ndarray]:
    """Charm's packing (``pack_charm_weights``) plus the stacked spatial
    convs: ``spat_w`` [S, 5, 5, sc, 2 sc] (HWIO, the JAX layout) and
    ``spat_b`` [S, 2 sc], f32."""
    out = pack_charm_weights(cm_state, num_slices, slice_ch, hyper_ch,
                             max_support)
    ws, bs = [], []
    for i in range(num_slices):
        w = cm_state[f"spatial_transforms_{i}.weight"].detach().cpu().numpy()
        ws.append(w.astype(np.float32).transpose(2, 3, 1, 0))  # -> HWIO
        bs.append(cm_state[f"spatial_transforms_{i}.bias"].detach().cpu()
                  .numpy().astype(np.float32))
    out["spat_w"] = np.ascontiguousarray(np.stack(ws))
    out["spat_b"] = np.ascontiguousarray(np.stack(bs))
    return out


def _amask(t: Tensor) -> Tensor:
    """The [1, H, W, 1] anchor mask of NHWC ``t``."""
    return anchor_mask(t.shape[1], t.shape[2], t.dtype, t.device)[None, :, :,
                                                                  None]


def cb_phase_a(packed: Mapping[str, Tensor], slice_idx: int,
               hyper_mean: Tensor, hyper_scale: Tensor, support_buf: Tensor,
               sym_na_prev: Tensor, y_a_prev: Tensor, mu_c_prev: Tensor,
               scale_table: Tensor, scale_bound: float, num_slices: int,
               slice_ch: int, max_support: int, fused: bool = False,
               actv: str = "relu"
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """For ``slice_idx = i`` (0 <= i < num_slices):

    * if i > 0: finish slice i-1 (non-anchor reconstruct from
      (sym_na_prev, mu_c_prev), plus the anchors y_a_prev, plus the LRP) and
      write it into the support buffer while it is a support slice;
    * slice i's (mu, sigma) from the channel context, and the CDF rows of
      the whole grid (the anchors' are used).

    Returns (y_prev, support_buf, mu, sigma, indexes int32); sigma is not
    bounded (the rows and the likelihoods bound it)."""
    i = int(slice_idx)
    y_prev = y_a_prev + (sym_na_prev + mu_c_prev) * (1.0 - _amask(hyper_mean))
    if i > 0:
        prev = i - 1
        lrp_in = torch.cat([hyper_mean, support_buf, y_prev], dim=-1)
        y_prev = y_prev + 0.5 * torch.tanh(
            _slice_transform(packed, "lrp", prev, lrp_in, fused, actv))
        if prev < max_support:
            support_buf[..., prev * slice_ch:(prev + 1) * slice_ch] = y_prev
    cur = min(i, num_slices - 1)
    mean_in = torch.cat([hyper_mean, support_buf], dim=-1)
    scale_in = torch.cat([hyper_scale, support_buf], dim=-1)
    mu = _slice_transform(packed, "mean", cur, mean_in, fused, actv)
    sigma = _slice_transform(packed, "scale", cur, scale_in, fused, actv)
    return (y_prev, support_buf, mu, sigma,
            build_indexes(sigma, scale_table, scale_bound))


def cb_phase_b(packed: Mapping[str, Tensor], slice_idx: int, sym_a: Tensor,
               mu: Tensor, sigma: Tensor, scale_table: Tensor,
               scale_bound: float) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Anchors of slice i: reconstruct them from (sym_a, mu), run the
    spatial conv for the combined non-anchor params, emit the CDF rows of
    the whole grid (the non-anchors' are used).

    Returns (y_a, mu_c, sigma_c, indexes int32)."""
    i = int(slice_idx)
    amask = _amask(mu)
    y_a = (sym_a + mu) * amask
    delta = _conv_nhwc(y_a, packed["spat_w"][i], packed["spat_b"][i], 2)
    d_mu, d_sigma = torch.chunk(delta, 2, dim=-1)
    mu_c = mu + d_mu * (1.0 - amask)
    sigma_c = sigma + d_sigma * (1.0 - amask)
    return y_a, mu_c, sigma_c, build_indexes(sigma_c, scale_table,
                                             scale_bound)


def cb_reconstruct_last(packed: Mapping[str, Tensor], hyper_mean: Tensor,
                        support_buf: Tensor, sym_na: Tensor, y_a: Tensor,
                        mu_c: Tensor, num_slices: int, fused: bool = False,
                        actv: str = "relu") -> Tensor:
    """Finish the LAST slice: non-anchor reconstruct + LRP, the ``y_prev``
    of ``cb_phase_a`` at ``slice_idx == num_slices``."""
    y_prev = y_a + (sym_na + mu_c) * (1.0 - _amask(hyper_mean))
    lrp_in = torch.cat([hyper_mean, support_buf, y_prev], dim=-1)
    return y_prev + 0.5 * torch.tanh(_slice_transform(
        packed, "lrp", num_slices - 1, lrp_in, fused, actv))
