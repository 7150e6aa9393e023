"""Uniform-shape Charm decode step: one code path for all slices.

Counterpart of ``crdr_tpu/ops/charm_uniform.py`` (``pack_charm_weights``,
``_slice_transform``, ``uniform_decode_step``, ``uniform_reconstruct_last``).
Every slice runs the same step:

* the decoded support lives in a fixed [N, H, W, max_support*slice_ch] NHWC
  buffer, zero-padded for not-yet-decoded slices;
* each slice's three SliceTransform weight sets are zero-padded to the maximum
  input width and stacked along a leading slice axis; the step picks the
  current slice's weights by index (the K1 kernel indexes the stack itself).

Zero-padded input channels meet zero-padded weight rows, so outputs equal the
per-slice-shaped computation.  Input-channel layout of the padded first conv:
``[hyper(Ch) | support(max_support*slice_ch) | (lrp only) current slice]``.

The encoder replays this very ``uniform_decode_step`` (models/codec.py), so
the entropy parameters agree with the decoder's to the bit.  Unlike the JAX
step, the slice index is a Python int: the step at i = 0 skips the LRP whose
result the JAX program computes and discards, and the support buffer is
updated in place.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

import torch

from ..subnet.context_model.charm import activation
from .slice_transform import _conv_nhwc, fits_fused, slice_transform

Tensor = torch.Tensor

_KINDS = ("mean", "scale", "lrp")
_LAYERS = ("0", "2", "4")


def pack_charm_weights(cm_state: Mapping[str, Tensor], num_slices: int,
                       slice_ch: int, hyper_ch: int,
                       max_support: int) -> Dict[str, np.ndarray]:
    """Stack + zero-pad the per-slice SliceTransform weights.

    ``cm_state``: the state_dict of Minnen20CharmContextModel (OIHW convs).
    Returns f32 arrays keyed ``{mean,scale,lrp}{0,2,4}_{w,b}`` with a leading
    slice axis, weights in the JAX package's HWIO layout (also the layout the
    K1 kernel reads): [S, k, k, Cin, Cout]."""
    sup_w = max_support * slice_ch
    out: Dict[str, np.ndarray] = {}
    for kind in _KINDS:
        full_in = hyper_ch + sup_w + (slice_ch if kind == "lrp" else 0)
        for tag in _LAYERS:
            ws, bs = [], []
            for i in range(num_slices):
                pre = f"{kind}_slice_transforms.{i}.model.{tag}"
                w = cm_state[f"{pre}.weight"].detach().cpu().numpy()
                w = w.astype(np.float32).transpose(2, 3, 1, 0)  # -> HWIO
                b = cm_state[f"{pre}.bias"].detach().cpu().numpy()
                if tag == "0":
                    nsup = min(i, max_support) if max_support >= 0 else i
                    used = nsup * slice_ch
                    kh, kw, _, cout = w.shape
                    padded = np.zeros((kh, kw, full_in, cout), np.float32)
                    padded[:, :, :hyper_ch + used] = w[:, :, :hyper_ch + used]
                    if kind == "lrp":
                        # the current-slice rows sit at the fixed tail offset
                        padded[:, :, hyper_ch + sup_w:] = \
                            w[:, :, hyper_ch + used:hyper_ch + used + slice_ch]
                    w = padded
                ws.append(w)
                bs.append(b.astype(np.float32))
            out[f"{kind}{tag}_w"] = np.ascontiguousarray(np.stack(ws))
            out[f"{kind}{tag}_b"] = np.ascontiguousarray(np.stack(bs))
    return out


def kernel_stacks(packed: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The K1 kernel's bf16 copies of the weight stacks (``{kind}{tag}_wk``),
    converted once at codec setup."""
    return {f"{kind}{tag}_wk": packed[f"{kind}{tag}_w"].to(torch.bfloat16)
            .contiguous() for kind in _KINDS for tag in _LAYERS}


def _slice_transform(packed: Mapping[str, Tensor], kind: str, idx: int,
                     x: Tensor, fused: bool = False,
                     actv: str = "relu") -> Tensor:
    """SliceTransform ``kind`` of slice ``idx`` on NHWC ``x``, activation
    ``actv`` (``subnet/context_model/charm.py::ACTIVATIONS``).  ``fused``
    (config ``fused_slice_kernel``) takes the K1 kernel where JAX takes its
    Pallas kernel: ReLU, latents within ``fits_fused``; else f32
    convolutions."""
    if fused and actv == "relu" and fits_fused(x.shape[1], x.shape[2]):
        return slice_transform(
            x, packed[f"{kind}0_wk"], packed[f"{kind}0_b"],
            packed[f"{kind}2_wk"], packed[f"{kind}2_b"],
            packed[f"{kind}4_wk"], packed[f"{kind}4_b"], idx)

    def conv(v, tag, pad):
        return _conv_nhwc(v, packed[f"{kind}{tag}_w"][idx],
                          packed[f"{kind}{tag}_b"][idx], pad)

    act = activation(actv)
    h = act(conv(x, "0", 2))
    h = act(conv(h, "2", 2))
    return conv(h, "4", 1).contiguous()


def uniform_reconstruct_last(packed: Mapping[str, Tensor], hyper_mean: Tensor,
                             support_buf: Tensor, sym_prev: Tensor,
                             mu_prev: Tensor, num_slices: int,
                             fused: bool = False,
                             actv: str = "relu") -> Tensor:
    """Reconstruct the FINAL slice (dequantize + LRP) with the same padded
    input layout as the step, so encoder and decoder agree to the bit."""
    y_prev = sym_prev + mu_prev
    lrp_in = torch.cat([hyper_mean, support_buf, y_prev], dim=-1)
    lrp = 0.5 * torch.tanh(_slice_transform(packed, "lrp", num_slices - 1,
                                            lrp_in, fused, actv))
    return y_prev + lrp


def uniform_decode_step(packed: Mapping[str, Tensor], slice_idx: int,
                        hyper_mean: Tensor, hyper_scale: Tensor,
                        support_buf: Tensor, sym_prev: Tensor,
                        mu_prev: Tensor, scale_table: Tensor,
                        scale_bound: float, num_slices: int, slice_ch: int,
                        max_support: int, fused: bool = False,
                        actv: str = "relu"
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One serial-decode step, shape-uniform across slices (NHWC tensors).

    For ``slice_idx = i`` (0 <= i < num_slices):
      * if i > 0: reconstruct slice i-1 from (sym_prev, mu_prev) via LRP and
        write it into the support buffer (in place; only while it is a
        support slice);
      * produce (mu_i, sigma_i, rANS indexes_i) for the next decode round.

    Returns (y_prev, support_buf, mu_i, sigma_i, indexes_i); sigma is
    scale-bounded (the encoder's predicted-bits accounting reads it)."""
    i = int(slice_idx)
    y_prev = sym_prev + mu_prev
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
    sigma = torch.clamp(sigma, min=scale_bound)
    indexes = torch.clamp(
        torch.searchsorted(scale_table, sigma, right=False),
        max=scale_table.numel() - 1).to(torch.int32)
    return y_prev, support_buf, mu, sigma, indexes
