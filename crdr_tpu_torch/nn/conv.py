"""Conv / linear primitives with the reference's parameter layout.

Counterpart of ``crdr_tpu/nn/conv.py``.  The JAX package stores HWIO kernels
(a spatially flipped one for the transposed conv) and splits the 5x5/s2
deconv into phases for the TPU; here torch's native NCHW convolutions with the
reference's own OIHW / (in, out, kh, kw) weights replace both.

Each layer computes in the dtype of its input, casting its parameters to it,
as the flax modules do: that is what makes the ``transform_dtype: bfloat16``
codec path (a bf16 copy of the weights) mirror the JAX package's casting
rules, including the promotion to f32 where a bf16 activation meets an f32
conditioning feature.

Initialization: torch defaults (U(+-1/sqrt(fan_in))) or DCGAN N(0, 0.02)
(``w_init="dcgan"``), drawn from an explicit ``torch.Generator`` by
``reset_parameters``.

Inside ``fixed_conv_algorithms()`` the two conv layers, on a CUDA tensor,
run as im2col products (``unfold``, then one matmul an image) and a
transposed conv as its sub-pixel conv (one stride-1 conv over the input,
whose ``stride**2`` output phases ``pixel_shuffle`` interleaves), instead of
cuDNN.  cuDNN takes the first of its plans whose workspace it can get, so
its bits can follow the memory free at the call: the codec's hyper-decoder
gave other sigmas for a 2048x3072 still with all but 512 MiB of the H100
taken (``tests/test_torch_hyper_plans_gpu.py``).  Elsewhere, and on the
CPU, the layers call torch's convolutions.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _fill(t: torch.Tensor, kind: str, fan_in: int,
          generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        if kind == "torch":
            bound = 1.0 / math.sqrt(fan_in)
            t.uniform_(-bound, bound, generator=generator)
        elif kind == "dcgan":
            t.normal_(0.0, 0.02, generator=generator)
        elif kind == "zeros":
            t.zero_()
        else:
            raise ValueError(kind)


# the devices on which fixed_conv_algorithms() takes effect
_FIXED_DEVICES = ("cuda",)
_fixed = threading.local()


@contextlib.contextmanager
def fixed_conv_algorithms():
    """Within (this thread): Conv2d / ConvTranspose2d run through
    ``conv2d_im2col`` / ``conv_transpose2d_subpixel`` on the devices of
    ``_FIXED_DEVICES`` (module doc)."""
    prev = getattr(_fixed, "on", False)
    _fixed.on = True
    try:
        yield
    finally:
        _fixed.on = prev


def _fixed_on(x: torch.Tensor) -> bool:
    return getattr(_fixed, "on", False) and x.device.type in _FIXED_DEVICES


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` (NCHW, OIHW, square kernel) as an im2col product, one
    image at a time: a fixed algorithm whatever the memory free."""
    _, _, h, wd = x.shape
    k = w.shape[2]
    ho = (h + 2 * padding - k) // stride + 1
    wo = (wd + 2 * padding - k) // stride + 1
    wm = w.reshape(w.shape[0], -1)  # unfold's (channel, kh, kw) order
    outs = []
    for xi in x.split(1):
        cols = F.unfold(xi, k, padding=padding, stride=stride)[0]
        y = wm @ cols if b is None else torch.addmm(b[:, None], wm, cols)
        outs.append(y.view(1, -1, ho, wo))
    return torch.cat(outs)


def subpixel_taps(k: int, stride: int, padding: int) -> Tuple[int, int]:
    """The input offsets (first, last) that a transposed conv's output
    phases read: phase r at offset t takes kernel tap
    ``r + padding - stride * t``."""
    ts = [t for r in range(stride) for t in range(-k, k + 1)
          if 0 <= r + padding - stride * t < k]
    return min(ts), max(ts)


def subpixel_weight(w: torch.Tensor, stride: int, padding: int
                    ) -> torch.Tensor:
    """A transposed conv's weight [Cin, Cout, k, k] as one stride-1 conv's
    [stride**2 Cout, Cin, T, T]: the output phases (ry, rx) stacked in
    ``pixel_shuffle``'s channel order, zero where a phase reads no tap."""
    k = w.shape[2]
    t0, t1 = subpixel_taps(k, stride, padding)
    # made on w's device: a host-to-device copy would synchronize the
    # device-wire decode's chain, which makes no host sync
    dev = w.device
    taps = (torch.arange(stride, device=dev)[:, None] + padding - stride
            * torch.arange(t0, t1 + 1, device=dev)[None, :])  # [stride, T]
    valid = (taps >= 0) & (taps < k)
    taps = taps.clamp(0, k - 1)
    g = w[:, :, taps[:, None, :, None], taps[None, :, None, :]]
    mask = valid[:, None, :, None] & valid[None, :, None, :]
    g = g * mask.to(w.dtype)  # [Cin, Cout, ry, rx, ty, tx]
    cin, cout = w.shape[:2]
    t = t1 - t0 + 1
    return g.permute(1, 2, 3, 0, 4, 5).reshape(
        cout * stride * stride, cin, t, t).contiguous()


def conv_transpose2d_subpixel(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor], stride: int,
                              padding: int, output_padding: int
                              ) -> torch.Tensor:
    """``F.conv_transpose2d`` (NCHW, weight [Cin, Cout, k, k]) as its
    sub-pixel conv through ``conv2d_im2col``, then ``pixel_shuffle``.  The
    output side must be a multiple of the stride (every layer of the
    codec's hyper-decoders: 5/2/2/1, 4/2/1/0 and 3/1/1/0)."""
    _, _, h, wd = x.shape
    k = w.shape[2]
    t0, t1 = subpixel_taps(k, stride, padding)
    pads = []
    for n in (wd, h):
        out = (n - 1) * stride - 2 * padding + k + output_padding
        q = out // stride
        if out % stride or t0 > 0 or q - 1 + t1 < n - 1:
            raise ValueError(
                f"conv_transpose2d_subpixel: k {k} stride {stride} padding "
                f"{padding} output_padding {output_padding} on {n} pixels "
                "is not a whole sub-pixel conv")
        pads += [-t0, q - 1 + t1 - (n - 1)]
    bias = None if b is None else \
        b[:, None].expand(-1, stride * stride).reshape(-1)
    y = conv2d_im2col(F.pad(x, pads), subpixel_weight(w, stride, padding),
                      bias)
    return F.pixel_shuffle(y, stride) if stride > 1 else y


class Conv2d(nn.Module):
    """torch.nn.Conv2d equivalent; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 w_init: str = "torch", b_init: str = "torch"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.w_init, self.b_init = w_init, b_init
        self.fan_in = in_ch * kernel_size * kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        _fill(self.weight, self.w_init, self.fan_in, generator)
        if self.bias is not None:
            _fill(self.bias, self.b_init, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        if _fixed_on(x):
            return conv2d_im2col(x, self.weight.to(x.dtype), b, self.stride,
                                 self.padding)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding)


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d equivalent; weight (in, out, kh, kw).

    Output size ``(in-1)*stride - 2*padding + kernel + output_padding``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2, padding: int = 2, output_padding: int = 1,
                 bias: bool = True, w_init: str = "torch",
                 b_init: str = "torch"):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.w_init, self.b_init = w_init, b_init
        # torch's fan_in for ConvTranspose2d is weight.size(1) * kh * kw
        self.fan_in = out_ch * kernel_size * kernel_size
        self.weight = nn.Parameter(
            torch.empty(in_ch, out_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        _fill(self.weight, self.w_init, self.fan_in, generator)
        if self.bias is not None:
            _fill(self.bias, self.b_init, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        if _fixed_on(x):
            return conv_transpose2d_subpixel(
                x, self.weight.to(x.dtype), b, self.stride, self.padding,
                self.output_padding)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding)


class Dense(nn.Module):
    """torch.nn.Linear equivalent; weight (out, in)."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True,
                 w_init: str = "torch", b_init: str = "torch"):
        super().__init__()
        self.w_init, self.b_init = w_init, b_init
        self.fan_in = in_ch
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        _fill(self.weight, self.w_init, self.fan_in, generator)
        if self.bias is not None:
            _fill(self.bias, self.b_init, self.fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

