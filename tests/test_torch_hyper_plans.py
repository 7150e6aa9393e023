"""The hyper-decoder's fixed algorithms (``nn/conv.py``), on the CPU.

On the card ``_hyper_decode`` runs its convs as im2col products and its
transposed convs as sub-pixel convs (``fixed_conv_algorithms``), since
cuDNN's plan, and so sigma, followed the card's free memory
(``tests/test_torch_hyper_plans_gpu.py`` pins that on the card).  Here the
same functions run on CPU tensors:

* ``conv2d_im2col`` / ``conv_transpose2d_subpixel`` against ``F.conv2d`` /
  ``F.conv_transpose2d`` at every layer geometry of the three
  hyper-decoders (tolerance 2e-5 of the output's scale);
* each hyper-decoder class under ``fixed_conv_algorithms`` (enabled on the
  CPU) against its own cuDNN-free torch path (same tolerance);
* the tiny flagship's ``_hyper_decode`` with the fixed path against the
  JAX package's ``hyper_decode`` on the same weights and z (the layer
  parity tolerance of ``tests/test_nn_torch_parity.py``: rtol 1e-4, atol
  1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch
import torch.nn.functional as F

from crdr_tpu_torch.models.codec import codec_numerics
from crdr_tpu_torch.nn import conv as port_conv
from crdr_tpu_torch.nn.conv import (conv2d_im2col, conv_transpose2d_subpixel,
                                    fixed_conv_algorithms)
from crdr_tpu_torch.subnet.hyperprior.alt import (Balle18HyperDecoder,
                                                  Cheng20HyperDecoder)
from crdr_tpu_torch.subnet.hyperprior.minnen20 import Minnen20HyperDecoder

from torch_pairs import pair


def _close(got: torch.Tensor, ref: torch.Tensor) -> None:
    assert got.shape == ref.shape
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * max(scale, 1.0)


@pytest.mark.parametrize("k,s,p,op,hw", [
    (5, 2, 2, 1, (8, 6)),   # Minnen20 / Balle18 up-convs
    (5, 2, 2, 1, (1, 1)),   # a 1x1 z grid
    (3, 1, 1, 0, (7, 5)),   # Minnen20's last layer
    (4, 2, 1, 0, (5, 9)),   # Cheng20's up-convs
])
def test_subpixel_matches_conv_transpose(k, s, p, op, hw):
    g = torch.Generator().manual_seed(k + s + hw[0])
    x = torch.randn(2, 6, *hw, generator=g)
    w = torch.randn(6, 5, k, k, generator=g)
    b = torch.randn(5, generator=g)
    _close(conv_transpose2d_subpixel(x, w, b, s, p, op),
           F.conv_transpose2d(x, w, b, s, p, op))


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (5, 2, 2), (1, 1, 0)])
def test_im2col_matches_conv(k, s, p):
    g = torch.Generator().manual_seed(10 * k + s)
    x = torch.randn(2, 6, 9, 7, generator=g)
    w = torch.randn(5, 6, k, k, generator=g)
    b = torch.randn(5, generator=g)
    _close(conv2d_im2col(x, w, b, s, p), F.conv2d(x, w, b, s, p))
    _close(conv2d_im2col(x, w, None, s, p), F.conv2d(x, w, None, s, p))


def test_subpixel_refuses_a_partial_phase():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 3, 3, 3)
    with pytest.raises(ValueError, match="sub-pixel"):
        conv_transpose2d_subpixel(x, w, None, 2, 1, 0)  # 7 rows from 4


@pytest.mark.parametrize("cls,kw", [
    (Minnen20HyperDecoder, dict(bottleneck_z=8, hyper_out_ch=12)),
    (Balle18HyperDecoder, dict(in_ch=8, out_ch=12, main_ch=10)),
    (Cheng20HyperDecoder, dict(in_ch=8, out_ch=12, main_ch=10)),
])
def test_hyper_decoders_fixed_path(monkeypatch, cls, kw):
    net = cls(**kw)
    g = torch.Generator().manual_seed(3)
    for m in net.modules():
        if hasattr(m, "reset_parameters") and m is not net:
            m.reset_parameters(g)
    z = torch.randn(2, 8, 3, 5, generator=g)
    with torch.no_grad():
        ref = net(z)
        monkeypatch.setattr(port_conv, "_FIXED_DEVICES", ("cpu", "cuda"))
        with fixed_conv_algorithms():
            got = net(z)
        outside = net(z)
    _close(got, ref)
    assert torch.equal(outside, ref)  # the switch holds only within


def test_flagship_hyper_decode_fixed_matches_jax(monkeypatch):
    pm, jm = pair("BetaCondInterpCaHyperpriorCharmModel")
    rng = np.random.default_rng(16)
    cz = pm.net.entropy_model_z.medians().numel()
    z_sym = torch.from_numpy(
        rng.integers(-4, 5, (2, 3, 4, cz)).astype(np.float32))
    monkeypatch.setattr(port_conv, "_FIXED_DEVICES", ("cpu", "cuda"))
    with codec_numerics(pm._chain_tf32):
        (hm, hs), z_hat = pm._hyper_decode(z_sym)
    ref = jm.net.apply({"params": jm.params}, jnp.asarray(z_hat.numpy()),
                       method=lambda n, zz: n.hyper_decode(zz))
    got = torch.cat([hm, hs], dim=-1).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)
