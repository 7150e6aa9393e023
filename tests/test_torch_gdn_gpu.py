"""K3's CUDA kernel against its plain twin, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gdn_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's CPU
tests are in ``tests/test_torch_gdn.py``).  ``gamma`` is non-symmetric, so a
kernel that reads it transposed fails the tolerance.
"""

import pytest

import torch

from crdr_tpu_torch.ops.gdn import gdn, gdn_plain

# f32 FFMA in another summation order than the twin's (TF32 off): a sum of
# C non-negative terms, then rsqrt / sqrt
RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K3 kernel has no CPU mode")
    return torch.device("cuda")


def _make(dev, n, c, h, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, c, h, w), device=dev, generator=g)
    beta = torch.empty(c, device=dev).uniform_(0.5, 2.0, generator=g)
    gamma = torch.empty((c, c), device=dev).uniform_(0.0, 0.1, generator=g)
    return x, beta, gamma


def _excess(out, ref):
    """max of |out - ref| / (RTOL |ref| + ATOL): <= 1 passes."""
    return float(((out - ref).abs() / (RTOL * ref.abs() + ATOL)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(3, 192, 37, 53), (2, 128, 16, 24),
                                   (1, 64, 5, 7)])
def test_kernel_matches_plain_on_gpu(cuda, shape, inverse):
    x, beta, gamma = _make(cuda, *shape, sum(shape) + inverse)
    before = gdn.launches
    out = gdn(x, beta, gamma, inverse)
    again = gdn(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.launches == before + 2
    assert torch.equal(out, again)
    ref = gdn_plain(x, beta, gamma, inverse)
    print(f"{shape} inverse={inverse}: excess {_excess(out, ref):.3f}")
    assert _excess(out, ref) <= 1.0
    assert _excess(out, gdn_plain(x, beta, gamma.t(), inverse)) > 10
    assert _excess(out, gdn_plain(x, beta, gamma, not inverse)) > 10
    for i in range(shape[0]):
        assert torch.equal(out[i:i + 1], gdn(x[i:i + 1], beta, gamma,
                                             inverse))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    x, beta, gamma = _make(cuda, 1, 64, 4, 4, 0)
    before = gdn.launches
    with pytest.raises(ValueError, match="float32"):
        gdn(x.to(torch.bfloat16), beta, gamma)
    with pytest.raises(ValueError, match="contiguous"):
        gdn(x.transpose(2, 3), beta, gamma)
    x96, b96, g96 = _make(cuda, 1, 96, 4, 4, 1)
    with pytest.raises(ValueError, match="channels"):
        gdn(x96, b96, g96)
    assert gdn.launches == before
