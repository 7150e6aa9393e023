"""K3's CUDA kernel against its plain twin, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gdn_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's CPU
tests are in ``tests/test_torch_gdn.py``).  ``gamma`` is non-symmetric, so a
kernel that reads it transposed fails the tolerance.  The edges of the tile
plan (64 pixels a block): every channel count, P of 1, 35 (P % 4 != 0),
1961 (37x53) and 385 (a multiple of the tile plus 1), and an x that is not
16-byte aligned.  The gradient on the card is held against autograd through
the twin in float64 on the CPU, and through the twin on the card in f32
(TF32 off).  The bf16 mode (``transform_dtype: bfloat16``) against the bf16
twin on the card, at every channel count and the same edges: its vector
path (P % 8 == 0, 16-byte aligned; a whole tile and a ragged one) and its
scalar path (P % 8 != 0, or an x at a 2-byte offset); every element the
composite of a sum within 1 bf16 ulp of the twin's, every later step exact
(the tensor cores sum the f32 product in another order than the twin, so a
sum may round to the neighbouring bf16 value), the share and ulps apart
printed; each image of a batch of 4 equal to its own launch (the
persistent blocks walk other tiles at batch 1).
"""

import pytest

import torch

from crdr_tpu_torch.ops.gdn import bf16_unexplained, gdn, gdn_plain

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


def _check(x, beta, gamma, inverse):
    """Kernel vs twin within the tolerance; a transposed gamma and the other
    direction miss it by > 10x; two launches bit-equal; each image equal to
    its batch-1 launch."""
    before = gdn.launches
    out = gdn(x, beta, gamma, inverse)
    again = gdn(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.launches == before + 2
    assert torch.equal(out, again)
    ref = gdn_plain(x, beta, gamma, inverse)
    assert _excess(out, ref) <= 1.0
    assert _excess(out, gdn_plain(x, beta, gamma.t(), inverse)) > 10
    assert _excess(out, gdn_plain(x, beta, gamma, not inverse)) > 10
    for i in range(x.shape[0]):
        assert torch.equal(out[i:i + 1], gdn(x[i:i + 1].contiguous(), beta,
                                             gamma, inverse))


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (37, 53), (5, 77)])
@pytest.mark.parametrize("c", [64, 128, 192, 256])
def test_kernel_edges_on_gpu(cuda, c, hw, inverse):
    x, beta, gamma = _make(cuda, 2, c, *hw, c + hw[0] * hw[1] + inverse)
    _check(x, beta, gamma, inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(16, 24), (5, 7)])
@pytest.mark.parametrize("c", [64, 192])
def test_kernel_takes_an_unaligned_x(cuda, c, hw):
    """x at a 4-byte offset from a 16-byte boundary (a contiguous view of a
    flat buffer at an odd offset): the kernel takes its scalar path."""
    x, beta, gamma = _make(cuda, 2, c, *hw, 7 * c + hw[0])
    flat = torch.empty(x.numel() + 1, device=cuda)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 16 == 4
    for inverse in (False, True):
        out = gdn(xo, beta, gamma, inverse)
        assert torch.equal(out, gdn(x, beta, gamma, inverse))
        _check(xo, beta, gamma, inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_gradient_on_gpu(cuda, inverse):
    """With requires_grad, one launch and a grad_fn; gradients of x, beta and
    gamma within tolerance of autograd through the twin run in float64 on
    the CPU (independent of the card's f32 path), and of the twin on the
    card with TF32 off."""
    x, beta, gamma = _make(cuda, 2, 192, 9, 13, 40 + inverse)
    w = torch.randn(x.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))

    def grads(fn, dev, dtype):
        args = [t.to(dev, dtype, copy=True).requires_grad_()
                for t in (x, beta, gamma)]
        out = fn(*args, inverse)
        assert out.grad_fn is not None
        # the twin's own backward convolutions in f32 too
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                         deterministic=True, allow_tf32=False):
            (out * w.to(dev, dtype)).sum().backward()
        return [a.grad.to("cpu", torch.float64) for a in args]

    before = gdn.launches
    got = grads(gdn, cuda, torch.float32)
    assert gdn.launches == before + 1
    for ref in (grads(gdn_plain, "cpu", torch.float64),
                grads(gdn_plain, cuda, torch.float32)):
        for g, want in zip(got, ref):
            # f32 sums of up to 234 pixels' terms against the f64 twin
            torch.testing.assert_close(g, want, rtol=1e-4,
                                       atol=1e-5 * float(want.abs().max()))


def _bf16_check(x, beta, gamma, inverse):
    """The bf16 mode against the bf16 twin: every element a sum within 1
    ulp of the twin's, every later step exact; two launches bit-equal; each
    image equal to its batch-1 launch; a transposed gamma fails that."""
    before = gdn.launches
    out = gdn(x, beta, gamma, inverse)
    again = gdn(x, beta, gamma, inverse)
    torch.cuda.synchronize()
    assert gdn.launches == before + 2
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    ref = gdn_plain(x, beta, gamma, inverse)
    apart = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    print(f"bf16 {tuple(x.shape)} inverse={inverse}: "
          f"{float((apart > 0).float().mean()):.2e} apart, at most "
          f"{int(apart.max())} ulp")
    assert bf16_unexplained(out, x, beta, gamma, inverse) == 0
    assert bf16_unexplained(out, x, beta, gamma.t(), inverse) > 0
    for i in range(x.shape[0]):
        assert torch.equal(out[i:i + 1], gdn(x[i:i + 1].contiguous(), beta,
                                             gamma, inverse))


def _make_bf16(dev, n, c, h, w, seed):
    x, beta, gamma = _make(dev, n, c, h, w, seed)
    return (x * 2).bfloat16(), beta.bfloat16(), gamma.bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (37, 53), (5, 77),
                                (64, 96), (8, 13)])
@pytest.mark.parametrize("c", [64, 128, 192, 256])
def test_bf16_kernel_matches_its_twin_on_gpu(cuda, c, hw, inverse):
    _bf16_check(*_make_bf16(cuda, 2, c, *hw, 3 * c + hw[0] + inverse),
                inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [64, 128, 192, 256])
def test_bf16_kernel_takes_an_unaligned_x(cuda, c):
    """x at a 2-byte offset (a contiguous view of a flat buffer): the
    bf16 mode takes its scalar path."""
    x, beta, gamma = _make_bf16(cuda, 2, c, 16, 24, 5 * c)
    flat = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 8 == 2
    for inverse in (False, True):
        assert torch.equal(gdn(xo, beta, gamma, inverse),
                           gdn(x, beta, gamma, inverse))
        _bf16_check(xo, beta, gamma, inverse)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(64, 96), (37, 53)])
@pytest.mark.parametrize("c", [64, 128, 192, 256])
def test_bf16_image_alone_equals_it_in_the_batch(cuda, c, hw):
    """Batch 4 against each image alone, both directions: the blocks walk
    the tiles of all four images, or of one."""
    x, beta, gamma = _make_bf16(cuda, 4, c, *hw, 11 * c + hw[1])
    for inverse in (False, True):
        out = gdn(x, beta, gamma, inverse)
        assert bf16_unexplained(out, x, beta, gamma, inverse) == 0
        for i in (0, 3):
            assert torch.equal(out[i:i + 1], gdn(x[i:i + 1].contiguous(),
                                                 beta, gamma, inverse))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    x, beta, gamma = _make(cuda, 1, 64, 4, 4, 0)
    before = gdn.launches
    with pytest.raises(ValueError, match="share one dtype"):
        gdn(x.to(torch.bfloat16), beta, gamma)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gdn(x.half(), beta.half(), gamma.half())
    with pytest.raises(ValueError, match="contiguous"):
        gdn(x.transpose(2, 3), beta, gamma)
    x96, b96, g96 = _make(cuda, 1, 96, 4, 4, 1)
    with pytest.raises(ValueError, match="channels"):
        gdn(x96, b96, g96)
    assert gdn.launches == before
