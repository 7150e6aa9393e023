"""K1's CUDA kernel against its plain twin, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_slice_transform_gpu.py -m gpu

Without a GPU its tests skip (the kernel has no CPU mode; the twin's CPU
tests and the plan's are in ``tests/test_torch_slice_transform.py``).
Biases are drawn at the outputs' scale and slice 0 of the stacks holds other
weights, so a kernel that drops a bias or reads another slice fails the
tolerance by far.
"""

import numpy as np
import pytest

import torch

from crdr_tpu_torch.ops import slice_transform as k1
from crdr_tpu_torch.ops.slice_transform import (slice_transform,
                                                slice_transform_plain)

# a one-ulp f32 difference can flip a bf16 intermediate; measured at most
# 5.3e-4 on an H100 at these inputs (outputs up to ~0.6)
K1_ATOL = 2e-3
C0, C1, COUT = 224, 128, 32


def _stacks(rng, cin):
    """[2, ...] packed stacks (slice 1 is the one used): HWIO weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as chip_smoke.py draws them (outputs
    up to ~0.6, where K1_ATOL was measured), biases at the outputs' scale."""
    def wt(shape):
        b = 1.0 / np.sqrt(np.prod(shape[:3]))
        return rng.uniform(-b, b, (2,) + shape)

    def b(c):
        return 0.1 * rng.standard_normal((2, c))

    arrs = (wt((5, 5, cin, C0)), b(C0), wt((5, 5, C0, C1)), b(C1),
            wt((3, 3, C1, COUT)), b(COUT))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrs]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K1 kernel has no CPU mode")
    return torch.device("cuda")


def _on(cuda, stacks):
    out = [t.to(cuda) for t in stacks]
    for j in (0, 2, 4):
        out[j] = out[j].to(torch.bfloat16).contiguous()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (31, 47), (32, 48), (64, 96)])
@pytest.mark.parametrize("cin", [480, 512, 48])
def test_kernel_matches_plain_on_gpu(cuda, cin, hw):
    """Within K1_ATOL of the twin; two launches bit-equal; each image of a
    batch-4 call equal to its batch-1 call; a dropped bias and another
    slice's weights miss the tolerance by more than 10x."""
    rng = np.random.default_rng(cin + 100 * hw[0] + hw[1])
    x = torch.from_numpy(rng.standard_normal((4,) + hw + (cin,))
                         .astype(np.float32)).to(cuda)
    stacks = _on(cuda, _stacks(rng, cin))
    before = slice_transform.launches
    out = slice_transform(x, *stacks, 1)
    again = slice_transform(x, *stacks, 1)
    torch.cuda.synchronize()
    assert slice_transform.launches == before + 2
    assert torch.equal(out, again)
    for i in range(4):
        assert torch.equal(out[i:i + 1],
                           slice_transform(x[i:i + 1].contiguous(), *stacks,
                                           1))
    own = [s[1] for s in stacks]
    plain = slice_transform_plain(x, *own)
    err = float((out - plain).abs().max())
    no_b4 = float((plain - own[5] - out).abs().max())
    wrong = float((slice_transform_plain(x, *(s[0] for s in stacks))
                   - out).abs().max())
    print(f"{hw} Cin {cin}: max|kernel - plain| {err:.3e}, max|out| "
          f"{float(plain.abs().max()):.3f}, dropped b4 {no_b4:.3e}, "
          f"slice 0 {wrong:.3e}")
    assert torch.isfinite(out).all()
    assert err <= K1_ATOL
    assert min(no_b4, wrong) > 10 * K1_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [(1, 1, 1), (2, 2, 2), (8, 8, 4)])
def test_every_split_matches_plain(cuda, splits):
    """The cluster reduction at each split the plan can choose."""
    rng = np.random.default_rng(sum(splits))
    x = torch.from_numpy(rng.standard_normal((2, 32, 48, 480))
                         .astype(np.float32)).to(cuda)
    stacks = _on(cuda, _stacks(rng, 480))
    plan = k1.plan_ints(k1.slice_transform_plan(32, 48, 480, C0, C1, COUT,
                                                splits))
    out = k1._launch(x, *stacks, 1, tuple(plan))
    plain = slice_transform_plain(x, *(s[1] for s in stacks))
    torch.cuda.synchronize()
    assert float((out - plain).abs().max()) <= K1_ATOL


@pytest.mark.gpu
def test_unservable_shape_raises(cuda):
    """A latent beyond fits_fused has no plan: the wrapper raises rather
    than launching or falling back."""
    rng = np.random.default_rng(0)
    x = torch.zeros((1, 64, 97, 48), device=cuda)
    stacks = _on(cuda, _stacks(rng, 48))
    with pytest.raises(ValueError, match="conv_plan"):
        slice_transform(x, *stacks, 1)
