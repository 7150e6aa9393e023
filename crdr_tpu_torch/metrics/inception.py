"""InceptionV3, FID flavor, NCHW (counterpart of
``crdr_tpu/metrics/inception.py``).

pytorch-fid's FID Inception: torchvision's InceptionV3 with the FID pool
branches (an average pool that does not count padding; a max pool in
Mixed_7c).  ``BasicConv2d`` is a conv without bias and an eval-mode
BatchNorm (eps 1e-3).  The modules carry pytorch-fid's state-dict names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``, ...),
so its weights, pickled as numpy arrays (``CRDR_INCEPTION_WEIGHTS``, the
file the JAX package reads too), load with ``load_state_dict``; the ``fc``
head is not used.  Input: [N, 3, H, W] in [0, 255], resized to 299x299
bilinearly (half-pixel centres, ``align_corners=False``: the JAX package's
``jax.image.resize(..., "bilinear")`` when upsampling, edges included),
then scaled to [-1, 1].  Output: the 2048-d pool3 features.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.numpy_pickle import load_numpy_pickle

_Pair = Union[int, Tuple[int, int]]


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: _Pair,
                 stride: int = 1, padding: _Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x))
        return F.relu(torch.cat([F.relu(b1), F.relu(b5), F.relu(b3),
                                 F.relu(bp)], 1))


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([F.relu(b3), F.relu(bd), _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([F.relu(b1), F.relu(b7), F.relu(bd), F.relu(bp)], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3_2(F.relu(self.branch3x3_1(x)))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(
                b7 if i == 1 else F.relu(b7))
        return torch.cat([F.relu(b3), F.relu(b7), _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # Mixed_7c (FIDInceptionE_2)
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = F.relu(self.branch3x3_1(x))
        b3 = torch.cat([F.relu(self.branch3x3_2a(b3)),
                        F.relu(self.branch3x3_2b(b3))], 1)
        bd = F.relu(self.branch3x3dbl_1(x))
        bd = F.relu(self.branch3x3dbl_2(bd))
        bd = torch.cat([F.relu(self.branch3x3dbl_3a(bd)),
                        F.relu(self.branch3x3dbl_3b(bd))], 1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool \
            else _avgpool3(x)
        bp = F.relu(self.branch_pool(pooled))
        return torch.cat([F.relu(b1), b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """[N, 3, H, W] in [0, 255] -> pool3 features [N, 2048] (FID)."""

    _STEM = (("Conv2d_1a_3x3", 3, 32, 3, 2, 0),
             ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
             ("Conv2d_2b_3x3", 32, 64, 3, 1, 1),
             ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
             ("Conv2d_4a_3x3", 80, 192, 3, 1, 0))
    blocks: Sequence[str] = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                             "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                             "Mixed_7a", "Mixed_7b", "Mixed_7c")

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in self._STEM:
            setattr(self, name, BasicConv2d(cin, cout, k, s, p))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.eval()

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Resize, scale, the five stem convs and their two max pools."""
        x = F.interpolate(x, size=(299, 299), mode="bilinear",
                          align_corners=False)
        x = x / 255.0 * 2.0 - 1.0
        for i, (name, *_) in enumerate(self._STEM):
            if i == 3:
                x = _maxpool3s2(x)
            x = F.relu(getattr(self, name)(x))
        return _maxpool3s2(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


def load_inception(state: Dict, device=None) -> InceptionV3Features:
    """The FID Inception on ``state`` (pytorch-fid / torchvision names,
    numpy arrays or tensors); the ``fc`` head is dropped.  Strict but for
    the BatchNorms' ``num_batches_tracked`` counters, which a converted
    file may lack (unused in eval)."""
    mod = InceptionV3Features()
    missing, unexpected = mod.load_state_dict(
        {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
         if not k.startswith("fc.")}, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"Inception weights: missing {missing[:4]}, "
                       f"unexpected {unexpected[:4]}")
    return mod.to(device or "cpu").eval().requires_grad_(False)


def seeded_inception_state(seed: int = 0) -> Dict[str, np.ndarray]:
    """A state dict in pytorch-fid's layout (``fc`` head included) drawn
    from ``seed``: He-scaled conv weights, BatchNorm affine parameters near
    1 / 0, and running statistics measured on seeded noise images (one
    training-mode pass), as a trained BatchNorm would hold them, so the
    activations stay O(1) through the net.  A stand-in for smoke runs and
    tests, NOT the FID network."""
    rng = np.random.default_rng(seed)
    mod = InceptionV3Features()
    state = {}
    for k, v in mod.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            state[k] = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith("bn.weight"):
            state[k] = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("bn.bias"):
            state[k] = rng.standard_normal(shape) * 0.1
    mod.load_state_dict({k: torch.from_numpy(v.astype(np.float32))
                         for k, v in state.items()}, strict=False)
    for m in mod.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # the running statistics of this pass alone
    x = torch.from_numpy(rng.uniform(0, 255, (4, 3, 128, 128)).astype(
        np.float32))
    with torch.no_grad():
        mod.train()(x)
    out = {k: v.numpy().copy() for k, v in mod.state_dict().items()}
    out["fc.weight"] = (rng.standard_normal((1008, 2048)) * 0.01).astype(
        np.float32)
    out["fc.bias"] = np.zeros(1008, np.float32)
    return out


def make_inception_extractor(weights_path: str, device=None,
                             batch_size: int = 50) -> Callable:
    """batch (uint8 NHWC numpy) -> [N, 2048] features (float32 numpy),
    computed on ``device`` (TF32 off) ``batch_size`` patches at a time."""
    mod = load_inception(load_numpy_pickle(weights_path), device)
    dev = next(mod.parameters()).device

    def extract(batch: np.ndarray) -> np.ndarray:
        out = []
        with f32_numerics():
            for i in range(0, batch.shape[0], batch_size):
                x = torch.from_numpy(np.ascontiguousarray(
                    batch[i:i + batch_size])).to(dev)
                x = x.permute(0, 3, 1, 2).to(torch.float32)
                out.append(mod(x).cpu().numpy())
        return np.concatenate(out, axis=0)

    return extract


@contextlib.contextmanager
def f32_numerics():
    """No gradient, and TF32 off for cuDNN and matmuls inside the block
    (restored on exit): the metrics' features are f32 on the card, as on
    the CPU."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
