"""The hyper pair's outputs do not follow the card's free memory.

``_hyper_decode`` runs the hyper-decoder's convs and transposed convs
through cuDNN (deterministic, no autotuning).  cuDNN may pick its plan by
the workspace it can get; if it picked another one when the card's memory
is nearly all taken, a decode could get other mu / sigma (and so other
CDF rows) than its encoder, and the stream would not decode.

Here the flagship (``config/crdr.yaml``, entry ``decode_begin``) and the
Balle18 mean-scale model (``config/balle18_mean_scale.yaml``, entry
``generic_params``) run on one seeded z at 512x768 and 2048x3072, first
with the card's memory free, then with a held tensor taking all of it but:

* about 512 MiB, around ``_hyper_decode`` (the hyper pair itself);
* about 512 MiB beyond the entry's own peak, around the entry (at
  2048x3072 the flagship's slice-0 step alone takes 1.1 GiB of im2col
  columns past K1's gate).

Every output is compared bit for bit with the free run's.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_hyper_plans_gpu.py -m gpu

Without a GPU its tests skip.
"""

import os

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models.codec import codec_numerics
from crdr_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEFT_FREE = 512 * 2 ** 20


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: what is held here is cuDNN's choice")
    return torch.device("cuda")


def hyper_outputs(model, entry: str, z_sym: torch.Tensor) -> list:
    """``entry``'s outputs on ``z_sym`` as host arrays, nested tuples
    flattened; under ``codec_numerics``, as the codec calls it."""
    with torch.no_grad(), codec_numerics(model._chain_tf32):
        out = getattr(model, entry)(z_sym)
    torch.cuda.synchronize()
    flat, todo = [], [out]
    while todo:
        t = todo.pop(0)
        if isinstance(t, (tuple, list)):
            todo[:0] = list(t)
        else:
            flat.append(t.cpu().numpy())
    return flat


def peak_bytes(fn) -> int:
    """The bytes ``fn()`` allocates on the card beyond what is held."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    return torch.cuda.max_memory_allocated() - base


def with_memory_taken(fn, left: int = LEFT_FREE):
    """``fn()`` while a tensor holds all but ``left`` bytes of the card's
    free memory (the caching allocator's spare blocks released first)."""
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    hog = torch.empty(max(free - left, 0), dtype=torch.uint8, device="cuda")
    try:
        return fn(), torch.cuda.mem_get_info()[0]
    finally:
        del hog
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(512, 768), (2048, 3072)])
@pytest.mark.parametrize("config,entry", [("crdr.yaml", "decode_begin"),
                                          ("balle18_mean_scale.yaml",
                                           "generic_params")])
def test_hyper_pair_ignores_free_memory_on_gpu(cuda, config, entry, size):
    cfg = Config.from_file(os.path.join(ROOT, "config", config))
    model = build_comp_model(cfg, device=cuda)
    model.codec_setup()
    cz = model.net.entropy_model_z.medians().numel()
    h, w = size[0] // 64, size[1] // 64
    rng = np.random.default_rng(16)
    z_sym = torch.from_numpy(
        rng.integers(-4, 5, (1, h, w, cz)).astype(np.float32)).to(cuda)
    for fn in ("_hyper_decode", entry):
        free_run = hyper_outputs(model, fn, z_sym)
        left = LEFT_FREE
        if fn == entry:
            left += peak_bytes(lambda: hyper_outputs(model, fn, z_sym))
        held_run, free_then = with_memory_taken(
            lambda: hyper_outputs(model, fn, z_sym), left)
        assert free_then < left + LEFT_FREE, \
            f"{free_then} bytes still free under the hog"
        assert len(free_run) == len(held_run)
        for i, (a, b) in enumerate(zip(free_run, held_run)):
            assert a.dtype == b.dtype and a.shape == b.shape
            apart = int(np.sum(a != b))
            assert apart == 0, (f"{fn} output {i} {a.shape}: {apart} values "
                                "differ with the card's memory taken")
