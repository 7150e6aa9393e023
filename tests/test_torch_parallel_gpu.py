"""Several devices on one card, at tiny widths: two data-parallel ranks on
``cuda:0`` over gloo (NCCL refuses two ranks on one GPU) against one
process, and a serving mesh of two replicas on ``cuda:0`` against one
device.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu

Without a GPU its tests skip (the CPU's own tests are
``tests/test_torch_parallel.py`` and ``tests/test_torch_serving_mesh.py``).
"""

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.parallel import spawn
from crdr_tpu_torch.utils.config import Config
# siblings by their bare names: pytest puts tests/ on the path, and the
# card's machine may have a ``tests`` package of its own
from test_torch_train_gpu import ELIC, _cfg
from torch_dp import params_of, run_steps, trainer_of

LOSS_ABS = 2e-3  # tests/test_trainer_dp.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these tests run ranks and replicas on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_two_ranks_on_one_card_follow_one_process(cuda, tmp_path):
    """One f32 step (TF32 off in each process) at batch 4: 2 ranks of 2
    images each against one process at batch 4 (losses, the averaged
    gradient) and, bit for bit, against one process taking the same two
    shards with no group (the trainer's step at ``micro_batches`` 2)."""
    opt = _cfg(tmp_path, ELIC, total_iter=1).to_dict()
    opt["dataset"]["batch_size"] = 4
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        one = run_steps(0, 1, cuda, dict(opt, exp="one"), 1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    two = spawn(_f32_rank, 2, backend="gloo", devices=[cuda, cuda],
                args=(dict(opt, exp="two", n_devices=2), 1))
    np.testing.assert_array_equal(
        np.concatenate([r["rows"][0] for r in two]), one["rows"][0])
    for key in ("total", "rate", "distortion", "bpp"):
        assert abs(two[0]["logs"][0][key] - one["logs"][0][key]) < LOSS_ABS
    g1, g2 = one["grad1"], two[0]["grad1"]
    assert np.linalg.norm(g2 - g1) <= 1e-3 * np.linalg.norm(g1)
    torch.backends.cudnn.allow_tf32 = False
    try:
        tr = trainer_of(dict(opt, exp="shards"), cuda)
        tr.micro_batches = 2
        tr.optimize_parameters(1, {"real_images": np.concatenate(
            [r["rows"][0] for r in two])})
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    np.testing.assert_array_equal(tr.g_opt.flat_grad.cpu().numpy(), g2)
    for k, v in params_of(tr).items():
        np.testing.assert_array_equal(two[0]["params"][k],
                                      two[1]["params"][k])
        np.testing.assert_array_equal(two[0]["params"][k], v, err_msg=k)


def _f32_rank(rank, world, device, opt, steps):
    torch.backends.cudnn.allow_tf32 = False
    return run_steps(rank, world, device, opt, steps)


@pytest.mark.gpu
def test_two_replicas_on_one_card_byte_equal(cuda, tmp_path):
    """serving_devices 2 on [cuda:0, cuda:0], both wires: the streams and
    the decodes of a batch of 4 equal one device's."""
    base = _cfg(tmp_path, ELIC).to_dict()
    x = np.random.default_rng(0).integers(0, 256, (4, 64, 96, 3), np.uint8)
    for wire in ("compressai", "device"):
        models = []
        for n in (1, 2):
            m = build_comp_model(Config(dict(
                base, serving_devices=n, wire_format=wire,
                device_wire_lanes=8, is_train=False)), device=cuda)
            m.codec_setup([cuda, cuda] if n == 2 else None)
            models.append(m)
        one, two = models
        assert len(two._replicas) == 2
        e1 = one.compress_batch(x, rate_ind=1.5)
        e2 = two.compress_batch(x, rate_ind=1.5)
        assert [e["string_list"] for e in e1] == [e["string_list"]
                                                  for e in e2], wire
        f1, _, y1 = one.decompress_batch([e["string_list"] for e in e1])
        f2, _, y2 = two.decompress_batch([e["string_list"] for e in e2])
        np.testing.assert_array_equal(y2, y1)
        np.testing.assert_array_equal(f2, f1)
