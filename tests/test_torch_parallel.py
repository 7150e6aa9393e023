"""Data parallel in the port (``crdr_tpu_torch/parallel/``, the trainers'
``n_devices``) on the CPU: ranks are spawned processes joined over gloo, on
``[cpu] * 2`` (the JAX package's tests run its mesh on 8 virtual CPU
devices, ``tests/test_trainer_dp.py``).

* two ranks at 4 images each follow one process at batch 8 (JAX's
  ``test_trainer_dp.py`` tolerances: losses within 2e-3, parameters rtol
  2e-3 / atol 2e-5 after 3 steps); each rank loads its rows of the
  single-process batches; the ranks hold equal parameters;
* the GAN trainers at 2 ranks (finite losses; RaGAN's global mean logits
  against one process), the BatchNorm refusal, the divisibility guard;
* a checkpoint of 2 ranks resumes in one process;
* the dynamic rate loss over two shards whose qbpp means lie on opposite
  sides of the target equals JAX's ``HificRateLoss`` /
  ``HificVariableRateLoss`` on the global batch;
* ``init_distributed`` with an explicit coordinator that cannot be reached
  raises; the train CLI with ``--n_devices 2 -d cpu``.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crdr_tpu.losses import build_loss as jax_build_loss
from crdr_tpu_torch.cli.train import main as train_main
from crdr_tpu_torch.data import DataLoader, build_dataset
from crdr_tpu_torch.parallel import (gather, init_distributed, make_mesh,
                                     shard_batch, shard_rows, spawn)
from crdr_tpu_torch.utils.device import count_launch
from tests.test_torch_gan_trainer import STAGE3, gan_dict
from tests.test_torch_trainer import _train_dict
from tests.torch_dp import (build_rank, params_of, rate_loss_rank, run_steps,
                            trainer_of)
from tests.torch_pairs import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
BATCH, STEPS, SAVE_AT = 8, 3, 2
LOSS_ABS, RTOL, ATOL = 2e-3, 2e-3, 2e-5  # tests/test_trainer_dp.py


def dp_dict(tmp_path, exp="dp", **extra):
    """The stage-1 tiny recipe of ``tests/test_torch_trainer.py`` at batch
    8 over 12 images: each step is one epoch, so the crops of later steps
    are second and third draws of the same images."""
    opt = _train_dict(tmp_path, 1, exp)
    opt["dataset"]["batch_size"] = BATCH
    opt["dataset"]["train_dataset"]["num_images"] = 12
    opt.update(extra)
    return opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process at batch 8, then 2 ranks of 4 (a checkpoint at step 2),
    3 steps each, from the same seed."""
    tmp = tmp_path_factory.mktemp("dp")
    one = run_steps(0, 1, CPU, dp_dict(tmp, "one"), STEPS)
    two = spawn(run_steps, 2, devices=[CPU] * 2,
                args=(dp_dict(tmp, "two", n_devices=2), STEPS, SAVE_AT))
    return tmp, one, two


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ---------------- the mesh ------------------------------------------------------

def test_make_mesh_and_batch_shards(monkeypatch):
    assert make_mesh(4, [CPU] * 4) == [CPU] * 4
    assert make_mesh(devices=["cuda:0", "cuda:0"]) == [
        torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError):
        make_mesh(3, [CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="explicit device list"):
        make_mesh(2)
    x = torch.arange(24.0).reshape(6, 4)
    mesh = [CPU] * 3
    shards = shard_batch(x, mesh)
    assert [tuple(s.shape) for s in shards] == [(2, 4)] * 3
    assert torch.equal(gather(shards), x)
    assert [tuple(s.shape) for s in shard_batch(x, mesh, dim=1)] == [(6, 4)]
    assert shard_rows(7, mesh) is None
    assert shard_rows(6, mesh) == [slice(0, 2), slice(2, 4), slice(4, 6)]


def test_sharded_loader_gives_the_rows_of_the_global_batches(tmp_path):
    """Rank r's batches are rows [4r, 4r + 4) of the single loader's, over
    three epochs (the crops of epochs 2 and 3 are the images' later
    draws, counted on the ranks that did not load them)."""
    ds_opt = dp_dict(tmp_path)["dataset"]["train_dataset"]

    def batches(shard):
        loader = DataLoader(build_dataset(ds_opt, is_train=True), BATCH,
                            shuffle=True, drop_last=True, seed=5,
                            num_workers=3, shard=shard)
        return [b["real_images"] for _ in range(3) for b in loader]

    full = batches((0, 1))
    parts = [batches((r, 2)) for r in range(2)]
    for i, f in enumerate(full):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][i], parts[1][i]]), f)
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(build_dataset(ds_opt, is_train=True), 6, shard=(0, 4))


def test_launch_count_under_threads():
    """``count_launch`` loses no launch with more threads than cores and a
    short switch interval."""
    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as ex:
            list(ex.map(lambda _: [count_launch(wrapper)
                                   for _ in range(2000)], range(32)))
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 32 * 2000


# ---------------- the data-parallel trainer ------------------------------------

def test_dp_trainer_matches_one_process(runs):
    _, one, two = runs
    assert [r["rank"] for r in two] == [0, 1]
    assert all(r["world"] == 2 for r in two)
    for step in range(STEPS):
        np.testing.assert_array_equal(
            np.concatenate([r["rows"][step] for r in two]),
            one["rows"][step])
    # step 1's averaged gradient, the same on both ranks
    np.testing.assert_array_equal(two[0]["grad1"], two[1]["grad1"])
    g1, g2 = one["grad1"], two[0]["grad1"]
    assert np.linalg.norm(g2 - g1) <= 1e-4 * np.linalg.norm(g1)
    for l1, l2a, l2b in zip(one["logs"], two[0]["logs"], two[1]["logs"]):
        assert l2a == l2b  # the logs are the global batch's on each rank
        for key in ("total", "rate", "distortion", "perceptual", "bpp",
                    "qbpp", "aux"):
            assert abs(l1[key] - l2a[key]) < LOSS_ABS, key
    for k in two[0]["params"]:
        np.testing.assert_array_equal(two[0]["params"][k],
                                      two[1]["params"][k])
    _assert_params_close(two[0]["params"], one["params"])


def test_dp_ranks_bit_equal_to_their_shards_in_one_process(runs):
    """The ranks' arithmetic without a group (the trainer's own step at
    ``micro_batches`` 2: each block's forward on its rows of the global
    noise, the global rate-loss switch, the blocks' gradients summed and
    halved): the parameters after every step bit-equal to the ranks', the
    logs equal to theirs."""
    tmp, _, two = runs
    tr = trainer_of(dp_dict(tmp, "shards"), CPU)
    tr.micro_batches = 2
    for step in range(STEPS):
        log = tr.optimize_parameters(step + 1, {"real_images": np.concatenate(
            [r["rows"][step] for r in two])})
        assert log == two[0]["logs"][step]
        if step == 0:
            np.testing.assert_array_equal(tr.g_opt.flat_grad.numpy(),
                                          two[0]["grad1"])
    for k, v in params_of(tr).items():
        np.testing.assert_array_equal(v, two[0]["params"][k], err_msg=k)


def test_dp_checkpoint_resumes_in_one_process(runs):
    """Rank 0 alone wrote step 2's checkpoint; one process resumes from it
    and its step 3, on the single loader's third batch, follows the two
    ranks' step 3."""
    tmp, _, two = runs
    model_dir = os.path.join(str(tmp), "two", "model")
    assert sorted(os.listdir(model_dir)) == [
        "comp_model_iter2.ckpt", "training_state_iter2.ckpt"]
    tr = trainer_of(dp_dict(tmp, "two"), CPU, start_iter=SAVE_AT)
    assert tr.world == 1 and tr.step == SAVE_AT
    assert int(tr.g_opt.state["count"]) == SAVE_AT
    # a resumed loader starts again from the seed (as in JAX): feed step
    # 3's global batch, the ranks' rows (the single loader's, above)
    data = {"real_images": np.concatenate([r["rows"][-1] for r in two])}
    log = tr.optimize_parameters(SAVE_AT + 1, data)
    for key in ("total", "rate", "distortion", "bpp"):
        assert abs(log[key] - two[0]["logs"][-1][key]) < LOSS_ABS, key
    _assert_params_close(params_of(tr), two[0]["params"])


def test_dp_batch_divisibility_guard(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        trainer_of(dp_dict(tmp_path, n_devices=3), CPU)
    with pytest.raises(RuntimeError, match="--n_devices 2"):
        trainer_of(dp_dict(tmp_path, n_devices=2), CPU)


@pytest.mark.parametrize("trainer", [STAGE3, "RaGANRateDistortionTrainer"])
def test_dp_gan_trainer_steps(tmp_path, trainer):
    """The GAN trainers at 2 ranks: finite losses each step; G's and D's
    parameters equal on the ranks and close to one process's (RaGAN takes
    the mean logits of the global batch)."""
    opt = gan_dict(tmp_path, trainer, exp="gan2")
    opt["dataset"]["batch_size"] = 4
    two = spawn(run_steps, 2, devices=[CPU] * 2,
                args=(dict(opt, n_devices=2), 2))
    one = run_steps(0, 1, CPU, dict(opt, exp="gan1"), 2)
    for log in two[0]["logs"]:
        for key in ("distortion", "rate", "adv", "d_real", "d_fake"):
            assert np.isfinite(log[key]), key
    for l1, l2 in zip(one["logs"], two[0]["logs"]):
        for key in ("total", "adv", "d_real", "d_fake", "out_d_fake"):
            assert abs(l1[key] - l2[key]) < LOSS_ABS, key
    _assert_params_close(two[1]["params"], one["params"])


def test_dp_gan_refuses_batchnorm_discriminator(tmp_path):
    opt = gan_dict(tmp_path)
    opt["discriminator"]["norm_type"] = "BN"
    opt["dataset"]["batch_size"] = 4
    with pytest.raises(RuntimeError, match="BatchNorm"):
        spawn(build_rank, 2, devices=[CPU] * 2,
              args=(dict(opt, n_devices=2),))


# ---------------- the rate loss's switch over shards -----------------------------

RATE_LOSSES = [
    {"type": "HificRateLoss", "lambda_A": 0.05, "lambda_B": 0.015625,
     "target_rate": 1.5},
    {"type": "HificVariableRateLoss", "lambda_A": [3.4, 1.3, 0.4],
     "lambda_B": 0.015625, "target_rate": [0.08, 0.16, 1.5]},
]


def test_dp_rate_loss_switch_is_the_global_batchs():
    """Rank 0's qbpp mean is above the target and rank 1's below: the
    global mean decides for both, as JAX's loss on the whole batch."""
    rng = np.random.default_rng(3)
    bpp = rng.uniform(0.5, 2.5, 8).astype(np.float32)
    qbpp = np.concatenate([rng.uniform(1.7, 2.0, 4),
                           rng.uniform(1.1, 1.3, 4)]).astype(np.float32)
    assert qbpp[:4].mean() > 1.5 > qbpp[4:].mean()
    for loss_opt in RATE_LOSSES:
        for q in (qbpp, qbpp - 0.2):  # the global mean on either side
            ranks = spawn(rate_loss_rank, 2, devices=[CPU] * 2,
                          args=(loss_opt, bpp, q, 2.0))
            want = float(jax_build_loss(loss_opt)(
                jnp.asarray(bpp), jnp.asarray(q), rate_ind=2.0))
            assert ranks[0] == ranks[1]
            np.testing.assert_allclose(ranks[0]["global"], want, rtol=1e-6)
            # deciding on each rank's own mean gives another loss
            assert abs(ranks[0]["local"] - want) > 1e-3 * want


# ---------------- start-up -------------------------------------------------------

def test_init_distributed_without_coordinator_is_one_process(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_unreachable_coordinator_raises(monkeypatch):
    """An explicitly configured group that cannot start raises (JAX's rule);
    nothing listens on the port."""
    from crdr_tpu_torch.parallel.distributed import free_port

    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="explicitly configured"):
        init_distributed(init_timeout=1, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_train_cli_n_devices_on_cpu(tmp_path, monkeypatch):
    """``--n_devices 2 -d cpu``: two gloo ranks train 2 steps; rank 0 writes
    the checkpoints, the CSV log (global means) and the config dump."""
    import csv

    import yaml

    opt = dp_dict(tmp_path / "ck", "cli_dp")
    opt.pop("exp")
    cfg_path = str(tmp_path / "cli_dp.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opt, f)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each rank's torch threads
    train_main([cfg_path, "-d", "cpu", "--n_devices", "2", "-ti", "2", "-s",
                "2", "-l", "1", "-e", "1000", "-nw", "1"])
    job = tmp_path / "ck" / "cli_dp"
    assert sorted(os.listdir(job / "model")) == [
        "comp_model_iter2.ckpt", "training_state_iter2.ckpt"]
    with open(job / "log_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["iter"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["total"])) for r in rows)
    assert (job / "cli_dp_dump.yaml").exists()
