"""The port's rate-distortion trainer on the CPU, at tiny widths (64x64,
batch 2): stage-1 (``HyperpriorCharmModel``, HiFiC rate loss, LPIPS) and
stage-2 (``InterpCaHyperpriorCharmModel``, the variable-rate loss) recipes.

* a few steps: finite losses, the parameters move, the aux optimizer holds
  ``quantiles`` only and the main one everything else;
* the sampled ``rate_ind`` / ``beta`` sequence is JAX's for the seed;
* a NaN batch is skipped: every parameter, both optimizers' moments and
  step counts (so the LR) stay as they were;
* save -> load -> continue is bit-equal to the uninterrupted run;
* the stage-1 -> stage-2 handoff through the trainer's checkpoint loads the
  tensors JAX's partial merge loads (``tests/test_stage_handoff.py``);
* the CLI (``python -m crdr_tpu_torch.cli.train -d cpu``) trains 2 steps,
  writes its checkpoints, CSV logs and config dump, and auto-resumes.
"""

import csv
import os

import numpy as np
import pytest
import yaml

import jax
import torch

from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu_torch.cli.train import latest_checkpoint_iter, main
from crdr_tpu_torch.data import cycle
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths
from tests.torch_pairs import (jax_params, one_torch_thread,  # noqa: F401
                               tiny_config)

STAGES = {
    1: ("HyperpriorCharmModel",
        {"type": "HificRateLoss", "lambda_A": 0.05, "lambda_B": 0.015625,
         "target_rate": 1.5}),
    2: ("InterpCaHyperpriorCharmModel",
        {"type": "HificVariableRateLoss", "lambda_A": [3.4, 1.3, 0.4],
         "lambda_B": 0.015625, "target_rate": [0.08, 0.16, 0.36]}),
    3: ("BetaCondInterpCaHyperpriorCharmModel", None),
}


def _train_dict(tmp_path, stage=1, exp="tiny"):
    model_type, rate = STAGES[stage]
    opt = tiny_config(model_type).to_dict()
    opt.update({
        "exp": exp, "ckpt_root": str(tmp_path), "start_iter": 0,
        "total_iter": 4, "log_step": 2, "eval_step": 1000, "save_step": 2,
        "time_step": 1000, "keep_step": [], "is_train": True,
        "num_workers": 2,
        "dataset": {
            "batch_size": 2,
            "train_dataset": {"name": "", "type": "SyntheticImageDataset",
                              "num_images": 4, "image_size": 64,
                              "base_size": 72, "uint8_io": True},
            "eval_dataset": {"name": "", "type": "SyntheticImageDataset",
                             "num_images": 1, "image_size": 64,
                             "base_size": 64},
        },
        "optim": {
            "clip_max_norm": 1.0,
            "g_optimizer": {"type": "Adam", "lr": 1e-4},
            "g_scheduler": {"type": "MultiStepLR", "milestones": [3],
                            "gamma": 0.1},
            "aux_optimizer": {"type": "Adam", "lr": 1e-3},
        },
        "loss": {
            "rate_loss": rate or STAGES[2][1],
            "distortion_loss": {"type": "MSELoss", "loss_weight": 150},
            "perceptual_loss": {"type": "LPIPSLoss", "loss_weight": 1.0,
                                "allow_random": True},
        },
        "trainer": {"type": "RateDistortionTrainer"},
    })
    return opt


def _cfg(tmp_path, stage=1, **extra):
    cfg = Config(_train_dict(tmp_path, stage))
    cfg.update(extra)
    fill_paths(cfg)
    return cfg


def _params(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.comp_model.net.named_parameters()}


def _state(trainer):
    out = {f"g.{k}": v.clone() for k, v in trainer.g_opt.state.items()}
    out.update({f"aux.{k}": v.clone()
                for k, v in trainer.aux_opt.state.items()})
    return out


def _batches(trainer, n):
    return [data for _, data in cycle(trainer.train_loader, 0, n)]


@pytest.mark.parametrize("stage", [1, 2])
def test_rd_trainer_steps(tmp_path, stage):
    trainer = build_trainer(_cfg(tmp_path, stage), device="cpu")
    assert trainer.aux_opt.names == ["entropy_model_z.quantiles"]
    assert "entropy_model_z.quantiles" not in trainer.g_opt.names
    assert len(trainer.g_opt.names) + 1 == len(
        list(trainer.comp_model.net.parameters()))
    p0 = _params(trainer)
    for i, data in enumerate(_batches(trainer, 3)):
        log = trainer.optimize_parameters(i + 1, data)
        for key in ("total", "rate", "distortion", "perceptual", "aux",
                    "bpp", "qbpp"):
            assert np.isfinite(log[key]), key
        assert log["aux"] > 0
    p1 = _params(trainer)
    moved = [k for k in p0 if not torch.equal(p0[k], p1[k])]
    assert len(moved) > 0.8 * len(p0)
    assert "entropy_model_z.quantiles" in moved  # the aux step
    assert trainer.step == 3 and int(trainer.g_opt.state["count"]) == 3


def test_rate_and_beta_sequence_is_jaxs(tmp_path):
    """The trainer draws (rate_ind, beta) from the model's numpy generator
    in JAX's order; the flagship class under the RD trainer."""
    cfg = _cfg(tmp_path, 3)
    trainer = build_trainer(cfg, device="cpu")
    jm = jax_build(JaxConfigDict(cfg.to_dict()))
    mine = [trainer.sample_controls(i)[:2] for i in range(12)]
    ref = [(jm.sample_rate_ind(), jm.sample_beta()) for _ in range(12)]
    assert mine == ref
    assert len({r for r, _ in mine}) == 3  # every rate level shows up


def test_nan_batch_is_skipped_and_keeps_the_whole_state(tmp_path):
    trainer = build_trainer(_cfg(tmp_path, 2), device="cpu")
    data = _batches(trainer, 2)
    assert trainer.optimize_parameters(1, data[0]) is not None
    params, state = _params(trainer), _state(trainer)
    lr = float(trainer.g_opt.lr(trainer.g_opt.state["count"]))
    bad = {"real_images": uint8_like_nan(data[1]["real_images"])}
    assert trainer.optimize_parameters(2, bad) is None  # skipped
    for k, v in _params(trainer).items():
        assert torch.equal(v, params[k]), k
    for k, v in _state(trainer).items():
        assert torch.equal(v, state[k]), k
    assert float(trainer.g_opt.lr(trainer.g_opt.state["count"])) == lr
    assert trainer.optimize_parameters(3, data[1]) is not None
    assert int(trainer.g_opt.state["count"]) == 2


def uint8_like_nan(batch):
    """The batch as float with one NaN pixel."""
    x = (batch.astype(np.float32) / 255.0 - 0.5) * 2.0
    x[0, 5, 7, 1] = np.nan
    return x


def test_uint8_batch_converts_as_uint8_to_tensor(tmp_path):
    trainer = build_trainer(_cfg(tmp_path, 1), device="cpu")
    u8 = _batches(trainer, 1)[0]["real_images"]
    assert u8.dtype == np.uint8
    f = (u8.astype(np.float32) / 255.0 - 0.5) * 2.0
    assert torch.equal(trainer.put_batch(u8), trainer.put_batch(f))
    assert trainer.put_batch(u8).shape == (2, 3, 64, 64)


def test_save_load_continue_is_bit_equal(tmp_path):
    cfg = _cfg(tmp_path, 2)
    a = build_trainer(cfg, device="cpu")
    data = _batches(a, 4)
    for i in range(2):
        a.optimize_parameters(i + 1, data[i])
    a.save(2)
    for i in range(2, 4):
        a.optimize_parameters(i + 1, data[i])

    b = build_trainer(_cfg(tmp_path, 2, start_iter=2), device="cpu")
    assert b.step == 2
    for i in range(2, 4):
        b.optimize_parameters(i + 1, data[i])
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    sa, sb = _state(a), _state(b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.noise.generator.get_state(),
                       b.noise.generator.get_state())
    assert a.comp_model.sample_rate_ind() == b.comp_model.sample_rate_ind()


def test_float64_step_is_a_reference_for_the_f32_one(tmp_path):
    """The net and LPIPS cast to float64 run the training forward in
    float64 (the entropy models keep f64 rather than dropping to f32), and
    their losses and gradients agree with the f32 step's on the same noise
    (the card's f32 step is held against such a step)."""
    steps = {}
    for dtype in (torch.float32, torch.float64):
        trainer = build_trainer(_cfg(tmp_path, 1, exp=str(dtype)),
                                device="cpu")
        trainer.comp_model.net.to(dtype)
        trainer.perceptual_loss.to(dtype)
        g = torch.Generator().manual_seed(3)
        noise = lambda name, like: (torch.rand(like.shape, generator=g)
                                    - 0.5).to(like.dtype)
        x = trainer.put_batch(_batches(trainer, 1)[0]["real_images"])
        losses, out, _ = trainer._g_losses(x.to(dtype), 0.0, 0.0, noise)
        assert out["likelihoods"]["y"].dtype == dtype
        sum(losses.values()).backward()
        steps[dtype] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.double() for n, p in
                         trainer.comp_model.net.named_parameters()
                         if p.grad is not None})
    (l32, g32), (l64, g64) = steps[torch.float32], steps[torch.float64]
    for k, v in l64.items():
        assert l32[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert set(g32) == set(g64)
    for n, ref in g64.items():
        err = float(torch.linalg.vector_norm(g32[n] - ref))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(ref)) + 1e-12, n


def test_stage1_to_stage2_handoff_loads_jaxs_tensors(tmp_path):
    s1 = build_trainer(_cfg(tmp_path, 1, exp="s1"), device="cpu")
    s1.optimize_parameters(1, _batches(s1, 1)[0])
    s1.save(1)
    ckpt = os.path.join(str(tmp_path), "s1", "model", "comp_model_iter1.ckpt")
    s2 = build_trainer(_cfg(tmp_path, 2, exp="s2",
                            pretrained_weight_path=ckpt), device="cpu")
    w1 = s1.comp_model.state_dict()
    w2 = s2.comp_model.state_dict()
    loaded = [k for k in w2 if k in w1 and w1[k].shape == w2[k].shape]
    for k in loaded:
        assert torch.equal(w1[k], w2[k]), k
    counts = build_comp_model(_cfg(tmp_path, 2), device="cpu") \
        .load_learned_weight(ckpt)
    assert counts["loaded"] == len(loaded)

    # JAX's partial merge of the same stage-1 weights into its stage-2 model
    _, params1 = jax_params(s1.comp_model, tiny_config(STAGES[1][0]))
    jm2, params2 = jax_params(s2.comp_model, tiny_config(STAGES[2][0]))
    jm2.params = jax.device_put(params2)
    said = []
    jm2.logger = type("Log", (), {"info": staticmethod(said.append)})()
    jm2.load_state_dict({"params": params1})
    assert said == [f"partial load: {counts['loaded']} tensors loaded, "
                    f"{counts['kept']} kept at init (new modules)"]


def test_cli_trains_saves_logs_and_resumes(tmp_path):
    opt = _train_dict(tmp_path / "ck", 1, exp="cli_tiny")
    opt.pop("exp")
    cfg_path = str(tmp_path / "cli_tiny.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(opt, f)
    args = [cfg_path, "-d", "cpu", "-ti", "2", "-s", "2", "-l", "1",
            "-e", "1000"]
    main(args)
    job = tmp_path / "ck" / "cli_tiny"
    for name in ("comp_model_iter2.ckpt", "training_state_iter2.ckpt"):
        assert (job / "model" / name).exists(), name
    with open(job / "log_loss.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["iter"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["total"])) for r in rows)
    assert (job / "cli_tiny_dump.yaml").exists()
    dumped = Config.from_file(str(job / "cli_tiny_dump.yaml"))
    assert dumped.device == "cpu" and dumped.total_iter == 2

    cfg = Config.from_file(cfg_path)
    cfg["ckpt_root"] = str(tmp_path / "ck")
    assert latest_checkpoint_iter(cfg) == 2
    main([cfg_path, "-d", "cpu", "-ti", "3", "-s", "1", "-l", "1", "-e",
          "1000", "--auto_resume"])
    assert (job / "model" / "comp_model_iter3.ckpt").exists()
    with open(job / "log_loss.csv") as f:
        assert [r["iter"] for r in csv.DictReader(f)] == ["1", "2", "3"]


def test_cli_use_wandb_streams_jaxs_keys(tmp_path, monkeypatch):
    """``train -wb -d cpu`` where ``wandb`` is not installed (hidden here,
    should a host have it: ``wandb.init`` needs a login): the port's CLI and
    JAX's (``scripts/train.py``) train the same config for the same steps,
    and their JSONL streams (``{job_dir}/wandb_{exp}.jsonl``) agree line
    for line in ``iter`` and keys (``_ts`` aside): the loss every
    ``wandb_loss_step`` at a log step, ``eval_*`` after validation, the
    time stats, in JAX's order."""
    import json
    import sys

    from scripts.train import main as jax_main

    monkeypatch.setitem(sys.modules, "wandb", None)
    # JAX's CLI would turn on its persistent compilation cache for the rest
    # of this process, under $HOME
    monkeypatch.setattr("crdr_tpu.runtime.cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    streams = []
    for tag, run in (("port", main), ("jax", jax_main)):
        opt = _train_dict(tmp_path / tag / "ck", 1, exp="wb_tiny")
        opt.pop("exp")
        opt.update(wandb_loss_step=1, time_step=1)
        (tmp_path / tag).mkdir()
        cfg_path = str(tmp_path / tag / "wb_tiny.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(opt, f)
        run([cfg_path, "-d", "cpu", "-ti", "2", "-s", "1000", "-l", "1",
             "-e", "2", "-wb"])
        with open(tmp_path / tag / "ck" / "wb_tiny" / "wandb_wb_tiny.jsonl") \
                as f:
            streams.append([(x["iter"], sorted(set(x) - {"_ts"}))
                            for x in map(json.loads, f)])
    ours, theirs = streams
    # iter 1: loss, time; iter 2: loss, eval, time
    assert [i for i, _ in theirs] == [1, 1, 2, 2, 2]
    assert "eval_psnr" in theirs[3][1]
    assert ours == theirs
