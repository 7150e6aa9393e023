"""Training on the card against training on the CPU, at tiny widths.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_train_gpu.py -m gpu

Without a GPU its tests skip (the CPU's own tests are
``tests/test_torch_trainer.py`` and ``tests/test_torch_train_forward.py``).
The same weights, batch and noise go through one f32 training step (TF32
off) on each device: the losses within rtol 1e-4 and every gradient within
a relative L2 error of 1e-3.  On the card alone: the GDN model's step
launches K3 six times and gives every GDN parameter a gradient, and a
resumed run repeats the uninterrupted one bit for bit.
"""

import pytest

import torch

from crdr_tpu_torch.data import cycle
from crdr_tpu_torch.nn import GDN
from crdr_tpu_torch.ops.gdn import gdn
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths

RTOL, GRAD_REL = 1e-4, 1e-3
ELIC = {
    "model_type": "InterpCaHyperpriorCharmModel",
    "subnet": {
        "encoder": {"type": "ElicInterpCaEncoder", "in_ch": 3, "out_ch": 32,
                    "main_ch": 16, "block_mid_ch": 8, "rate_level": 3,
                    "ca_kwargs": {"actv": "softplus", "use_interp": True,
                                  "use_bias": True}},
        "decoder": {"type": "ElicInterpCaDecoder", "in_ch": 32, "out_ch": 3,
                    "main_ch": 16, "block_mid_ch": 8, "pixel_shuffle": False,
                    "use_tanh": False, "rate_level": 3,
                    "ca_kwargs": {"actv": "softplus", "use_interp": True,
                                  "use_bias": True}},
        "hyperencoder": {"type": "Minnen20HyperEncoder", "bottleneck_y": 32,
                         "bottleneck_z": 16},
        "hyperdecoder": {"type": "Minnen20HyperDecoder", "bottleneck_z": 16,
                         "hyper_out_ch": 64},
        "context_model": {"type": "Minnen20CharmContextModel",
                          "num_slices": 2, "hyper_out_ch": 64,
                          "bottleneck_y": 32, "max_support_slices": 2},
        "entropy_model_z": {"type": "SteEntropyBottleneck", "channels": 16},
        "entropy_model_y": {"type": "SteGaussianMeanScaleConditional",
                            "scale_bound": 0.11}},
    "loss": {"rate_loss": {"type": "HificVariableRateLoss",
                           "lambda_A": [3.4, 1.3, 0.4], "lambda_B": 0.015625,
                           "target_rate": [0.08, 0.16, 0.36]}},
}
GDN_MODEL = {
    "model_type": "HyperpriorModel",
    "subnet": {
        "encoder": {"type": "Balle18Encoder", "in_ch": 3, "out_ch": 32,
                    "main_ch": 64},
        "decoder": {"type": "Balle18Decoder", "in_ch": 32, "out_ch": 3,
                    "main_ch": 64, "use_tanh": False},
        "hyperencoder": {"type": "Balle18HyperEncoder", "in_ch": 32,
                         "out_ch": 16, "main_ch": 16},
        "hyperdecoder": {"type": "Balle18HyperDecoder", "in_ch": 16,
                         "out_ch": 64, "main_ch": 16},
        "entropy_model_z": {"type": "SteEntropyBottleneck", "channels": 16},
        "entropy_model_y": {"type": "SteGaussianMeanScaleConditional",
                            "scale_bound": 0.11}},
    "loss": {"rate_loss": {"type": "HificRateLoss", "lambda_A": 0.05,
                           "lambda_B": 0.015625, "target_rate": 1.5}},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these tests hold the card's training "
                    "against the CPU's")
    return torch.device("cuda")


def _cfg(tmp_path, model, **extra):
    cfg = {
        "exp": "gpu", "ckpt_root": str(tmp_path), "seed": 0, "start_iter": 0,
        "total_iter": 4, "log_step": 2, "eval_step": 1000, "save_step": 1000,
        "keep_step": [], "num_workers": 2,
        "dataset": {"batch_size": 2,
                    "train_dataset": {"name": "",
                                      "type": "SyntheticImageDataset",
                                      "num_images": 4, "image_size": 64,
                                      "base_size": 72, "uint8_io": True},
                    "eval_dataset": {"name": "",
                                     "type": "SyntheticImageDataset",
                                     "num_images": 1, "image_size": 64,
                                     "base_size": 64}},
        "optim": {"clip_max_norm": 1.0,
                  "g_optimizer": {"type": "Adam", "lr": 1e-4},
                  "aux_optimizer": {"type": "Adam", "lr": 1e-3}},
        "trainer": {"type": "RateDistortionTrainer"}}
    cfg.update({k: v for k, v in model.items() if k != "loss"})
    cfg["loss"] = {**model["loss"],
                   "distortion_loss": {"type": "MSELoss", "loss_weight": 150},
                   "perceptual_loss": {"type": "LPIPSLoss", "loss_weight": 1.0,
                                       "allow_random": True}}
    cfg.update(extra)
    cfg = Config(cfg)
    fill_paths(cfg)
    return cfg


def _step(trainer, batch, noise):
    trainer.comp_model.net.zero_grad(set_to_none=True)
    losses, _, _ = trainer._g_losses(trainer.put_batch(batch), 1.0, 0.0,
                                     noise)
    total = sum(losses.values())
    total.backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad for n, p in trainer.comp_model.net.named_parameters()})


@pytest.mark.gpu
@pytest.mark.parametrize("model", [ELIC, GDN_MODEL], ids=["charm", "gdn"])
def test_card_step_matches_cpu_step(cuda, tmp_path, model):
    cpu = build_trainer(_cfg(tmp_path, model), device="cpu")
    card = build_trainer(_cfg(tmp_path, model), device=cuda)
    card.comp_model.load_state_dict(cpu.comp_model.state_dict(), strict=True)
    batch = next(iter(cpu.train_loader))["real_images"]
    drawn, g = {}, torch.Generator().manual_seed(1)

    def record(name, like):
        drawn[name] = torch.rand(like.shape, generator=g) - 0.5
        return drawn[name]

    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        loss_c, grad_c = _step(cpu, batch, record)
        loss_g, grad_g = _step(card, batch,
                               lambda name, like: drawn[name].to(like.device))
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
    for k, v in loss_c.items():
        assert loss_g[k] == pytest.approx(v, rel=RTOL), k
    for name, gc in grad_c.items():
        gg = grad_g[name]
        if gc is None:
            assert gg is None or not gg.any(), name
            continue
        err = torch.linalg.vector_norm((gg.cpu() - gc).double())
        assert err <= GRAD_REL * torch.linalg.vector_norm(gc.double()), name


@pytest.mark.gpu
def test_gdn_step_launches_k3_six_times(cuda, tmp_path):
    trainer = build_trainer(_cfg(tmp_path, GDN_MODEL), device=cuda)
    data = next(iter(trainer.train_loader))
    gdn.launches = 0
    log = trainer.optimize_parameters(1, data)
    assert gdn.launches == 6 and log is not None
    for m in trainer.comp_model.net.modules():
        if isinstance(m, GDN):
            assert m.beta.grad.any() and m.gamma.grad.any()


@pytest.mark.gpu
def test_resume_is_bit_equal_on_the_card(cuda, tmp_path):
    a = build_trainer(_cfg(tmp_path, ELIC), device=cuda)
    data = [d for _, d in cycle(a.train_loader, 0, 4)]
    for i in range(2):
        a.optimize_parameters(i + 1, data[i])
    a.save(2)
    for i in range(2, 4):
        a.optimize_parameters(i + 1, data[i])
    b = build_trainer(_cfg(tmp_path, ELIC, start_iter=2), device=cuda)
    for i in range(2, 4):
        b.optimize_parameters(i + 1, data[i])
    for (n, p), (_, q) in zip(a.comp_model.net.named_parameters(),
                              b.comp_model.net.named_parameters()):
        assert torch.equal(p, q), n
    for k, v in a.g_opt.state.items():
        assert torch.equal(v, b.g_opt.state[k]), k
