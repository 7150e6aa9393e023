"""Stage-3 (GAN) training on the card against the CPU, at tiny widths.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gan_gpu.py -m gpu

Without a GPU its tests skip (the CPU's own tests are
``tests/test_torch_gan_trainer.py`` and ``tests/test_torch_gan.py``).  The
stage-3 trainer (``MultirateBetaCondHrrGanRateDistortionTrainer``, the
flagship class at main_ch 16, a module list of three CLIC21
sub-discriminators at main_ch 8) takes the same weights, batch and noise on
each device through one f32 step (TF32 off), at a low rate (with the
anchor forward) and at the top rate: G's and D's losses within rtol 1e-4,
every gradient of G and of D within a relative L2 error of 1e-3 (a
gradient that is zero on the CPU, the RGAN head bias's, within 5e-5 of the
largest).  Then a few steps on the card, and a resumed run that repeats
the uninterrupted one bit for bit: G, D, both optimizers of G, D's
optimizer, D's state and the generators.
"""

import pytest

import torch

from crdr_tpu_torch.data import cycle
from crdr_tpu_torch.trainer import build_trainer
from crdr_tpu_torch.utils.config import Config, fill_paths

RTOL, GRAD_REL = 1e-4, 1e-3
CA = {"actv": "softplus", "use_interp": True, "use_bias": True}
FLAGSHIP = {
    "model_type": "BetaCondInterpCaHyperpriorCharmModel",
    "subnet": {
        "encoder": {"type": "ElicInterpCaEncoder", "in_ch": 3, "out_ch": 32,
                    "main_ch": 16, "block_mid_ch": 8, "rate_level": 3,
                    "ca_kwargs": CA},
        "decoder": {"type": "ElicInterpCaBetaCondDecoder", "in_ch": 32,
                    "out_ch": 3, "main_ch": 16, "block_mid_ch": 8,
                    "pixel_shuffle": False, "use_tanh": False,
                    "rate_level": 3, "ca_kwargs": CA, "L": 4,
                    "max_beta": 5.12, "cond_ch": 16, "use_pi": False,
                    "weight_init": True},
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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: these tests hold the card's stage-3 "
                    "training against the CPU's")
    return torch.device("cuda")


def _cfg(tmp_path, **extra):
    cfg = {
        "exp": "gan_gpu", "ckpt_root": str(tmp_path), "seed": 0,
        "start_iter": 0, "total_iter": 4, "log_step": 2, "eval_step": 1000,
        "save_step": 1000, "keep_step": [], "num_workers": 2,
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
                  "aux_optimizer": {"type": "Adam", "lr": 1e-3},
                  "d_optimizer": {"type": "Adam", "lr": 1e-4}},
        "loss": {"rate_loss": {"type": "HificVariableRateLoss",
                               "lambda_A": [3.4, 1.3, 0.4],
                               "lambda_B": 0.015625,
                               "target_rate": [0.0, 0.0, 0.0]},
                 "distortion_loss": {"type": "MSELoss", "loss_weight": 150},
                 "perceptual_loss": {"type": "LPIPSLoss",
                                     "loss_weight": 0.390625,
                                     "allow_random": True},
                 "gan_loss": {"type": "VanillaGANLoss", "loss_weight": 0.05}},
        "discriminator": {"type": "ModuleListDiscriminator",
                          "_subd_type": "CLIC21GVAEDiscriminator",
                          "_num_subd": 3, "in_ch": 3, "out_ch": 1,
                          "main_ch": 8, "norm_type": "none"},
        "trainer": {"type": "MultirateBetaCondHrrGanRateDistortionTrainer"},
        **FLAGSHIP}
    cfg.update(extra)
    cfg = Config(cfg)
    fill_paths(cfg)
    return cfg


def gan_step_grads(trainer, batch, rate_ind, beta, noise):
    """One stage-3 step's G and D halves without the updates: (losses of
    both, G's gradients, D's gradients)."""
    net, d = trainer.comp_model.net, trainer.discriminator
    net.zero_grad(set_to_none=True)
    d.zero_grad(set_to_none=True)
    trainer.comp_model.noise = noise
    x = trainer.put_batch(batch)
    total, losses, out, _ = trainer.gan_g_losses(x, rate_ind, beta)
    total.backward()
    dl = trainer.gan_d_losses(x, out["fake_images"].detach(),
                              out["quantized_code"]["y"].detach(), rate_ind)
    dl["d_total"].backward()
    vals = {k: float(v.detach()) for k, v in {**losses, "total": total,
                                              **dl}.items()}
    return vals, {n: p.grad for n, p in net.named_parameters()}, \
        {n: p.grad for n, p in d.named_parameters()}


@pytest.mark.gpu
@pytest.mark.parametrize("rate_ind", [0.0, 2.0], ids=["anchor", "top"])
def test_card_stage3_step_matches_cpu_step(cuda, tmp_path, rate_ind):
    cpu = build_trainer(_cfg(tmp_path), device="cpu")
    card = build_trainer(_cfg(tmp_path), device=cuda)
    card.comp_model.load_state_dict(cpu.comp_model.state_dict(), strict=True)
    card.discriminator.load_state_dict(cpu.discriminator.state_dict())
    card.perceptual_loss.load_state_dict(cpu.perceptual_loss.state_dict())
    batch = next(iter(cpu.train_loader))["real_images"]
    drawn, g = [], torch.Generator().manual_seed(1)

    def record(name, like):
        drawn.append(torch.rand(like.shape, generator=g) - 0.5)
        return drawn[-1]

    replay = iter(drawn)
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        ref = gan_step_grads(cpu, batch, rate_ind, 2.56, record)
        got = gan_step_grads(card, batch, rate_ind, 2.56,
                             lambda name, like: next(replay).to(like.device))
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
    for k, v in ref[0].items():
        assert got[0][k] == pytest.approx(v, rel=RTOL, abs=1e-7), k
    for part in (1, 2):
        top = max(float(torch.linalg.vector_norm(v.double()))
                  for v in ref[part].values() if v is not None)
        for name, gc in ref[part].items():
            gg = got[part][name]
            if gc is None:
                assert gg is None or not gg.any(), name
                continue
            err = float(torch.linalg.vector_norm((gg.cpu() - gc).double()))
            assert err <= GRAD_REL * float(torch.linalg.vector_norm(
                gc.double())) + 5e-5 * top, name


@pytest.mark.gpu
def test_stage3_steps_and_resume_are_bit_equal_on_the_card(cuda, tmp_path):
    a = build_trainer(_cfg(tmp_path), device=cuda)
    data = [d for _, d in cycle(a.train_loader, 0, 4)]
    d0 = [p.detach().clone() for p in a.discriminator.parameters()]
    for i in range(2):
        log = a.optimize_parameters(i + 1, data[i])
        assert log is not None and all(
            torch.isfinite(torch.tensor(v)) for v in log.values())
    assert any(not torch.equal(p, q) for p, q in
               zip(d0, a.discriminator.parameters()))
    a.save(2)
    for i in range(2, 4):
        a.optimize_parameters(i + 1, data[i])
    b = build_trainer(_cfg(tmp_path, start_iter=2), device=cuda)
    for i in range(2, 4):
        b.optimize_parameters(i + 1, data[i])
    pairs = list(zip(a.comp_model.net.state_dict().items(),
                     b.comp_model.net.state_dict().items()))
    pairs += list(zip(a.discriminator.state_dict().items(),
                      b.discriminator.state_dict().items()))
    for oa, ob in ((a.g_opt, b.g_opt), (a.aux_opt, b.aux_opt),
                   (a.d_opt, b.d_opt)):
        pairs += list(zip(oa.state.items(), ob.state.items()))
    for (n, p), (_, q) in pairs:
        assert torch.equal(p, q), n
    assert torch.equal(a.noise.generator.get_state(),
                       b.noise.generator.get_state())
