"""The port's evaluation CLIs (``python -m crdr_tpu_torch.cli.{rd_sweep,
calc_metrics,bd_rate}``) at ``-d cpu`` against ``scripts/{rd_sweep,
calc_metrics,bd_rate}.py`` on ``tests/test_cli.py``'s fixture (the tiny
flagship config, two 72x96 PNGs).

Both packages load one checkpoint: the port's seeded init with y spanning
several bins and the y scales raised (``tests/torch_pairs.py``'s edits),
the encoder's last InterpCA gain rising with the level, saved as a reference ``.pth.tar`` that the JAX package imports.

* rd_sweep: the same CSV columns and rows; quality, beta and bpp equal
  (the streams are byte-identical), PSNR within 0.01 dB and MS-SSIM within
  1e-4 (the decoded f32 images differ by the two frameworks' rounding, and
  the port's MS-SSIM is float64, JAX's f32); the batched sweep gives the
  ``--no_rate_batch`` sweep's CSV.
* calc_metrics: the same ``_metrics.json`` keys; PSNR and bpp equal,
  MS-SSIM within 1e-5, LPIPS and DISTS on one weight file each within rtol
  1e-5; the same refusals (no weights, random LPIPS tagged, FID under 50
  pairs) and a JPEG pair refused.
* bd_rate: the same JSON line on two sweeps' CSVs.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from crdr_tpu_torch.cli import bd_rate, calc_metrics, rd_sweep
from crdr_tpu_torch.metrics.dists import seeded_dists_state
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.utils.config import Config
from crdr_tpu_torch.utils.img_utils import read_png, write_png
from tests.test_cli import tiny_config_and_images  # noqa: F401
from tests.torch_pairs import SCALE_BIAS, Y_GAIN, one_torch_thread  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = ["--qualities", "0.0", "0.5", "1.25", "2.0", "--betas", "1.28", "4.0"]


@pytest.fixture(scope="module")
def setup(tiny_config_and_images):  # noqa: F811
    cfg_path, img_dir, tmp = tiny_config_and_images
    pm = build_comp_model(Config.from_file(cfg_path), device="cpu")
    with torch.no_grad():
        pm.net.encoder.conv4.weight.mul_(Y_GAIN)
        pm.net.encoder.conv4.bias.mul_(Y_GAIN)
        for st in pm.net.context_model.scale_slice_transforms:
            st.model[4].bias += SCALE_BIAS
        # the init's InterpCA rows are equal at every level: a last gain
        # rising with the level makes the rate rise with the quality
        pm.net.encoder.interp_ca_list[-1].weight += \
            0.25 * torch.arange(3.0).view(3, 1, 1, 1, 1)
    ckpt = os.path.join(tmp, "eval_cli.pth.tar")
    torch.save({"comp_model": pm.state_dict()}, ckpt)
    return cfg_path, img_dir, tmp, ckpt


def _csv(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def sweeps(setup):
    from scripts.rd_sweep import main as jax_sweep

    cfg_path, img_dir, tmp, ckpt = setup
    out = {}
    for name, fn, extra in [
            ("jax", jax_sweep, []),
            ("port", rd_sweep.main, ["-d", "cpu"]),
            ("port_serial", rd_sweep.main, ["-d", "cpu", "--no_rate_batch"])]:
        d = os.path.join(tmp, f"sweep_{name}")
        fn([cfg_path, "--model_path", ckpt, "--img_dir", img_dir,
            "--save_dir", d] + SWEEP + extra)
        out[name] = os.path.join(d, "rd_curve.csv")
    return out


def test_rd_sweep_csv_matches_jax(sweeps):
    jax_rows, port_rows = _csv(sweeps["jax"]), _csv(sweeps["port"])
    assert list(port_rows[0]) == ["quality", "beta", "bpp", "psnr",
                                  "ms_ssim"]
    assert list(port_rows[0]) == list(jax_rows[0])
    assert len(port_rows) == len(jax_rows) == 8
    for p, j in zip(port_rows, jax_rows):
        for k in ("quality", "beta", "bpp"):
            assert p[k] == j[k]
        assert float(p["psnr"]) == pytest.approx(float(j["psnr"]), abs=0.01)
        assert float(p["ms_ssim"]) == pytest.approx(float(j["ms_ssim"]),
                                                    abs=1e-4)
    bpp = [float(r["bpp"]) for r in port_rows]
    assert bpp[6] > bpp[4] > bpp[2] > bpp[0]  # rising with the quality


def test_rd_sweep_batched_equals_serial(sweeps):
    with open(sweeps["port"]) as a, open(sweeps["port_serial"]) as b:
        assert a.read() == b.read()


def test_bd_rate_cli_matches_jax(sweeps):
    args = [sweeps["port"], sweeps["jax"], "--beta", "1.28",
            "--method", "poly3"]
    ref = subprocess.run([sys.executable,
                          os.path.join(REPO, "scripts", "bd_rate.py")] + args,
                         capture_output=True, text=True, check=True, cwd=REPO)
    mine = subprocess.run([sys.executable, "-m", "crdr_tpu_torch.cli.bd_rate"]
                          + args, capture_output=True, text=True, check=True,
                          cwd=REPO)
    assert mine.stdout == ref.stdout
    out = json.loads(mine.stdout)
    assert out["anchor_points"] == out["test_points"] == 4


@pytest.fixture(scope="module")
def fake_dir(setup):
    """Noisy copies of the fixture's images and an ``_avg_bitrate.json``."""
    _, img_dir, tmp, _ = setup
    d = os.path.join(tmp, "fakes")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(img_dir)):
        img = read_png(os.path.join(img_dir, name)).astype(np.int32)
        noisy = np.clip(img + rng.integers(-12, 13, img.shape), 0, 255)
        write_png(os.path.join(d, name), noisy.astype(np.uint8))
    with open(os.path.join(d, "_avg_bitrate.json"), "w") as f:
        json.dump({"avg_bpp": 0.75}, f)
    return d


def _both(img_dir, d, metrics):
    from scripts.calc_metrics import main as jax_metrics

    ref = jax_metrics(["--real_dir", img_dir, "--fake_dir", d,
                       "--metrics"] + metrics)
    mine = calc_metrics.main(["--real_dir", img_dir, "--fake_dir", d,
                              "-d", "cpu", "--metrics"] + metrics)
    with open(os.path.join(d, "_metrics.json")) as f:
        assert json.load(f) == mine
    return mine, ref


def test_calc_metrics_matches_jax_on_weights(setup, fake_dir, tmp_path,
                                             monkeypatch):
    import jax

    from crdr_tpu.metrics.lpips import init_lpips as jax_init_lpips
    from tests.test_torch_losses import _torchvision_like

    _, img_dir, _, _ = setup
    lp, ds = str(tmp_path / "lpips.pkl"), str(tmp_path / "dists.pkl")
    with open(lp, "wb") as f:
        pickle.dump(_torchvision_like(jax_init_lpips(jax.random.PRNGKey(2))),
                    f)
    with open(ds, "wb") as f:
        pickle.dump(seeded_dists_state(3), f)
    monkeypatch.setenv("CRDR_LPIPS_WEIGHTS", lp)
    monkeypatch.setenv("CRDR_DISTS_WEIGHTS", ds)
    mine, ref = _both(img_dir, fake_dir, ["psnr", "ms_ssim", "lpips",
                                          "dists"])
    assert sorted(mine) == sorted(ref) == ["DISTS", "LPIPS", "MS-SSIM",
                                           "PSNR", "bpp"]
    assert mine["PSNR"] == ref["PSNR"] and mine["bpp"] == ref["bpp"] == 0.75
    assert mine["MS-SSIM"] == pytest.approx(ref["MS-SSIM"], abs=1e-5)
    for k in ("LPIPS", "DISTS"):
        assert mine[k] == pytest.approx(ref[k], rel=1e-5)
        assert mine[k] != 0


def test_calc_metrics_refusals_match_jax(setup, fake_dir, monkeypatch):
    _, img_dir, _, _ = setup
    for var in ("CRDR_LPIPS_WEIGHTS", "CRDR_INCEPTION_WEIGHTS",
                "CRDR_DISTS_WEIGHTS", "CRDR_ALLOW_RANDOM_LPIPS"):
        monkeypatch.delenv(var, raising=False)
    everything = ["psnr", "lpips", "fid", "dists"]
    mine, ref = _both(img_dir, fake_dir, everything)
    assert mine == ref
    assert mine["LPIPS_weights"] == "skipped: no pretrained weights"
    assert mine["FID_weights"] == "skipped: 2 images < 50 (HiFiC protocol)"
    assert "LPIPS" not in mine and "FID" not in mine and "DISTS" not in mine
    monkeypatch.setenv("CRDR_ALLOW_RANDOM_LPIPS", "1")
    mine, ref = _both(img_dir, fake_dir, ["lpips"])
    assert mine["LPIPS_weights"] == ref["LPIPS_weights"] == "random"
    assert sorted(mine) == sorted(ref)


def test_calc_metrics_refuses_jpeg(setup, tmp_path):
    _, img_dir, _, _ = setup
    fakes = tmp_path / "jpeg_fakes"
    fakes.mkdir()
    name = sorted(os.listdir(img_dir))[0]
    shutil.copy(os.path.join(img_dir, name),
                fakes / (os.path.splitext(name)[0] + ".jpg"))
    with pytest.raises(ValueError, match="PNG only"):
        calc_metrics.main(["--real_dir", img_dir, "--fake_dir", str(fakes),
                           "-d", "cpu", "--metrics", "psnr"])
    with pytest.raises(FileNotFoundError, match="no matching"):
        calc_metrics.main(["--real_dir", img_dir, "--fake_dir",
                           str(tmp_path), "-d", "cpu"])
    assert bd_rate.LOWER_BETTER == {"lpips", "dists", "fid"}
