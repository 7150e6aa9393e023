"""Metrics CLI (counterpart of ``scripts/calc_metrics.py``: the same flags,
environment variables, refusals and ``_metrics.json`` keys).

PSNR and MS-SSIM always; LPIPS, FID (the HiFiC patch protocol) and DISTS
only on real weights: ``CRDR_LPIPS_WEIGHTS``, ``CRDR_INCEPTION_WEIGHTS``
(pytorch-fid's Inception state dict) and ``CRDR_DISTS_WEIGHTS`` (the
official DISTS state dict), each a pickle of numpy arrays.  Without them a
leg is skipped and says why (``<NAME>_weights``); ``CRDR_ALLOW_RANDOM_LPIPS``
runs LPIPS on a random init, tagged ``random``; FID needs at least 50
pairs.  Reads ``_avg_bitrate.json`` from the fake dir when present and
writes ``_metrics.json`` there.  The networks run on ``-d`` (the GPU
unless ``cpu``); the FID statistics run on the host in float64.  Images are
PNG: a JPEG pair is refused before any metric runs.

    python -m crdr_tpu_torch.cli.calc_metrics --real_dir kodak \\
        --fake_dir out --metrics psnr ms_ssim
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from glob import glob
from typing import Dict, List, Tuple

import numpy as np

import torch

from ..utils.device import resolve_device
from ..utils.img_utils import calc_ms_ssim, calc_psnr, imread

logger = logging.getLogger("crdr_tpu_torch.cli.calc_metrics")


def _list_images(d: str) -> List[str]:
    out = []
    for e in ("*.png", "*.jpg", "*.jpeg"):
        out.extend(glob(os.path.join(d, e)))
    return sorted(out)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="image quality metrics")
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--metrics", nargs="+",
                   default=["psnr", "ms_ssim", "lpips", "fid"])
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu on request)")
    return p.parse_args(argv)


def pairs_of(real_dir: str, fake_dir: str) -> List[Tuple[str, str]]:
    real_names = {os.path.splitext(os.path.basename(q))[0]: q
                  for q in _list_images(real_dir)}
    pairs = []
    for f in _list_images(fake_dir):
        name = os.path.splitext(os.path.basename(f))[0]
        if name in real_names:
            pairs.append((real_names[name], f))
    if not pairs:
        raise FileNotFoundError("no matching real/fake image pairs")
    jpeg = [p for pair in pairs for p in pair
            if os.path.splitext(p)[1].lower() != ".png"]
    if jpeg:
        raise ValueError(f"{jpeg[0]}: the port reads PNG only (no JPEG "
                         "decoder); convert the images to PNG")
    return pairs


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    pairs = pairs_of(args.real_dir, args.fake_dir)
    results: Dict = {}
    if "psnr" in args.metrics:
        results["PSNR"] = float(np.mean(
            [calc_psnr(imread(r), imread(f)) for r, f in pairs]))
    if "ms_ssim" in args.metrics:
        results["MS-SSIM"] = float(np.mean(
            [calc_ms_ssim(imread(r), imread(f), device=dev)
             for r, f in pairs]))
    # A skipped or random-weight leg records WHY in _metrics.json beside
    # (or instead of) its value, so no bare number of a random network can
    # pass for the metric.
    if "lpips" in args.metrics:
        _record(results, "LPIPS", *_lpips(pairs, dev))
    if "fid" in args.metrics:
        _record(results, "FID", *_fid(pairs, dev))
    if "dists" in args.metrics:
        _record(results, "DISTS", *_dists(pairs, dev))
    rate_json = os.path.join(args.fake_dir, "_avg_bitrate.json")
    if os.path.exists(rate_json):
        with open(rate_json) as f:
            results["bpp"] = json.load(f)["avg_bpp"]
    with open(os.path.join(args.fake_dir, "_metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    logger.info(json.dumps(results, indent=2))
    return results


def _record(results: Dict, name: str, value, status: str) -> None:
    """value None -> the metric omitted; a status other than 'pretrained'
    is recorded beside the value."""
    if value is not None:
        results[name] = value
    if status != "pretrained":
        results[f"{name}_weights"] = status


def _nchw(img: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(img).permute(2, 0, 1)[None].to(dev)


def _lpips(pairs, dev):
    if not os.environ.get("CRDR_LPIPS_WEIGHTS"):
        if os.environ.get("CRDR_ALLOW_RANDOM_LPIPS"):
            logger.warning("LPIPS computed with RANDOM weights: tagged in "
                           "_metrics.json; NOT comparable to the reference")
            return _lpips_value(pairs, dev), "random"
        logger.warning("LPIPS skipped: set CRDR_LPIPS_WEIGHTS to enable")
        return None, "skipped: no pretrained weights"
    return _lpips_value(pairs, dev), "pretrained"


def _lpips_value(pairs, dev) -> float:
    from ..losses.perceptual_loss import LPIPSLoss
    from ..metrics.inception import f32_numerics

    loss = LPIPSLoss(loss_weight=1.0).to(dev)
    with f32_numerics():
        vals = [float(loss(_nchw(imread(r), dev), _nchw(imread(f), dev)))
                for r, f in pairs]
    return float(np.mean(vals))


def _dists(pairs, dev):
    if not os.environ.get("CRDR_DISTS_WEIGHTS"):
        logger.warning("DISTS skipped: set CRDR_DISTS_WEIGHTS to enable")
        return None, "skipped: no pretrained weights"
    from ..metrics.dists import DISTS, load_dists_params
    from ..metrics.inception import f32_numerics
    from ..utils.numpy_pickle import load_numpy_pickle

    mod = DISTS()
    mod.load_state_dict(load_dists_params(load_numpy_pickle(
        os.environ["CRDR_DISTS_WEIGHTS"])))
    mod = mod.to(dev).eval()
    vals = []
    with f32_numerics():
        for r, fk in pairs:
            # DISTS takes [0, 1] inputs (reference calc_metrics.py:195-216)
            a = (_nchw(imread(r), dev) + 1) / 2
            b = (_nchw(imread(fk), dev) + 1) / 2
            vals.append(float(mod(a, b)[0]))
    return float(np.mean(vals)), "pretrained"


def _fid(pairs, dev):
    if len(pairs) < 50:
        logger.error(f"num_img (={len(pairs)}) is too small to calc FID")
        return None, f"skipped: {len(pairs)} images < 50 (HiFiC protocol)"
    if not os.environ.get("CRDR_INCEPTION_WEIGHTS"):
        logger.warning("FID skipped: set CRDR_INCEPTION_WEIGHTS to enable")
        return None, "skipped: no pretrained weights"
    from ..metrics.fid import fid_from_image_lists
    from ..metrics.inception import make_inception_extractor
    from ..utils.img_utils import read_png

    extractor = make_inception_extractor(
        os.environ["CRDR_INCEPTION_WEIGHTS"], dev)
    reals = (read_png(r) for r, _ in pairs)
    fakes = (read_png(f) for _, f in pairs)
    return fid_from_image_lists(reals, fakes, extractor), "pretrained"


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
