"""RD-curve sweep (counterpart of ``scripts/rd_sweep.py``, same flags and
CSV): compress + decompress a directory at the paper's protocol (17 quality
values x 2 betas; the reference's rd_results/README.md) and write
``rd_curve.csv`` with the JAX script's columns,
``quality,beta,bpp,psnr,ms_ssim``.

By default each image is swept as one mixed-rate batch: ONE
``compress_batch`` of the image repeated once per quality (a rate per row
conditions InterpCA), and one ``decompress_batch`` per (image, beta) of all
its streams, so the Charm decode's serial round trips run once for the
whole quality axis.  ``--no_rate_batch`` sweeps one (image, quality) at a
time instead (the same streams).  Images are PNG (the port reads no JPEG).

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.rd_sweep config/crdr.yaml \\
        --model_path ckpt.pth.tar --img_dir kodak --save_dir sweep_out \\
        --qualities 0 0.25 ... --betas 0 3.84
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
from glob import glob
from typing import Dict, List, Sequence

import numpy as np

from ..models import build_comp_model
from ..utils.codec_utils import pack_byte_strings
from ..utils.config import Config
from ..utils.img_utils import calc_ms_ssim, calc_psnr, imread

COLUMNS = ("quality", "beta", "bpp", "psnr", "ms_ssim")
logger = logging.getLogger("crdr_tpu_torch.cli.rd_sweep")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="RD-curve sweep")
    p.add_argument("config_path", type=str)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--img_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--qualities", type=float, nargs="+",
                   default=[q * 0.25 for q in range(17)])
    p.add_argument("--betas", type=float, nargs="+", default=[0.0, 3.84])
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--no_rate_batch", action="store_true",
                   help="disable the mixed-rate batched sweep (one "
                        "(image, quality) pair per dispatch set instead)")
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu on request)")
    p.add_argument("--wire", type=str, default=None,
                   choices=["compressai", "device"],
                   help="bitstream wire format (default: the config's)")
    return p.parse_args(argv)


def list_images(img_dir: str, max_images: int = 0) -> List[str]:
    paths = sorted(sum((glob(os.path.join(img_dir, e))
                        for e in ("*.png", "*.jpg")), []))
    if max_images:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no images in {img_dir}")
    return paths


def sweep(model, img_paths: Sequence[str], qualities: Sequence[float],
          betas: Sequence[float], no_rate_batch: bool = False
          ) -> List[Dict[str, float]]:
    """The CSV rows: per (quality, beta), the mean bpp / PSNR / MS-SSIM
    over the images."""
    qs = [float(q) for q in qualities]
    acc = {(q, float(b)): {"psnr": [], "ms_ssim": [], "bpp": []}
           for q in qs for b in betas}
    dev = model.device
    for path in img_paths:
        real = imread(path)[None]
        if no_rate_batch:
            encs = [model.compress(real, rate_ind=q) for q in qs]
        else:
            encs = model.compress_batch(
                np.repeat(real, len(qs), axis=0),
                rate_ind=np.asarray(qs, np.float32))
        # the .bin container's size, as the JAX script measures it on disk
        bpps = [len(pack_byte_strings(e["string_list"])) * 8
                / (real.shape[1] * real.shape[2]) for e in encs]
        for beta in betas:
            if no_rate_batch:
                fakes = np.concatenate([
                    model.decompress(e["string_list"], beta=beta)[0]
                    for e in encs])
            else:
                fakes, _, _ = model.decompress_batch(
                    [e["string_list"] for e in encs], beta=beta)
            for qi, q in enumerate(qs):
                a = acc[(q, float(beta))]
                a["psnr"].append(calc_psnr(real, fakes[qi:qi + 1]))
                a["ms_ssim"].append(calc_ms_ssim(real, fakes[qi:qi + 1],
                                                 device=dev))
                a["bpp"].append(bpps[qi])
        logger.info(f"{os.path.basename(path)}: swept {len(qs)} qualities "
                    f"x {len(betas)} betas")
    rows = []
    for q in qs:
        for beta in betas:
            a = acc[(q, float(beta))]
            rows.append({"quality": q, "beta": beta,
                         "bpp": float(np.mean(a["bpp"])),
                         "psnr": float(np.mean(a["psnr"])),
                         "ms_ssim": float(np.mean(a["ms_ssim"]))})
            logger.info(f"q={q} beta={beta}: bpp={rows[-1]['bpp']:.4f} "
                        f"psnr={rows[-1]['psnr']:.3f}")
    return rows


def write_csv(path: str, rows: List[Dict[str, float]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    cfg = Config.from_file(args.config_path)
    cfg["is_train"] = False
    if args.wire:
        cfg["wire_format"] = args.wire
    model = build_comp_model(cfg, device=args.device)
    if args.model_path:
        model.load_learned_weight(args.model_path)
    else:
        logger.warning("random init (no --model_path)")
    model.codec_setup()
    rows = sweep(model, list_images(args.img_dir, args.max_images),
                 args.qualities, args.betas, args.no_rate_batch)
    os.makedirs(args.save_dir, exist_ok=True)
    out_csv = os.path.join(args.save_dir, "rd_curve.csv")
    write_csv(out_csv, rows)
    logger.info(f"wrote {out_csv}")
    return rows


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
