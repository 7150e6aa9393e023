"""Codec CLI of the port (counterpart of ``scripts/compress.py``, same flags
and outputs).

Per image: ``compress_batch`` -> a length-prefixed ``.bin`` -> its real size
-> optionally reload + ``decompress_batch`` -> a ``.png``.  Writes
``_bitrates.csv`` (per-image header / z / y bits, real vs predicted bpp,
times; the JAX CLI's columns in its order) and ``_avg_bitrate.json``
(``{"avg_bpp": mean}``).  Consecutive images of one size form a batch of up
to ``--batch``; the encode of batch k+1 runs in a worker thread while batch
k decodes, and the streams equal those of batch 1.  Images are the files
named ``*.png``, ``*.jpg`` or ``*.jpeg`` (the JAX CLI's globs), each read
by its content as ``cv2.imread`` reads it: PNG, JPEG, BMP, WebP, GIF, PNM
or TIFF (``utils/img_utils.py::read_image``).

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.compress config/crdr.yaml \\
        --model_path ckpt.pth.tar --img_dir images --save_dir out \\
        -q 0.0 -b 3.84 --decompress
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, List

import numpy as np

from ..models import build_comp_model
from ..models.codec import serving_mesh
from ..utils.codec_utils import load_byte_strings, save_byte_strings
from ..utils.config import Config
from ..utils.img_utils import imread, imwrite

COLUMNS = ("name", "header_bit", "z_bit", "y_bit", "real_bit", "real_bpp",
           "pred_y_bpp", "pred_z_bpp", "pred_bpp", "enc_time", "dec_time")
logger = logging.getLogger("crdr_tpu_torch.cli.compress")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="compress/decompress images")
    p.add_argument("config_path", type=str, nargs="?", default=None)
    p.add_argument("--config_path", dest="config_path_flag", type=str,
                   default=None, help="alias of the positional config path")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint (torch.save: .pth / .pth.tar / .pt "
                        "reference, or the port's .ckpt)")
    p.add_argument("--img_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("-q", "--quality", type=float, default=-1.0,
                   help="rate index in [0, rate_level-1]; <0 disables")
    p.add_argument("-b", "--beta", type=float, default=-1.0,
                   help="realism weight; <0 disables")
    p.add_argument("--decompress", action="store_true")
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu on request)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the random init used without --model_path "
                        "(default: the config's seed, else 0)")
    p.add_argument("--shape_bucket", type=int, default=None,
                   help="pad images to multiples of this (>=64, multiple of "
                        "64)")
    p.add_argument("--batch", type=int, default=1,
                   help="serving batch size: groups consecutive same-size "
                        "images through compress_batch / decompress_batch "
                        "(streams identical to batch 1)")
    p.add_argument("--wire", type=str, default=None,
                   choices=["compressai", "device"],
                   help="bitstream wire format: compressai (reference-"
                        "compatible, default) or device (lane-interleaved, "
                        "entropy-coded on the GPU; the config's "
                        "device_wire_encoder, device by default, says where "
                        "it is encoded)")
    p.add_argument("--serving_devices", type=int, default=None,
                   help="shard each serving batch over this many devices "
                        "(cuda:0 .. N-1, or the CPU N times with -d cpu; "
                        "one model replica a device)")
    args = p.parse_args(argv)
    args.config_path = args.config_path or args.config_path_flag
    if not args.config_path:
        p.error("a config path is required (positional or --config_path)")
    return args


def _build_model(args: argparse.Namespace):
    cfg = Config.from_file(args.config_path)
    cfg["is_train"] = False
    if args.serving_devices:
        cfg["serving_devices"] = args.serving_devices
    serving_mesh(cfg, args.device)  # fails before the model is built
    if args.shape_bucket:
        cfg["shape_bucket"] = args.shape_bucket
    if args.wire:
        cfg["wire_format"] = args.wire
    if args.seed is not None:
        cfg["seed"] = args.seed
    model = build_comp_model(cfg, device=args.device)
    if args.model_path:
        model.load_learned_weight(args.model_path)
    else:
        logger.warning("no --model_path given: using random initialization")
    model.codec_setup()
    return model


def _chunks(img_paths: List[str], batch: int):
    """Consecutive same-size images, at most ``batch`` a chunk."""
    cur, cur_hw = [], None
    for path in img_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        img = imread(path)
        if cur and (img.shape[:2] != cur_hw or len(cur) >= max(batch, 1)):
            yield cur
            cur = []
        cur_hw = img.shape[:2]
        cur.append((name, img))
    if cur:
        yield cur


def main(argv=None) -> float:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, datefmt="%H:%M:%S",
                        format="%(asctime)s %(levelname)s: %(message)s")
    model = _build_model(args)
    os.makedirs(args.save_dir, exist_ok=True)
    img_paths = sorted(sum((glob(os.path.join(args.img_dir, e))
                            for e in ("*.png", "*.jpg", "*.jpeg")), []))
    if not img_paths:
        raise FileNotFoundError(f"no images in {args.img_dir}")

    def encode_chunk(chunk):
        """Encode stage: compress_batch -> .bin files + rows."""
        names = [n for n, _ in chunk]
        imgs = np.stack([im for _, im in chunk])
        H, W = imgs.shape[1:3]
        kwargs = {}
        if model.use_rate:
            kwargs["rate_ind"] = args.quality if args.quality >= 0 else 0.0
        t0 = time.perf_counter()
        encs = model.compress_batch(imgs, **kwargs)
        enc_time = (time.perf_counter() - t0) / len(chunk)
        rows = []
        for name, enc in zip(names, encs):
            bin_path = os.path.join(args.save_dir, f"{name}.bin")
            save_byte_strings(bin_path, enc["string_list"])
            real_bits = os.path.getsize(bin_path) * 8
            rows.append({
                "name": name,
                "header_bit": len(enc["string_list"][0]) * 8,
                "z_bit": len(enc["string_list"][1]) * 8,
                "y_bit": len(enc["string_list"][2]) * 8,
                "real_bit": real_bits,
                "real_bpp": real_bits / (H * W),
                "pred_y_bpp": enc["pred_y_bpp"],
                "pred_z_bpp": enc["pred_z_bpp"],
                "pred_bpp": enc["pred_y_bpp"] + enc["pred_z_bpp"],
                "enc_time": enc_time,
            })
        return names, rows

    def decode_chunk(names, rows):
        """Decode stage (main thread): reload .bin -> decompress_batch ->
        PNG."""
        strings = [load_byte_strings(os.path.join(args.save_dir, f"{n}.bin"))
                   for n in names]
        kwargs = {}
        if model.use_beta:
            kwargs["beta"] = args.beta if args.beta >= 0 else 0.0
        t0 = time.perf_counter()
        fakes, _, _ = model.decompress_batch(strings, **kwargs)
        dec_time = (time.perf_counter() - t0) / len(names)
        for j, (name, row) in enumerate(zip(names, rows)):
            row["dec_time"] = dec_time
            imwrite(os.path.join(args.save_dir, f"{name}.png"),
                    fakes[j:j + 1])

    all_rows: List[Dict] = []

    def finish(fut):
        names, rows = fut.result()
        if args.decompress:
            decode_chunk(names, rows)
        for row in rows:
            all_rows.append(row)
            logger.info(
                f"{row['name']}: bpp {row['real_bpp']:.4f} (pred "
                f"{row['pred_bpp']:.4f}) enc {row['enc_time']:.2f}s"
                + (f" dec {row['dec_time']:.2f}s" if args.decompress else ""))

    # the encode of chunk k+1 (worker thread) overlaps the decode of chunk k
    # (main thread); codec_numerics' lock runs their codec calls one at a
    # time, so the streams equal the sequential order's
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = None
        for chunk in _chunks(img_paths, args.batch):
            fut = ex.submit(encode_chunk, chunk)
            if pending is not None:
                finish(pending)
            pending = fut
        if pending is not None:
            finish(pending)

    columns = COLUMNS if args.decompress else COLUMNS[:-1]
    with open(os.path.join(args.save_dir, "_bitrates.csv"), "w",
              newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(all_rows)
    avg = float(np.mean([row["real_bpp"] for row in all_rows]))
    with open(os.path.join(args.save_dir, "_avg_bitrate.json"), "w") as f:
        json.dump({"avg_bpp": avg}, f)
    logger.info(f"avg_bpp: {avg:.4f}")
    return avg


if __name__ == "__main__":
    main()
