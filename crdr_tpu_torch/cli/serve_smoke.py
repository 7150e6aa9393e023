"""One-shot serving smoke and measurement (counterpart of
``scripts/serve_smoke.py``): starts the HTTP server in process, sends
concurrent mixed-quality requests from ``--clients`` threads, each for
``--rounds`` waves of compress then decompress, and prints ONE JSON line:
latencies by route, requests/s and the batch histogram.

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.serve_smoke config/crdr_throughput.yaml \\
        --synthetic --clients 8
    python -m crdr_tpu_torch.cli.serve_smoke config/crdr_throughput.yaml \\
        --model_path ckpt.pth.tar --img_dir images

``--synthetic`` serves seeded smooth images (the ones ``chip_smoke.py``
makes); ``--img_dir`` reads PNGs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request
from glob import glob

import numpy as np

from ..utils.img_utils import encode_png, read_png
from .serve import build_model
from .serve import parse_args as serve_args


def synthetic_images(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """``n`` smooth seeded uint8 [h, w, 3] RGB images (sums of sines)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / w
    imgs = []
    for _ in range(n):
        f = rng.uniform(1.0, 9.0, (3, 3))
        ph = rng.uniform(0, 2 * np.pi, 3)
        chans = [0.5 + 0.25 * np.sin(f[c, 0] * xx + ph[c])
                 * np.cos(f[c, 1] * yy) + 0.2 * np.sin(f[c, 2] * (xx + yy))
                 for c in range(3)]
        imgs.append(np.stack(chans, -1))
    return np.clip(np.round(np.stack(imgs) * 255), 0, 255).astype(np.uint8)


def _post(url: str, body: bytes) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--img_dir", default=None, help="a directory of PNGs")
    ap.add_argument("--synthetic", action="store_true",
                    help="serve seeded synthetic images instead")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 768),
                    metavar=("H", "W"), help="synthetic image size")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3,
                    help="request waves per client")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=25.0)
    ap.add_argument("-d", "--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    if args.synthetic == bool(args.img_dir):
        ap.error("give exactly one of --synthetic and --img_dir")

    from ..serving.http_server import make_server

    model = build_model(serve_args(
        [args.config, "-d", args.device]
        + (["--model_path", args.model_path] if args.model_path else [])))
    if args.synthetic:
        imgs = list(synthetic_images(3, *args.size, seed=0))
    else:
        paths = sorted(glob(os.path.join(args.img_dir, "*.png")))
        if not paths:
            raise FileNotFoundError(f"no PNGs in {args.img_dir}")
        imgs = [read_png(p) for p in paths]
    bodies = [encode_png(a) for a in imgs]

    srv = make_server(model, port=0, max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3, default_beta=0.0)
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    # warm-up round trip: library and cuDNN initialization
    _post(base + "/decompress", _post(base + "/compress?q=0.0", bodies[0]))

    lat_c, lat_d, errors = [], [], []
    lock = threading.Lock()

    def client(i):
        body = bodies[i % len(bodies)]
        q = float(i % 3)
        try:
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                blob = _post(base + f"/compress?q={q}", body)
                t1 = time.perf_counter()
                png = _post(base + "/decompress?beta=0.0", blob)
                t2 = time.perf_counter()
                if png[:4] != b"\x89PNG":
                    raise ValueError("response is not a PNG")
                with lock:
                    lat_c.append(t1 - t0)
                    lat_d.append(t2 - t1)
        except Exception as e:  # a failed request fails the smoke, not
            with lock:          # just its numbers
                errors.append(f"client {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    srv.shutdown()
    srv.server_close()
    if errors:
        print(json.dumps({"error": errors[:5], "failed_clients": len(errors)}))
        sys.exit(1)

    st = srv.batcher.stats()
    res = {
        "metric": "serving requests/s (mixed q, concurrent clients)",
        "value": (len(lat_c) + len(lat_d)) / wall,
        "unit": "req/s",
        "device": str(model.device),
        "clients": args.clients,
        "compress_p50_ms": float(np.median(lat_c)) * 1e3,
        "compress_p95_ms": float(np.percentile(lat_c, 95)) * 1e3,
        "decompress_p50_ms": float(np.median(lat_d)) * 1e3,
        "decompress_p95_ms": float(np.percentile(lat_d, 95)) * 1e3,
        "batch_hist": st["batch_hist"],
        "mean_batch": st["batched_requests"] / max(st["batches"], 1),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
