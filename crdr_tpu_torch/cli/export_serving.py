"""Export an AOT serving package: the codec's device programs exported with
``torch.export``, per serving shape bucket (counterpart of
``scripts/export_serving.py``, same flags, plus ``-d/--device``).

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.export_serving config/crdr_throughput.yaml \\
        --model_path ckpt.pth.tar --out /path/pkg \\
        --shapes 8x512x768,1x512x768 --platforms cuda,cpu

A serving process then loads the package (``python -m
crdr_tpu_torch.cli.serve ... --aot_package /path/pkg``) and runs a matching
request's programs from it; shapes not in the package run live.  The
package holds no weights: it serves any checkpoint of the config
(``runtime/aot.py``).

Prints one JSON line summarizing the manifest.
"""

from __future__ import annotations

import argparse
import json
import logging

from ..runtime.aot import export_package, record_serving_roundtrip
from .serve import build_model
from .serve import parse_args as serve_args

logger = logging.getLogger("crdr_tpu_torch.cli.export_serving")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--out", required=True, help="package directory")
    ap.add_argument("--shapes", default="8x512x768,1x512x768",
                    help="comma list of BxHxW serving buckets to capture")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="export targets (comma list of cuda, cpu)")
    ap.add_argument("-q", "--quality", type=float, default=0.0)
    ap.add_argument("-b", "--beta", type=float, default=0.0)
    ap.add_argument("--wire", choices=["compressai", "device"], default=None)
    ap.add_argument("-d", "--device", type=str, default="cuda",
                    help="torch device the programs are recorded on "
                         "(default cuda; cpu on request)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, datefmt="%H:%M:%S",
                        format="%(asctime)s %(levelname)s: %(message)s")

    model = build_model(serve_args(
        [args.config, "-d", args.device]
        + (["--model_path", args.model_path] if args.model_path else [])
        + (["--wire", args.wire] if args.wire else [])))
    for spec in args.shapes.split(","):
        b, h, w = (int(v) for v in spec.lower().split("x"))
        logger.info(f"recording serving roundtrip {b}x{h}x{w}...")
        record_serving_roundtrip(model, b, h, w, rate_ind=args.quality,
                                 beta=args.beta)
    platforms = tuple(p.strip() for p in args.platforms.split(","))
    manifest = export_package(model, args.out, platforms=platforms,
                              logger=logger)
    res = {
        "package": args.out,
        "programs": len(manifest["entries"]),
        "skipped": len(manifest["skipped"]),
        "bytes": sum(e["bytes"] for e in manifest["entries"]),
        "platforms": manifest["platforms"],
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
