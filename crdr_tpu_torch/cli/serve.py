"""Codec serving daemon of the port: HTTP front end + micro-batching
scheduler (counterpart of ``scripts/serve.py``, same flags, plus
``-d/--device``).

Usage, from the root of a checkout (on the GPU unless ``-d cpu``):
    python -m crdr_tpu_torch.cli.serve config/crdr_throughput.yaml \\
        --model_path ckpt.pth.tar --port 8080 --max_batch 8 --max_wait_ms 10

Endpoints (``crdr_tpu_torch/serving/http_server.py``):
    POST /compress?q=1.0        PNG in  -> .bin container out
    POST /decompress?beta=2.56  .bin in -> PNG out
    GET  /healthz               model / device / batcher stats

Concurrent requests with the same image size coalesce into one batched
dispatch; each image keeps its own q / beta.  Every kernel library the
model's path launches is built before the server listens.  A JPEG body gets
a 400 (the port reads PNG only).

Several devices: the config's ``serving_devices`` / ``serving_partition``
(``models/codec.py``) serve each dispatch over a mesh, one model replica a
device: ``cuda:0 .. N-1`` (fewer cards raise before the model is built),
or the devices ``--mesh_devices`` lists (``cuda:0,cuda:0``: two replicas
on one card).

``--aot_package`` attaches an AOT serving package
(``cli/export_serving.py``, ``runtime/aot.py``) after ``codec_setup``: a
dispatch whose signature the package holds runs its exported program,
any other runs live.  On a serving mesh each replica's share dispatches
through it, keyed by its own shapes and device.  A package is no speed-up
in eager PyTorch: on an H100 (``chip_smoke.py`` phase 24) a fresh serve
process answered /decompress about 3x slower with one than without, cause
not established; the CLI warns when one is given.
"""

from __future__ import annotations

import argparse
import logging

from ..models import build_comp_model
from ..models.codec import serving_mesh
from ..runtime.aot import load_package
from ..runtime.cache import warm_kernel_cache
from ..utils.config import Config

logger = logging.getLogger("crdr_tpu_torch.cli.serve")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="model config yaml")
    ap.add_argument("--model_path", default=None, help="checkpoint to load")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max_batch", type=int, default=8,
                    help="micro-batch cap per device dispatch")
    ap.add_argument("--max_wait_ms", type=float, default=10.0,
                    help="coalesce window from the first queued request")
    ap.add_argument("-q", "--quality", type=float, default=None,
                    help="default rate_ind when the request omits ?q=")
    ap.add_argument("-b", "--beta", type=float, default=None,
                    help="default beta when the request omits ?beta=")
    ap.add_argument("--wire", choices=["compressai", "device"], default=None,
                    help="override the bitstream wire format")
    ap.add_argument("--aot_package", default=None,
                    help="AOT serving package (cli/export_serving.py): "
                         "matching requests run its exported programs")
    ap.add_argument("-d", "--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--mesh_devices", type=str, default=None,
                    help="the serving mesh's devices, comma-separated "
                         "(with the config's serving_devices > 1)")
    return ap.parse_args(argv)


def build_model(args: argparse.Namespace):
    """The served model: the config's model on ``args.device``, the
    checkpoint loaded (or the seeded init, with a warning), the codec set
    up, the wire overridden, every kernel library of its path built, and
    the AOT package attached when one is given."""
    cfg = Config.from_file(args.config)
    cfg["is_train"] = False
    mesh = args.mesh_devices.split(",") if args.mesh_devices else None
    serving_mesh(cfg, args.device, mesh)  # fails before the model is built
    model = build_comp_model(cfg, device=args.device)
    if args.model_path:
        model.load_learned_weight(args.model_path)
    else:
        logger.warning("no --model_path: serving the seeded random init "
                       "(demo only)")
    if args.wire:
        model.opt["wire_format"] = args.wire
    model.codec_setup(mesh)
    built = warm_kernel_cache(model)
    logger.info(f"kernel libraries ready: {sorted(built)}")
    if getattr(args, "aot_package", None):
        pkg = load_package(model, args.aot_package, logger=logger)
        logger.info(f"aot package: {len(pkg.manifest['entries'])} programs "
                    f"({args.aot_package})")
        logger.warning("aot package: no speed-up in eager PyTorch; on an "
                       "H100 /decompress from a package measured about 3x "
                       "slower than live (PERF.md)")
    return model


def main(argv=None) -> None:
    from ..serving.http_server import make_server

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, datefmt="%H:%M:%S",
                        format="%(asctime)s %(levelname)s: %(message)s")
    model = build_model(args)
    srv = make_server(model, host=args.host, port=args.port,
                      max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3,
                      default_q=args.quality, default_beta=args.beta)
    logger.info(
        f"serving on http://{args.host}:{srv.server_address[1]} "
        f"(wire={model.wire_format}, device={model.device}, "
        f"max_batch={args.max_batch}, window={args.max_wait_ms}ms)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        srv.batcher.close()
        srv.server_close()


if __name__ == "__main__":
    main()
