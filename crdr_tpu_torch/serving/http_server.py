"""Minimal HTTP front end for codec serving (standard library only).

Counterpart of ``crdr_tpu/serving/http_server.py``: the same routes, headers,
status codes and keep-alive handling.

- ``POST /compress?q=<rate_ind>``   body: PNG or JPEG bytes
      -> ``application/octet-stream``: the `.bin` container (the
      length-prefixed ``pack_byte_strings`` layout of the CLI's files).
      Response headers carry ``X-CRDR-BPP`` (real bpp) and ``X-CRDR-Wire``.
- ``POST /decompress?beta=<beta>``  body: `.bin` container
      -> ``image/png`` reconstruction.
- ``GET /healthz`` (or ``/stats``)  -> JSON: model, wire, devices, card and
      batcher stats (the batch-size histogram shows whether micro-batching
      is winning); with an AOT package, its hits and misses by program.

Where it departs from the JAX server: PNG is read and written by the port's
own zlib codec (``utils/img_utils.py``), whose bytes are not PIL's (the
pixels are); a JPEG body is decoded by the port's own decoder
(``utils/jpeg.py``), to PIL's pixels; bodies PIL reads that are neither
PNG, JPEG nor BMP get a 400; ``/healthz`` names the model's
``torch.device`` (or its serving mesh's devices) and the card.

Concurrent requests are coalesced into batched dispatches by
:class:`crdr_tpu_torch.serving.MicroBatcher`: the HTTP layer is a thin
``ThreadingHTTPServer`` (one thread per in-flight request, all blocking on
batcher futures; the single batcher worker owns the device).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import torch

from ..runtime.aot import aot_counts
from ..utils.codec_utils import pack_byte_strings, unpack_byte_strings
from ..utils.img_utils import decode_image, encode_png
from .batcher import MicroBatcher

__all__ = ["make_server", "CodecHTTPServer"]

def _image_body(data: bytes):
    """A request body -> uint8 [H, W, 3] RGB, as PIL's ``convert("RGB")``
    decodes it in the JAX server (a JPEG's EXIF orientation not applied).
    Raw uint8 is the codec's input with ``codec_uint8_io``: the conversion
    runs on the device."""
    return decode_image(data, "request body", file_path=False)


def _device_info(model) -> dict:
    """``devices`` (JAX's field: here the model's ``torch.device``, or the
    devices of its serving mesh) and, on a GPU, ``card``: the card's
    name."""
    dev = torch.device(getattr(model, "device", "cpu"))
    mesh = getattr(model, "_mesh", None) or [dev]
    info = {"devices": [str(d) for d in mesh]}
    if dev.type == "cuda":
        info["card"] = torch.cuda.get_device_name(dev)
    return info


class CodecHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the model + batcher context."""

    daemon_threads = True

    def __init__(self, addr, model, max_batch: int = 8,
                 max_wait_s: float = 0.01,
                 default_q: Optional[float] = None,
                 default_beta: Optional[float] = None):
        self.model = model
        self.batcher = MicroBatcher(model, max_batch=max_batch,
                                    max_wait_s=max_wait_s)
        self.default_q = default_q
        self.default_beta = default_beta
        super().__init__(addr, _Handler)

    def shutdown(self):  # drain device work before stopping the listener
        self.batcher.close()
        super().shutdown()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # no access log on stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str, extra=None):
        self._responded = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str):
        self._send(code, json.dumps({"error": msg}).encode(),
                   "application/json")

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def do_GET(self):
        srv: CodecHTTPServer = self.server  # type: ignore[assignment]
        path = urlparse(self.path).path
        if path in ("/healthz", "/stats"):
            info = {
                "status": "ok",
                "model": type(srv.model).__name__,
                "wire_format": getattr(srv.model, "wire_format",
                                       "compressai"),
                **_device_info(srv.model),
                "batcher": srv.batcher.stats(),
            }
            if srv.model._aot.package is not None:
                info["aot"] = aot_counts(srv.model)
            self._send(200, json.dumps(info).encode(), "application/json")
        else:
            self._err(404, f"no route {path}")

    def do_POST(self):
        srv: CodecHTTPServer = self.server  # type: ignore[assignment]
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        self._responded = False
        body = self._body()  # always drain: keep-alive framing must not
        # desync when the route / handler errors before consuming it

        def _param(name, default):
            if name in qs:
                return float(qs[name][0])
            return default

        try:
            if url.path == "/compress":
                img = _image_body(body)
                rate = _param("q", srv.default_q)
                enc = srv.batcher.compress(img, rate_ind=rate)
                blob = pack_byte_strings(enc["string_list"])
                bpp = len(blob) * 8 / (img.shape[0] * img.shape[1])
                self._send(200, blob, "application/octet-stream", {
                    "X-CRDR-BPP": f"{bpp:.6f}",
                    "X-CRDR-Wire": getattr(srv.model, "wire_format",
                                           "compressai"),
                })
            elif url.path == "/decompress":
                strings = unpack_byte_strings(body)
                beta = _param("beta", srv.default_beta)
                img = srv.batcher.decompress(strings, beta=beta)
                self._send(200, encode_png(img), "image/png")
            else:
                self._err(404, f"no route {url.path}")
        except Exception as e:  # codec errors become 400s; keep serving
            if self._responded:
                # a response was (partly) written: a second one would
                # corrupt the stream, so drop the connection instead
                self.close_connection = True
            else:
                self._err(400, f"{type(e).__name__}: {e}")


def make_server(model, host: str = "127.0.0.1", port: int = 8080,
                **kw) -> CodecHTTPServer:
    return CodecHTTPServer((host, port), model, **kw)
