"""The codec: setup, device programs, compress / decompress (mixin for
BaseModel), for the Charm family and the generic (mean-scale hyperprior,
no context model) family.

Counterpart of ``crdr_tpu/models/codec_tables.py`` (``codec_setup``),
``codec_programs.py`` (``encode_head``, ``decode_begin``, ``quantize_slice``,
``replay_pack``, ``decode_final``, ``generic_params``, ``generic_pack``), the
Charm step of ``codec_devicewire.py`` and ``codec_hostwire.py``
(``compress*``, ``decompress*``, ``_compress_charm``, ``_decompress_charm``,
the generic branches).  Each program is a plain method here; tensors of the
entropy chain are NHWC.

Bitstream safety.  The encoder replays the decoder's chain.  Charm:
``decode_begin``, then per slice ``quantize_slice`` and the SAME
``uniform_decode_step`` function the decoder calls, then the last slice's
reconstruction.  Generic: the SAME ``generic_params`` (z dequantize,
hyper-decode, mean / scale, CDF rows) the decoder calls, then symbols around
its mean.  Encode and decode therefore agree when that chain computes the
same bits at both ends, which the codec path secures by:

* running every codec entry point under ``codec_numerics(tf32)``:
  deterministic cuDNN algorithms, no benchmark autotuning, and TF32 for
  convolutions and matmuls only as ``codec_precision`` says (``highest``:
  off, cuDNN allows it by default; ``default``: on, as JAX's default
  precision is TF32 on a GPU).  The setting is the model's, read at
  ``codec_setup``, and the same at encode and decode, on both wires (the
  device-wire chain calls the same ``charm_step``).  With the K1 kernel on,
  TF32 reaches the hyper-decoder only; with it off, every Charm conv too.
  The side-local analysis / synthesis transforms follow
  ``transform_precision`` (``codec_precision`` by default) instead: the
  decoder never re-runs the encoder's transform, so that cannot desync.
  The flags are process-wide; a module lock serializes the codec calls
  that set them, so concurrent calls cannot restore them under each other;
* running the hyper-decoder and the plain Charm convolutions one image at a
  time, so cuDNN picks the same algorithm for a batch as for one image (a
  stream encoded in a batch then decodes alone);
* the K1 kernel, bit-identical across calls and batch sizes by design (K3,
  the GDN kernel of the Balle18 transforms, is too, though it only runs in
  the side-local transforms).

The analysis transform is side-local, so it cannot desync the stream, but an
image's bytes should not depend on the batch it was encoded in (JAX holds
batch streams equal to batch-1 streams).  It runs at one fixed batch size,
``ANALYSIS_BATCH`` images per call with the last call padded with zero
images: every call has one shape, so cuDNN makes one algorithm choice, and
no convolution mixes images.

Wires: ``wire_format: compressai`` (host C++ rANS, decoded between the
slice steps; the generic family decodes each image's stream in one call)
and ``wire_format: device`` (lane rans32, decoded on the GPU by K2:
``models/codec_devicewire.py``), the latter for the Charm family and with
``device_wire_encoder: host`` only.  ``fused_decode_loop`` is accepted and
changes nothing: in JAX it merges the same per-slice programs into one
``lax.scan`` with byte-identical streams, and eager PyTorch runs one loop
either way.  ``codec_setup`` raises for what is not ported: the generic
device wire, the device-side lane encoder and the checkerboard family.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

import torch

from ..entropy import (EntropyBottleneckCodec, GaussianConditionalCodec,
                       build_indexes, gaussian_likelihood, get_scale_table)
from ..ops.charm_uniform import (kernel_stacks, pack_charm_weights,
                                 uniform_decode_step, uniform_reconstruct_last)
from ..utils.codec_utils import HeaderHandler, MultiRateHeaderHandler
from ..utils.img_utils import pad_image, uint8_to_tensor

Tensor = torch.Tensor

# Images per analysis call (see the module doc): a batch-4 encode runs one
# call, a batch-1 encode pads three zero images.
ANALYSIS_BATCH = 4


# The numerics flags are process-wide torch state: one codec call at a time
# holds them (re-entrant, since compress / decompress call the batch forms).
_numerics_lock = threading.RLock()


_F32_PRECISIONS = ("highest", "float32")
_TF32_PRECISIONS = ("default", "high", "tensorfloat32")


def precision_allows_tf32(precision: str) -> bool:
    """A JAX matmul-precision name of the config (``codec_precision``,
    ``transform_precision``) -> whether TF32 may run: ``highest`` /
    ``float32`` no; ``default`` / ``high`` / ``tensorfloat32`` yes (TF32 is
    what JAX's default precision runs on a GPU)."""
    if precision in _F32_PRECISIONS:
        return False
    if precision in _TF32_PRECISIONS:
        return True
    raise ValueError(f"precision {precision!r}: one of "
                     f"{_F32_PRECISIONS + _TF32_PRECISIONS}")


@contextlib.contextmanager
def codec_numerics(tf32: bool = False):
    """Numerics of the codec path: deterministic cuDNN algorithms, no
    autotuning, and TF32 for convolutions and matmuls only if ``tf32`` (the
    model's ``codec_precision``; f32 by default).  These are process-wide
    torch flags, restored on exit; the block holds a module lock, so codec
    calls from several threads run one after another and never see each
    other's flags.  Torch work outside the codec that runs in another thread
    meanwhile sees them too."""
    b = torch.backends
    with _numerics_lock:
        saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
                 b.cudnn.deterministic, b.cudnn.benchmark)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = bool(tf32)
        b.cudnn.deterministic = True
        b.cudnn.benchmark = False
        try:
            with torch.no_grad():
                yield
        finally:
            (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark) = saved


@contextlib.contextmanager
def _tf32(allowed: bool):
    """TF32 for convolutions and matmuls inside the block (restored on exit)."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


def device_uint8_to_tensor(x: Tensor) -> Tensor:
    """``uint8_to_tensor`` on the tensor's device, bit for bit.  The divisor
    is a device tensor: CUDA divides by a CPU scalar as a multiply by its
    f32 reciprocal, one ulp off x / 255 for about half of the 256 values,
    and a stream would then depend on whether its image came as uint8."""
    return (x.to(torch.float32) / torch.full((), 255.0, device=x.device)
            - 0.5) * 2.0


def _nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


class CodecMixin:
    # ---------------- setup ----------------------------------------------------

    def codec_setup(self) -> None:
        """Host CDF tables, device scale table, packed Charm weights (and
        their bf16 kernel copies) for the Charm family, bf16 transform
        copies.  Run again after loading weights."""
        if self.use_charm and \
                self.context_type != "Minnen20CharmContextModel":
            raise NotImplementedError(f"context model {self.context_type!r}: "
                                      "only the Charm (Minnen20) one is "
                                      "ported")
        self.wire_format = self.opt.get("wire_format", "compressai")
        if self.wire_format not in ("compressai", "device"):
            raise ValueError(f"wire_format {self.wire_format!r}: compressai "
                             "or device")
        if self.wire_format == "device" and not self.use_charm:
            raise NotImplementedError(
                "wire_format: device is ported for the Charm family only; "
                "the generic device wire (no context model) is not")
        self.device_wire_lanes = int(self.opt.get("device_wire_lanes", 128))
        self.device_wire_fixup_cap = int(
            self.opt.get("device_wire_fixup_cap", 256))
        # JAX's default places the device-wire lane encode on the device;
        # that encoder is not ported (its bytes equal the host coder's)
        lane_enc = self.opt.get("device_wire_encoder", "device")
        if lane_enc not in ("device", "host"):
            raise ValueError(f"device_wire_encoder {lane_enc!r}: device or "
                             "host")
        if self.wire_format == "device" and lane_enc != "host":
            raise NotImplementedError(
                f"device_wire_encoder {lane_enc!r} is not ported: "
                "wire_format: device runs with device_wire_encoder: host")
        # fused_decode_loop is accepted and read by nothing (module doc)
        self._chain_tf32 = self.chain_tf32
        self._transform_tf32 = precision_allows_tf32(self.transform_precision)
        net = self.net
        self.header_handler = (MultiRateHeaderHandler() if self.use_rate
                               else HeaderHandler())
        ez = {k: v.detach().cpu().numpy()
              for k, v in net.entropy_model_z.named_parameters()}
        self.codec_z = EntropyBottleneckCodec(ez, net.entropy_model_z.filters)
        self.codec_z.update()
        self.scale_bound = float(
            self.opt.subnet.entropy_model_y.get("scale_bound", 0.11))
        self.codec_y = GaussianConditionalCodec(scale_bound=self.scale_bound)
        self.codec_y.update_scale_table(get_scale_table())
        self._table = torch.as_tensor(self.codec_y.scale_table,
                                      dtype=torch.float32, device=self.device)
        # K2's device-resident tables (the dense int32 ones and the kernel-
        # ready buffer, built and uploaded once per setup)
        self._ytab = self._device_tables(self.codec_y)
        self._ztab = self._device_tables(self.codec_z)

        sub = net.subnet_opt
        enc, hyp = sub["encoder"], sub["hyperencoder"]
        self.yC = enc.get("out_ch", enc.get("bottleneck_y", 320))
        self.zC = hyp.get("bottleneck_z", hyp.get("out_ch", 192))
        self.y_stride, self.model_stride = 16, 64

        # K1 on/off: the config key is the only switch (as in JAX)
        self.fused_slice_kernel = self.opt.get("fused_slice_kernel") in (
            True, 1, "1")
        if self.use_charm:
            packed = pack_charm_weights(
                net.context_model.state_dict(), self.num_slices,
                self.slice_ch, sub["context_model"]["hyper_out_ch"] // 2,
                self.max_support_slices)
            self._packed = {k: torch.from_numpy(v).to(self.device)
                            for k, v in packed.items()}
            if self.fused_slice_kernel:
                self._packed.update(kernel_stacks(self._packed))

        tdt = self.transform_dtype
        if tdt is None:
            self._enc_t, self._henc_t, self._dec_t = (
                net.encoder, net.hyperencoder, net.decoder)
        else:
            self._enc_t, self._henc_t, self._dec_t = (
                copy.deepcopy(m).to(tdt) for m in
                (net.encoder, net.hyperencoder, net.decoder))

    def _cond_arg(self, value, n: int) -> Tensor:
        """rate_ind / beta: a [1] tensor when uniform, [n] when per image."""
        arr = np.asarray(value, np.float32).reshape(-1)
        if arr.size not in (1, n):
            raise ValueError(f"got {arr.size} values for a batch of {n}")
        return torch.from_numpy(arr).to(self.device)

    def _step_args(self):
        return (self._table, self.scale_bound, self.num_slices, self.slice_ch,
                self.max_support_slices, self.fused_slice_kernel)

    # ---------------- device programs (NHWC at the boundaries) -----------------

    def encode_head(self, x: Tensor, rate_ind) -> Tuple[Tensor, Tensor, Tensor]:
        """Analysis + hyper-analysis, z rounded around the medians, z bits.
        x: [N, H, W, 3] uint8 (codec_uint8_io) or f32; ``rate_ind`` None for
        a model without rates.  Returns (y NHWC f32, z symbols NHWC f32,
        predicted z bits [N])."""
        if x.dtype == torch.uint8:
            x = device_uint8_to_tensor(x)
            if self.convert_img_range:
                x = (x + 1.0) / 2.0
        x = _nchw(x)
        tdt = self.transform_dtype
        if tdt is not None:
            x = x.to(tdt)
            if rate_ind is not None:
                rate_ind = rate_ind.to(tdt)
        y, z = self._analysis(x, rate_ind)
        y, z = y.float(), z.float()
        med = self.net.entropy_model_z.medians()[None, :, None, None]
        z_sym = torch.round(z - med)
        z_lik = self.net.z_likelihood_eval(z)
        pred_z_bits = -torch.sum(torch.log2(torch.clamp(z_lik, min=1e-12)),
                                 dim=(1, 2, 3))
        return _nhwc(y), _nhwc(z_sym), pred_z_bits

    def _analysis(self, x: Tensor, rate_ind) -> Tuple[Tensor, Tensor]:
        """Analysis + hyper-analysis of NCHW ``x`` in calls of
        ``ANALYSIS_BATCH`` images, the last padded with zero images.
        ``rate_ind`` is None, [1] or one per image."""
        n, chunk = x.shape[0], ANALYSIS_BATCH
        pad = -n % chunk
        per_image = rate_ind is not None and rate_ind.numel() > 1
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            if per_image:
                rate_ind = torch.cat([rate_ind, rate_ind.new_zeros(pad)])
        ys, zs = [], []
        with _tf32(self._transform_tf32):
            for i in range(0, n + pad, chunk):
                ri = rate_ind[i:i + chunk] if per_image else rate_ind
                y, z = self.net.encode_latents(x[i:i + chunk], ri,
                                               self._enc_t, self._henc_t)
                ys.append(y)
                zs.append(z)
        return torch.cat(ys)[:n], torch.cat(zs)[:n]

    def _hyper_decode(self, z_sym: Tensor) -> Tuple[Tensor, Tensor]:
        """z dequantize + hyper-decode, one image at a time (module doc).
        Returns (the hyper-decoder's [first || second] halves, NHWC; z_hat
        NHWC)."""
        z_hat = z_sym + self.net.entropy_model_z.medians()
        # canonical strides: with a 1x1 z grid the NHWC -> NCHW view is
        # "contiguous" both ways, and strides that look channels-last would
        # send the convolutions to another algorithm (other bits) depending
        # on where z_sym came from (the encoder, host rANS or K2)
        zc = _nchw(z_hat).clone(memory_format=torch.contiguous_format)
        hyper = torch.cat([self.net.hyper_decode(zi) for zi in zc.split(1)])
        return tuple(_nhwc(t) for t in torch.chunk(hyper, 2, dim=1)), z_hat

    def generic_params(self, z_sym: Tensor):
        """The generic family's entropy parameters, the ONE function both the
        encoder's replay and the decoder call: z dequantize, hyper-decode,
        mean / scale split, CDF rows.  Returns (z_hat, mean, scale, indexes
        int32), NHWC."""
        (mean, scale), z_hat = self._hyper_decode(z_sym)
        return z_hat, mean, scale, build_indexes(scale, self._table,
                                                 self.scale_bound)

    def decode_begin(self, z_sym: Tensor):
        """z dequantize + hyper-decode + the slice-0 entropy params.
        Returns (hm, hs, support, mu0, sigma0, idx0, z_hat), NHWC."""
        (hm, hs), z_hat = self._hyper_decode(z_sym)
        n, h, w, _ = hm.shape
        support = torch.zeros((n, h, w, self.max_support_slices *
                               self.slice_ch), device=self.device)
        zeros = torch.zeros((n, h, w, self.slice_ch), device=self.device)
        _, support, mu, sigma, idx = uniform_decode_step(
            self._packed, 0, hm, hs, support, zeros, zeros, *self._step_args())
        return hm, hs, support, mu, sigma, idx, z_hat

    def quantize_slice(self, y: Tensor, i: int, mu: Tensor) -> Tensor:
        sc = self.slice_ch
        return torch.round(y[..., i * sc:(i + 1) * sc] - mu)

    def charm_step(self, i: int, hm: Tensor, hs: Tensor, support: Tensor,
                   sym: Tensor, mu: Tensor):
        """Reconstruct slice i-1, params for slice i: the one step both the
        encoder's replay and the decoder run."""
        return uniform_decode_step(self._packed, i, hm, hs, support, sym, mu,
                                   *self._step_args())

    def _reconstruct_last(self, hm, support, sym, mu) -> Tensor:
        return uniform_reconstruct_last(
            self._packed, hm, support, sym, mu, self.num_slices,
            self.fused_slice_kernel)

    def _charm_replay(self, y: Tensor, z_sym: Tensor):
        """Charm encode by replay of the decode chain (module doc): per
        slice the symbols around the replayed mu, then the last slice's
        reconstruction.  Returns (symbols, indexes, scales, y_hat, z_hat),
        NHWC."""
        hm, hs, support, mu, sigma, idx, z_hat = self.decode_begin(z_sym)
        syms, idxs, sigmas, y_slices = [], [], [], []
        for i in range(self.num_slices):
            sym = self.quantize_slice(y, i, mu)
            syms.append(sym)
            idxs.append(idx)
            sigmas.append(sigma)
            if i < self.num_slices - 1:
                y_prev, support, mu, sigma, idx = self.charm_step(
                    i + 1, hm, hs, support, sym, mu)
                y_slices.append(y_prev)
        y_last = self._reconstruct_last(hm, support, syms[-1], mu)
        return (torch.cat(syms, dim=-1), torch.cat(idxs, dim=-1),
                torch.cat(sigmas, dim=-1), torch.cat(y_slices + [y_last], -1),
                z_hat)

    def _generic_replay(self, y: Tensor, z_sym: Tensor):
        """Generic encode: the decoder's ``generic_params``, then the
        symbols around its mean.  Returns (symbols, indexes, scales, y_hat,
        z_hat), NHWC."""
        z_hat, mean, scale, indexes = self.generic_params(z_sym)
        symbols = torch.round(y - mean)
        return symbols, indexes, scale, symbols + mean, z_hat

    def decode_final(self, hm, support, sym, mu, y_slices, rate_ind, beta):
        """Last-slice reconstruction + synthesis.  Returns (image NHWC, see
        ``_synthesis``; y_hat NHWC)."""
        y_last = self._reconstruct_last(hm, support, sym, mu)
        y_hat = torch.cat(list(y_slices) + [y_last], dim=-1)
        return self._synthesis(y_hat, rate_ind, beta), y_hat

    def _synthesis(self, y_hat: Tensor, rate_ind, beta) -> Tensor:
        """Synthesis of NHWC ``y_hat`` (``rate_ind`` / ``beta`` None where
        the model has none).  Returns the image NHWC: f32 in [-1, 1], or
        uint8 with codec_uint8_io."""
        yc = _nchw(y_hat)
        tdt = self.transform_dtype
        if tdt is not None:
            yc = yc.to(tdt)
            rate_ind, beta = (None if t is None else t.to(tdt)
                              for t in (rate_ind, beta))
        with _tf32(self._transform_tf32):
            img = self.net.decode(yc, rate_ind, beta, self._dec_t).float()
        lo = 0.0 if self.convert_img_range else -1.0
        img = _nhwc(torch.clamp(img, lo, 1.0))
        if self.codec_uint8_io:
            if self.convert_img_range:
                img = img * 2.0 - 1.0
            img = torch.clamp(torch.round((img + 1.0) * 127.5), 0, 255) \
                .to(torch.uint8)
        return img

    # ---------------- compress ---------------------------------------------------

    def compress(self, real_images, rate_ind=None) -> Dict:
        real_images = np.asarray(real_images)
        if real_images.ndim == 3:
            real_images = real_images[None]
        if real_images.shape[0] != 1:
            raise ValueError("compress expects batch size 1 (use "
                             "compress_batch)")
        return self.compress_batch(real_images, rate_ind)[0]

    def compress_batch(self, real_images, rate_ind=None) -> List[Dict]:
        """Batched encode: one device pass for N same-size images, per-image
        host rANS.  Returns one dict per image with ``string_list = [header,
        z_str, y_str]``."""
        if self.codec_z is None:
            raise RuntimeError("call codec_setup() first")
        if self.use_rate and rate_ind is None:
            raise ValueError("this model needs a rate_ind")
        real_images = np.asarray(real_images)
        N, H, W, _ = real_images.shape
        if self.codec_uint8_io and real_images.dtype == np.uint8:
            x = pad_image(real_images, self.stride)  # converted on device
        else:
            if real_images.dtype == np.uint8:
                real_images = uint8_to_tensor(real_images)
            x = self.data_preprocess(real_images)
        with codec_numerics(self._chain_tf32):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self._compress(x, N, H, W, rate_ind)

    def _compress(self, x: Tensor, N: int, H: int, W: int, rate_ind):
        """Encode by replay of the decoder's entropy chain (module doc),
        then one fetch of symbols and CDF rows and host rANS per image."""
        from ..runtime import rans_encode_with_indexes

        timing = {}
        t0 = time.perf_counter()
        ri = self._cond_arg(rate_ind, N) if self.use_rate else None
        y, z_sym, pred_z_bits = self.encode_head(x, ri)
        replay = self._charm_replay if self.use_charm else self._generic_replay
        symbols, indexes, scales, y_hat, z_hat = replay(y, z_sym)
        lik = gaussian_likelihood(symbols, scales, self.scale_bound)
        pred_y_bits = -torch.sum(torch.log2(lik), dim=(1, 2, 3))
        maxabs = torch.amax(torch.abs(y_hat), dim=(1, 2, 3))
        _, h, w, _ = symbols.shape
        if self.wire_format == "device":  # the Charm family (codec_setup)
            # slice-major: for each slice the NHWC slice [h, w, sc] flattened
            # (the decode's consumption order, one lane round per slice)
            ns, sc = self.num_slices, self.slice_ch
            rounds = np.arange(ns + 1, dtype=np.int64) * h * w * sc

            def order(t):
                return t.reshape(N, h, w, ns, sc).permute(0, 3, 1, 2, 4) \
                    .reshape(N, -1)
        else:
            # channel-major rANS serialization (stream-layout parity)
            def order(t):
                return t.permute(0, 3, 1, 2).reshape(N, -1)
        sym_np = order(symbols).to(torch.int32).cpu().numpy()
        idx_np = order(indexes).cpu().numpy()
        z_np = z_sym.to(torch.int32).cpu().numpy()
        meta = torch.stack([pred_y_bits, pred_z_bits, maxabs], 1).cpu().numpy()
        timing["device_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_str = self._z_serialize(z_np)
        cy = self.codec_y
        if self.wire_format == "device":
            y_str = self._lane_serialize(sym_np, idx_np, rounds)
        else:
            y_str = self._host_pmap(lambda i: rans_encode_with_indexes(
                sym_np[i], idx_np[i], cy.quantized_cdf, cy.cdf_length,
                cy.offset), N)
        timing["host_rans_s"] = time.perf_counter() - t0

        y_hat_np = y_hat.cpu().numpy()
        z_hat_np = z_hat.cpu().numpy()
        if self.use_rate:
            rates = np.broadcast_to(
                np.asarray(rate_ind, np.float32).reshape(-1), (N,))
        num_pixel = H * W
        results = []
        for i in range(N):
            if self.use_rate:
                header = self.header_handler.encode(
                    (H, W), meta[i, 2:3], rate_ind=float(rates[i]))
            else:
                header = self.header_handler.encode((H, W), meta[i, 2:3])
            results.append({
                "string_list": [header, z_str[i], y_str[i]],
                "z_hat": z_hat_np[i:i + 1],
                "y_hat": y_hat_np[i:i + 1],
                "pred_y_bit": float(meta[i, 0]),
                "pred_y_bpp": float(meta[i, 0]) / num_pixel,
                "pred_z_bit": float(meta[i, 1]),
                "pred_z_bpp": float(meta[i, 1]) / num_pixel,
                "timing": timing,
            })
        return results

    # ---------------- decompress -------------------------------------------------

    def decompress(self, string_list: List[bytes], beta: float = 0.0):
        """Returns (fake [1, H, W, 3] f32 in [-1, 1], z_hat, y_hat), NHWC."""
        if len(string_list) != 3:
            raise ValueError("string list must be [header, z, y], got "
                             f"{len(string_list)} strings")
        return self.decompress_batch([string_list], beta)

    def decompress_batch(self, string_lists: List[List[bytes]], beta=0.0):
        """Batched decode: N same-size bitstreams through one set of device
        steps; per-image host rANS.  ``beta`` is a scalar or one per image.
        Returns (fake [N, H, W, 3], z_hat, y_hat)."""
        if self.codec_z is None:
            raise RuntimeError("call codec_setup() first")
        for sl in string_lists:
            self._guard_wire_mismatch(sl[2])
        heads = [self.header_handler.decode(sl[0]) for sl in string_lists]
        H, W = heads[0]["img_size"]
        if any(tuple(hd["img_size"]) != (H, W) for hd in heads[1:]):
            raise ValueError("decompress_batch requires equal image sizes")
        n = len(string_lists)
        padH = math.ceil(H / self.stride) * self.stride
        padW = math.ceil(W / self.stride) * self.stride
        zH, zW = padH // self.model_stride, padW // self.model_stride
        if not self.use_charm:
            decode = self._decompress_generic
        elif self.wire_format == "device":
            decode = self._decompress_charm_device
        else:
            decode = self._decompress_charm
        timing: Dict[str, float] = {}
        with codec_numerics(self._chain_tf32):
            ri = bt = None
            if self.use_rate:
                rates = np.asarray([hd["rate_ind"] for hd in heads],
                                   np.float32)
                ri = self._cond_arg(
                    rates[:1] if np.all(rates == rates[0]) else rates, n)
            if self.use_beta:
                bt = self._cond_arg(beta, n)
            fake, z_hat, y_hat = decode(
                [sl[1] for sl in string_lists], [sl[2] for sl in string_lists],
                zH, zW, ri, bt, timing)
            t0 = time.perf_counter()
            fake = fake.cpu().numpy()  # waits for the device's last steps
            timing["fetch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if fake.dtype == np.uint8:  # codec_uint8_io: the device sent uint8
            fake = uint8_to_tensor(fake)
            if self.convert_img_range:
                fake = (fake + 1.0) / 2.0
        fake = self.data_postprocess(fake, (H, W))
        timing["postprocess_s"] = time.perf_counter() - t0
        self.last_decode_timing = timing
        return fake, z_hat.cpu().numpy(), y_hat.cpu().numpy()

    def _decompress_charm(self, z_strs, y_strs, zH: int, zW: int, ri: Tensor,
                          bt: Tensor, timing: Dict[str, float]):
        """Serial Charm decode, batched over N streams: ``decode_begin``, then
        S-1 steps interleaved with the host rANS stream decode (one rANS state
        per image), then ``decode_final``.  Returns (image NHWC, z_hat,
        y_hat) on the device."""
        from ..runtime import RansStreamDecoder

        t0 = time.perf_counter()
        z_sym = self.codec_z.decompress(z_strs, (zH, zW))
        hm, hs, support, mu, _sigma, idx, z_hat = self.decode_begin(
            torch.from_numpy(z_sym).to(self.device))
        timing["decode_begin_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n, h, w, sc = mu.shape
        cy = self.codec_y
        decoders = [RansStreamDecoder(ys) for ys in y_strs]
        y_slices: List[Tensor] = []
        try:
            for i in range(self.num_slices):
                idx_np = idx.cpu().numpy()  # [n, h, w, sc]
                dec = np.stack(self._host_pmap(lambda j: decoders[j].decode(
                    idx_np[j].transpose(2, 0, 1).reshape(-1),
                    cy.quantized_cdf, cy.cdf_length, cy.offset), n))
                sym = torch.from_numpy(
                    dec.reshape(n, sc, h, w).transpose(0, 2, 3, 1)
                    .astype(np.float32)).to(self.device)
                if i < self.num_slices - 1:
                    y_prev, support, mu, _sigma, idx = self.charm_step(
                        i + 1, hm, hs, support, sym, mu)
                    y_slices.append(y_prev)
            timing["charm_loop_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            fake, y_hat = self.decode_final(hm, support, sym, mu, y_slices,
                                            ri, bt)
            timing["decode_final_s"] = time.perf_counter() - t0
        finally:
            for d in decoders:
                d.close()
        return fake, z_hat, y_hat

    def _decompress_generic(self, z_strs, y_strs, zH: int, zW: int, ri, bt,
                            timing: Dict[str, float]):
        """Generic decode, batched over N streams: ``generic_params`` (the
        function the encoder replayed), the host rANS of each image's
        channel-major stream (threads), then ``+ mean`` and one synthesis
        call.  Returns (image NHWC, z_hat, y_hat) on the device."""
        from ..runtime import rans_decode_with_indexes

        t0 = time.perf_counter()
        z_sym = self.codec_z.decompress(z_strs, (zH, zW))
        z_hat, mean, _scale, idx = self.generic_params(
            torch.from_numpy(z_sym).to(self.device))
        n, h, w, c = idx.shape
        idx_np = idx.permute(0, 3, 1, 2).reshape(n, -1).cpu().numpy()
        timing["z_hyper_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cy = self.codec_y
        dec = np.stack(self._host_pmap(lambda j: rans_decode_with_indexes(
            y_strs[j], idx_np[j], cy.quantized_cdf, cy.cdf_length, cy.offset),
            n))
        sym = torch.from_numpy(dec.reshape(n, c, h, w).astype(np.float32))
        y_hat = _nhwc(sym.to(self.device)) + mean
        timing["y_entropy_decode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fake = self._synthesis(y_hat, ri, bt)
        timing["synthesis_s"] = time.perf_counter() - t0  # enqueue only
        return fake, z_hat, y_hat

    @staticmethod
    def _host_pmap(fn, n: int) -> List:
        """Map ``fn`` over ``range(n)``, in threads when it helps: the C++
        coders release the GIL."""
        if n > 1 and (os.cpu_count() or 1) > 1:
            with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as ex:
                return list(ex.map(fn, range(n)))
        return [fn(i) for i in range(n)]
