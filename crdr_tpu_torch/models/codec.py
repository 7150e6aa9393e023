"""The codec: setup, device programs, compress / decompress (mixin for
BaseModel), for the Charm family, the checkerboard family and the generic
(mean-scale hyperprior, no context model) family.

Counterpart of ``crdr_tpu/models/codec_tables.py`` (``codec_setup``),
``codec_programs.py`` (``encode_head``, ``decode_begin``, ``quantize_slice``,
``replay_pack``, ``decode_final``, ``generic_params``, ``generic_pack``,
``generic_final``, and the checkerboard's ``cb_begin``, ``cb_a_dev``,
``cb_b_dev``, ``cb_quant``, ``cb_final``, ``cb_replay_pack``), the Charm
step of ``codec_devicewire.py`` and ``codec_hostwire.py`` (``compress*``,
``decompress*``, ``_compress_charm``, ``_decompress_charm``, the generic
and checkerboard branches).  Each program is a plain method here; tensors
of the entropy chain are NHWC.

Bitstream safety.  The encoder replays the decoder's chain.  Charm:
``decode_begin``, then per slice ``quantize_slice`` and the SAME
``uniform_decode_step`` function the decoder calls, then the last slice's
reconstruction.  Checkerboard (``models/codec_devicewire.py::
_encode_cb_replay``): ``cb_begin``, then per slice the decoder's
``cb_a_dev`` -> ``cb_quant`` (anchors) -> ``cb_b_dev`` -> ``cb_quant``
(non-anchors), then ``cb_replay_pack``.  Generic: the SAME
``generic_params`` (z dequantize, hyper-decode, mean / scale, CDF rows) the
decoder calls, then symbols around its mean.  Encode and decode therefore
agree when that chain computes the same bits at both ends, which the codec
path secures by:

* running every codec entry point under ``codec_numerics(tf32)``:
  deterministic cuDNN algorithms, no benchmark autotuning, and TF32 for
  convolutions and matmuls only as ``codec_precision`` says (``highest``:
  off, cuDNN allows it by default; ``default``: on, as JAX's default
  precision is TF32 on a GPU).  The setting is the model's, read at
  ``codec_setup``, and the same at encode and decode, on both wires (the
  device-wire chains call the same steps).  With the K1 kernel on, TF32
  reaches the hyper-decoder (and the checkerboard's spatial convs) only;
  with it off, every Charm conv too.  The side-local analysis / synthesis
  transforms follow ``transform_precision`` (``codec_precision`` by
  default) instead: the decoder never re-runs the encoder's transform, so
  that cannot desync.  The flags are process-wide; a module lock
  serializes the codec calls that set them, so concurrent calls cannot
  restore them under each other;
* running the hyper-decoder, the plain Charm convolutions and the
  checkerboard's spatial convs one image at a time, so cuDNN picks the same
  algorithm for a batch as for one image (a stream encoded in a batch then
  decodes alone);
* the K1 kernel, bit-identical across calls and batch sizes by design (K3,
  the GDN kernel of the Balle18 transforms, is too, though it only runs in
  the side-local transforms).

The analysis and synthesis transforms are side-local, so they cannot desync
the stream, but an image's bytes should not depend on the batch it was
encoded in (JAX holds batch streams equal to batch-1 streams), nor a decoded
image on the batch it was decoded in or on its neighbours' beta (a serving
batch mixes requests).  Both run at one fixed batch size,
``TRANSFORM_BATCH`` images per call with the last call padded with zero
images, and the synthesis takes ``rate_ind`` / ``beta`` as one row per
image: every call has one shape, so cuDNN and cuBLAS make one algorithm
choice, and no convolution or matmul mixes images.

Device programs.  Each program above is a method decorated
``@program(name)`` (``runtime/aot.py``), named after JAX's: a plain call,
unless an AOT recorder or package is attached (``record_serving_roundtrip``,
``load_package``).  The TF32 flags are read when a convolution runs, not
traced into an exported graph, so a program runs inside one precision
section: the transforms are programs of their own (``encode_latents``,
``decode_image``, one fixed-batch call each), and JAX's ``encode_head`` /
``decode_final`` / ``cb_final`` are the chain's part here.

Wires: ``wire_format: compressai`` (host C++ rANS, decoded between the
slice steps, or, for the generic family, each image's stream in one call)
and ``wire_format: device`` (lane rans32, decoded on the GPU by K2 with no
host sync: ``models/codec_devicewire.py``), for every family.  The device
wire is encoded on the GPU by E1 (``device_wire_encoder: device``, the
default, as in JAX) or by the host C++ lane coder (``host``); the bytes are
the same.  ``fused_decode_loop`` is accepted and changes nothing: in JAX it
merges the same per-slice programs into one ``lax.scan`` with
byte-identical streams, and eager PyTorch runs one loop either way.

Several devices (``serving_devices: N``, or ``CRDR_SERVING_DEVICES``, over
the mesh of ``parallel/mesh.py``): ``codec_setup`` builds one replica of
the model per device, each with its own tables and packed (K1) weights,
the first being the model itself.  JAX partitions each program over the
mesh; here each replica runs its share from its own worker thread:

* ``serving_partition: batch``: ``compress_batch`` / ``decompress_batch``
  split the batch into N equal blocks, one per replica, and join the
  results in order.  A batch that does not divide runs whole on the first
  device, as in JAX.  Each block goes through the same fixed-batch
  transforms and per-image chain as one device would run, so the streams
  are byte-identical to one device's;
* ``serving_partition: spatial``: one image's height over the mesh, for
  the side-local transforms only (``parallel/spatial.py``'s overlap tiles:
  the analysis, and the synthesis, which hold the full-resolution
  activations).  The hyper pair, the entropy chain (K1) and the entropy
  coding run whole on the first device, so encode and decode compute the
  entropy parameters from the same unsplit function of ``y_hat``: a stream
  of either setting decodes on the other.  Heights whose latent rows do
  not divide by N run whole.  A transform with a global operation
  (``InstanceNorm2D``, HiFiC with ``channel_norm: False``) raises.

The mesh is ``cuda:0 .. N-1`` on the card (fewer cards raise), N times the
CPU on the CPU, or the list ``codec_setup(mesh_devices=...)`` gives (two
replicas may share one card).  The replicas' worker threads run while the
caller holds ``codec_numerics``.  The TF32 flags are process-wide, and an
operation reads them when it is launched, so a worker launches only inside
a precision section (``_PrecisionSections``): one lock, the flags set to
the section's own precision, the chain's around the whole call and the
transforms' nested in it.  The sections let go of the lock for host work
(the rANS coders, the unpacking, the waits for the device), where another
replica launches meanwhile.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
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
from ..ops.cb_uniform import (cb_phase_a, cb_phase_b, cb_reconstruct_last,
                              pack_cb_weights)
from ..ops.charm_uniform import (kernel_stacks, pack_charm_weights,
                                 uniform_decode_step, uniform_reconstruct_last)
from ..parallel.mesh import make_mesh, shard_rows
from ..parallel.spatial import grid_margin, join_rows, split_rows, tile_plan
from ..runtime.aot import program
from ..subnet.context_model.checkerboard import anchor_mask
from ..utils.codec_utils import HeaderHandler, MultiRateHeaderHandler
from ..utils.img_utils import pad_image, uint8_to_tensor
from .codec_common import _checkerboard_serialize

Tensor = torch.Tensor

# Images per analysis / synthesis call (see the module doc): a batch-4
# encode or decode runs one call, a batch-1 one pads three zero images.
TRANSFORM_BATCH = 4


def _fixed_batches(fn, x: Tensor, *rows) -> Tuple[Tensor, ...]:
    """``fn(x_i, *rows_i)`` over ``x`` in calls of ``TRANSFORM_BATCH``
    images, the last padded with zeros; each of ``rows`` is None or one row
    per image, padded and split with ``x``.  ``fn`` returns a tuple of
    per-image tensors; each is joined over the calls and cut to the batch."""
    n, chunk = x.shape[0], TRANSFORM_BATCH
    pad = -n % chunk

    def padded(t):
        if t is None or not pad:
            return t
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    x, rows = padded(x), [padded(t) for t in rows]
    outs = [fn(x[i:i + chunk], *(None if t is None else t[i:i + chunk]
                                 for t in rows))
            for i in range(0, n + pad, chunk)]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


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


class _PrecisionSections:
    """The TF32 flags of codec work launched from several threads (module
    doc).  ``hold(tf32)``: inside the block this thread holds the one lock
    and the flags are ``tf32`` (a nested block sets its own and restores
    them on exit).  ``release()``: host work inside a held block; other
    threads may launch meanwhile, and on exit this thread takes the lock
    again and sets its block's flags back.  Outside any held block
    ``release`` does nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()

    def _blocks(self) -> List:
        """This thread's open blocks, innermost last: a hold's flags, or
        None for a release."""
        if not hasattr(self._local, "blocks"):
            self._local.blocks = []
        return self._local.blocks

    @staticmethod
    def _owns(blocks: List) -> bool:
        return bool(blocks) and blocks[-1] is not None

    @staticmethod
    def _set(tf32: bool) -> None:
        b = torch.backends
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32

    @contextlib.contextmanager
    def hold(self, tf32: bool):
        blocks = self._blocks()
        if not self._owns(blocks):
            self._lock.acquire()
        b = torch.backends
        saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        blocks.append(bool(tf32))
        self._set(blocks[-1])
        try:
            yield
        finally:
            blocks.pop()
            b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
            if not self._owns(blocks):
                self._lock.release()

    @contextlib.contextmanager
    def release(self):
        blocks = self._blocks()
        if not self._owns(blocks):
            yield
            return
        self._lock.release()
        blocks.append(None)
        try:
            yield
        finally:
            blocks.pop()
            self._lock.acquire()
            self._set(blocks[-1])


_SECTIONS = _PrecisionSections()
_tf32, _host = _SECTIONS.hold, _SECTIONS.release


def device_uint8_to_tensor(x: Tensor) -> Tensor:
    """``uint8_to_tensor`` on the tensor's device, bit for bit.  The divisor
    is a device tensor: CUDA divides by a CPU scalar as a multiply by its
    f32 reciprocal, one ulp off x / 255 for about half of the 256 values,
    and a stream would then depend on whether its image came as uint8."""
    return (x.to(torch.float32) / torch.full((), 255.0, device=x.device)
            - 0.5) * 2.0


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    def norm(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def _on_device(device: torch.device):
    """The current CUDA device inside the block (kernels launch on its
    stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def serving_mesh(opt, device, mesh_devices=None):
    """The serving mesh of the options (module doc): None for one device,
    else its devices, ``mesh_devices`` when given (the first must be
    ``device``), N GPUs on the card (fewer raise) or the CPU N times."""
    n = int(os.environ.get("CRDR_SERVING_DEVICES",
                           opt.get("serving_devices", 1)) or 1)
    partition = opt.get("serving_partition", "batch")
    if partition not in ("batch", "spatial"):
        raise ValueError(f"serving_partition {partition!r}: batch or "
                         "spatial")
    if n <= 1:
        return None
    device = torch.device(device)
    if mesh_devices is None and device.type == "cpu":
        mesh_devices = [device] * n
    try:
        mesh = make_mesh(n, mesh_devices)
    except RuntimeError as e:
        raise RuntimeError(f"serving_devices={n} (serving_partition: "
                           f"{partition}): {e}") from e
    if not _same_device(mesh[0], device):
        raise ValueError(f"the serving mesh {mesh} must start with the "
                         f"model's device {device}")
    return mesh


def _rows_of(value, rows: slice):
    """A rate_ind / beta argument for the images ``rows``: itself when it is
    None or one value, else its rows."""
    if value is None or np.size(value) == 1:
        return value
    return np.asarray(value).reshape(-1)[rows]


def _nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


class CodecMixin:
    # ---------------- setup ----------------------------------------------------

    def codec_setup(self, mesh_devices=None) -> None:
        """Host CDF tables, device scale table, packed Charm / checkerboard
        weights (and their bf16 kernel copies), bf16 transform copies.  Run
        again after loading weights.  With ``serving_devices`` (or
        ``CRDR_SERVING_DEVICES``) N > 1, the serving mesh (module doc): its
        devices are ``mesh_devices`` when given (N of them, the first the
        model's device; kept for the next setup), else N GPUs, or the CPU N
        times for a model on the CPU; one replica a device."""
        if mesh_devices is None:  # the list of an earlier setup, if any
            mesh_devices = getattr(self, "_mesh_devices", None)
        self._mesh_devices = mesh_devices
        mesh = serving_mesh(self.opt, self.device, mesh_devices)
        self._setup_tables()
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown()
        self._mesh, self._replicas, self._pool = mesh, [self], None
        self._spatial_margins = None
        if mesh is not None:
            self._replicas += [self._replica(d) for d in mesh[1:]]
            if self.opt.get("serving_partition", "batch") == "spatial":
                self._spatial_margins = self._transform_margins()
            # the replicas' worker threads, kept between calls (a thread's
            # first launches create its cuDNN and cuBLAS handles)
            self._pool = ThreadPoolExecutor(len(mesh),
                                            thread_name_prefix="crdr-mesh")

    def _replica(self, device: torch.device):
        """A copy of the model on ``device``, for a serving mesh: its own net
        and codec state, sharing the options."""
        rep = copy.copy(self)
        rep.device = device
        rep.net = copy.deepcopy(self.net).to(device)
        rep._setup_tables()
        rep._mesh, rep._replicas, rep._spatial_margins = None, [rep], None
        rep._pool = None
        return rep

    def _transform_margins(self) -> Tuple[int, int]:
        """The overlap margins, in latent rows, of the analysis and the
        synthesis (``parallel/spatial.py::grid_margin``, on CPU copies)."""
        net = self.net
        enc, dec = (copy.deepcopy(m).cpu().float()
                    for m in (net.encoder, net.decoder))
        one = torch.ones(1)
        ri = one if self.use_rate else None
        bt = one if self.use_beta else None
        with torch.no_grad():
            # 4 latent columns: reflect padding needs more than its width
            m_enc = grid_margin(enc, lambda x: net.encode(x, ri, enc),
                                self.y_stride, 1, 3, 4 * self.y_stride)
            m_dec = grid_margin(dec, lambda y: net.decode(y, ri, bt, dec),
                                1, self.y_stride, self.yC, 4)
        return m_enc, m_dec

    def _setup_tables(self) -> None:
        """The codec state of the model's own device (``codec_setup``)."""
        self.__dict__.pop("_aot_tensor_cache", None)  # runtime/aot.py
        self.wire_format = self.opt.get("wire_format", "compressai")
        if self.wire_format not in ("compressai", "device"):
            raise ValueError(f"wire_format {self.wire_format!r}: compressai "
                             "or device")
        self.device_wire_lanes = int(self.opt.get("device_wire_lanes", 128))
        self.device_wire_fixup_cap = int(
            self.opt.get("device_wire_fixup_cap", 256))
        # where the device wire is lane-encoded: E1 on the GPU (JAX's
        # default) or the host C++ coder; the bytes are the same
        self.device_wire_encoder = self.opt.get("device_wire_encoder",
                                                "device")
        if self.device_wire_encoder not in ("device", "host"):
            raise ValueError(f"device_wire_encoder "
                             f"{self.device_wire_encoder!r}: device or host")
        self._lane_enc_cache = {}
        self._cb_ids_cache = {}
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
            pack = pack_cb_weights if self._is_checkerboard \
                else pack_charm_weights
            packed = pack(
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
        return self._z_head(*self._analysis(x, rate_ind))

    @program("encode_head")
    def _z_head(self, y: Tensor, z: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """``encode_head`` after the transforms, at the chain's precision:
        z rounded around the medians, z bits, NHWC."""
        y, z = y.float(), z.float()
        med = self.net.entropy_model_z.medians()[None, :, None, None]
        z_sym = torch.round(z - med)
        z_lik = self.net.z_likelihood_eval(z)
        pred_z_bits = -torch.sum(torch.log2(torch.clamp(z_lik, min=1e-12)),
                                 dim=(1, 2, 3))
        return _nhwc(y), _nhwc(z_sym), pred_z_bits

    @program("encode_latents")
    def _encode_latents(self, x: Tensor, rate_ind) -> Tuple[Tensor, Tensor]:
        """Analysis + hyper-analysis of one fixed-batch call, at the
        transforms' precision."""
        return self.net.encode_latents(x, rate_ind, self._enc_t,
                                       self._henc_t)

    def _analysis(self, x: Tensor, rate_ind) -> Tuple[Tensor, Tensor]:
        """Analysis + hyper-analysis of NCHW ``x`` at the fixed batch
        (``_fixed_batches``).  ``rate_ind`` is None, [1] (passed to every
        call as it is) or one per image.  On a spatial mesh the analysis
        runs in overlap tiles, one a replica, and the hyper-analysis whole
        (module doc)."""
        plan = self._spatial_plan(x.shape[2] // self.y_stride, 0)
        if plan is None:
            per_image = rate_ind is not None and rate_ind.numel() > 1

            def call(xi, ri):
                return self._encode_latents(xi,
                                            rate_ind if ri is None else ri)

            with _tf32(self._transform_tf32):
                return _fixed_batches(call, x, rate_ind if per_image else None)
        y = self._spatial_map(x, plan, self.y_stride, 1, lambda rep, xt: (
            rep._encode_y(xt, None if rate_ind is None
                          else rate_ind.to(rep.device))))
        with _tf32(self._transform_tf32):
            z, = _fixed_batches(lambda yi: (self._henc_t(yi),), y)
        return y, z

    def _encode_y(self, x: Tensor, rate_ind) -> Tensor:
        """The analysis alone at the fixed batch (a spatial tile)."""
        per_image = rate_ind is not None and rate_ind.numel() > 1

        def call(xi, ri):
            return (self.net.encode(xi, rate_ind if ri is None else ri,
                                    self._enc_t),)

        with _tf32(self._transform_tf32):
            y, = _fixed_batches(call, x, rate_ind if per_image else None)
        return y

    # ---------------- the serving mesh ---------------------------------------

    def _batch_shards(self, n: int):
        """The row block of each replica for a batch of ``n`` on a batch
        mesh; None without one or when ``n`` does not divide."""
        if self._mesh is None or self._spatial_margins is not None:
            return None
        return shard_rows(n, self._mesh)

    def _spatial_plan(self, grid_rows: int, which: int):
        """The tiles of a spatial mesh for ``grid_rows`` latent rows
        (``which``: 0 the analysis, 1 the synthesis); None without one or
        when the rows do not divide."""
        if self._spatial_margins is None:
            return None
        return tile_plan(grid_rows, len(self._mesh),
                         self._spatial_margins[which])

    def _on_replicas(self, fn, items: List) -> List:
        """``fn(replica i, items[i])`` for each replica, from the mesh's
        worker threads, without gradients, on its own device, inside a
        precision section at the chain's precision (module doc); the
        results in order.  A failure on any replica raises here."""
        def run(i):
            rep = self._replicas[i]
            with torch.no_grad(), _on_device(rep.device), \
                    _tf32(rep._chain_tf32):
                return fn(rep, items[i])

        futures = [self._pool.submit(run, i) for i in range(len(items))]
        return [f.result() for f in futures]

    def _spatial_map(self, x: Tensor, plan, in_rows: int, out_rows: int,
                     fn) -> Tensor:
        """``fn(replica, tile)`` over the overlap tiles of NCHW ``x`` (each
        moved to its replica's device), the own rows joined on the model's
        device."""
        tiles = split_rows(x, plan, in_rows)
        outs = self._on_replicas(lambda rep, t: fn(rep, t.to(rep.device)),
                                 tiles)
        return join_rows(outs, plan, out_rows, self.device)

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

    @program("generic_params")
    def generic_params(self, z_sym: Tensor):
        """The generic family's entropy parameters, the ONE function both the
        encoder's replay and the decoder call: z dequantize, hyper-decode,
        mean / scale split, CDF rows.  Returns (z_hat, mean, scale, indexes
        int32), NHWC."""
        (mean, scale), z_hat = self._hyper_decode(z_sym)
        return z_hat, mean, scale, build_indexes(scale, self._table,
                                                 self.scale_bound)

    @program("decode_begin")
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

    @program("quantize_slice")
    def quantize_slice(self, y: Tensor, i: int, mu: Tensor) -> Tensor:
        sc = self.slice_ch
        return torch.round(y[..., i * sc:(i + 1) * sc] - mu)

    @program("charm_uniform")
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
        return self._replay_pack(hm, support, syms, idxs, sigmas, y_slices,
                                 mu) + (z_hat,)

    @program("replay_pack")
    def _replay_pack(self, hm, support, syms, idxs, sigmas, y_slices, mu):
        """The Charm replay's tail: the last slice finished, the per-slice
        symbols, CDF rows, scales and y_hat joined."""
        y_last = self._reconstruct_last(hm, support, syms[-1], mu)
        return (torch.cat(syms, dim=-1), torch.cat(idxs, dim=-1),
                torch.cat(sigmas, dim=-1),
                torch.cat(list(y_slices) + [y_last], -1))

    def _generic_replay(self, y: Tensor, z_sym: Tensor):
        """Generic encode: the decoder's ``generic_params``, then the
        symbols around its mean.  Returns (symbols, indexes, scales, y_hat,
        z_hat), NHWC."""
        z_hat, mean, scale, indexes = self.generic_params(z_sym)
        symbols = torch.round(y - mean)
        return symbols, indexes, scale, symbols + mean, z_hat

    # ---------------- checkerboard programs (NHWC) ------------------------
    # The gather order of a phase's cells is ``_cb_ids``' (row-major cell
    # indexes, channels contiguous a cell): the device wire's lane order.

    def _cb_scatter(self, flat: Tensor, ids: Tensor, like: Tensor,
                    dtype=None) -> Tensor:
        """[N, len(ids) * sc] values of the cells ``ids`` -> the [N, h, w,
        sc] grid of ``like`` (zeros elsewhere), in ``dtype`` (default
        ``like``'s: the symbols' cast to the latent dtype happens here, as
        in JAX)."""
        n, h, w = like.shape[:3]
        sc = self.slice_ch
        dtype = dtype or like.dtype
        grid = torch.zeros((n, h * w, sc), dtype=dtype, device=like.device)
        grid.index_copy_(1, ids, flat.to(dtype).reshape(n, -1, sc))
        return grid.reshape(n, h, w, sc)

    @staticmethod
    def _cb_gather(grid: Tensor, ids: Tensor) -> Tensor:
        """[N, h, w, sc] -> [N, len(ids) * sc]: the cells ``ids``."""
        n, h, w, sc = grid.shape
        return grid.reshape(n, h * w, sc).index_select(1, ids).reshape(n, -1)

    @program("cb_begin")
    def cb_begin(self, z_sym: Tensor):
        """z dequantize + hyper-decode and the zero loop carries.  Returns
        (hm, hs, support, sym_na (zeros, [N, non-anchor cells * sc]), y_a,
        mu_c, z_hat)."""
        (hm, hs), z_hat = self._hyper_decode(z_sym)
        n, h, w, _ = hm.shape
        sc = self.slice_ch
        support = torch.zeros((n, h, w, self.max_support_slices * sc),
                              device=self.device)
        zeros = torch.zeros((n, h, w, sc), device=self.device)
        sym_na = torch.zeros((n, (h * w // 2) * sc), device=self.device)
        return hm, hs, support, sym_na, zeros, zeros, z_hat

    @program("cb_a_dev")
    def cb_a_dev(self, i: int, hm: Tensor, hs: Tensor, support: Tensor,
                 sym_na: Tensor, y_a: Tensor, mu_c: Tensor, a_ids: Tensor,
                 na_ids: Tensor):
        """Phase A of slice i: the previous round's non-anchor symbols
        scattered back, slice i-1 finished, slice i's channel-context params
        and the anchors' CDF rows in gather order.  Returns (y_prev,
        support, mu, sigma, idx_a [N, cells * sc] int32)."""
        sym_grid = self._cb_scatter(sym_na, na_ids, hm)
        y_prev, support, mu, sigma, idx = cb_phase_a(
            self._packed, i, hm, hs, support, sym_grid, y_a, mu_c,
            self._table, self.scale_bound, self.num_slices, self.slice_ch,
            self.max_support_slices, self.fused_slice_kernel)
        return y_prev, support, mu, sigma, self._cb_gather(idx, a_ids)

    @program("cb_b_dev")
    def cb_b_dev(self, i: int, sym_a: Tensor, mu: Tensor, sigma: Tensor,
                 a_ids: Tensor, na_ids: Tensor):
        """Phase B of slice i: the anchor symbols scattered, the spatial
        context, the non-anchors' CDF rows in gather order.  Returns (y_a,
        mu_c, sigma_c, idx_na [N, cells * sc] int32); sigma_c serves the
        encoder's predicted bits."""
        y_a, mu_c, sigma_c, idx = cb_phase_b(
            self._packed, i, self._cb_scatter(sym_a, a_ids, mu), mu, sigma,
            self._table, self.scale_bound)
        return y_a, mu_c, sigma_c, self._cb_gather(idx, na_ids)

    @program("cb_quant")
    def cb_quant(self, y: Tensor, i: int, mu: Tensor, ids: Tensor) -> Tensor:
        """Slice i of y rounded (half to even, as ``jnp.round``) around the
        mu a phase just gave, in gather order, int16 (the symbols' type
        between the programs in JAX)."""
        sc = self.slice_ch
        return self._cb_gather(torch.round(y[..., i * sc:(i + 1) * sc] - mu),
                               ids).to(torch.int16)

    def cb_final(self, hm, support, sym_na, y_a, mu_c, y_slices, na_ids,
                 rate_ind, beta):
        """The last round's non-anchors scattered, the last slice finished,
        synthesis.  Returns (image NHWC, y_hat NHWC)."""
        y_hat = self._cb_final_y(hm, support, sym_na, y_a, mu_c, y_slices,
                                 na_ids)
        return self._synthesis(y_hat, rate_ind, beta), y_hat

    @program("cb_final")
    def _cb_final_y(self, hm, support, sym_na, y_a, mu_c, y_slices, na_ids):
        """``cb_final`` before the synthesis, at the chain's precision:
        y_hat NHWC."""
        y_last = cb_reconstruct_last(
            self._packed, hm, support, self._cb_scatter(sym_na, na_ids, hm),
            y_a, mu_c, self.num_slices, self.fused_slice_kernel)
        return torch.cat(list(y_slices) + [y_last], dim=-1)

    @program("cb_replay_pack")
    def cb_replay_pack(self, hm, support, sym_na, y_a, mu_c, y_slices,
                       syms_a, syms_na, idxs_a, idxs_na, sigmas, sigmas_c,
                       a_ids, na_ids):
        """The checkerboard encode's tail: the per-phase symbols and CDF
        rows of the shared phases scattered back onto the grid, the last
        slice finished, and each cell's scale (sigma at the anchors,
        sigma_c elsewhere).  Returns (symbols, indexes int32, scales,
        y_hat), NHWC."""
        y_last = cb_reconstruct_last(
            self._packed, hm, support, self._cb_scatter(sym_na, na_ids, hm),
            y_a, mu_c, self.num_slices, self.fused_slice_kernel)
        y_hat = torch.cat(list(y_slices) + [y_last], dim=-1)
        anchor = anchor_mask(hm.shape[1], hm.shape[2], torch.bool,
                             hm.device)[None, :, :, None]

        def both(a, na, dtype=None):
            return (self._cb_scatter(a, a_ids, hm, dtype)
                    + self._cb_scatter(na, na_ids, hm, dtype))

        symbols = torch.cat([both(a, na) for a, na in zip(syms_a, syms_na)],
                            -1)
        indexes = torch.cat([both(a, na, torch.int32) for a, na in
                             zip(idxs_a, idxs_na)], -1)
        scales = torch.cat([torch.where(anchor, s, s_c) for s, s_c in
                            zip(sigmas, sigmas_c)], -1)
        return symbols, indexes, scales, y_hat

    def decode_final(self, hm, support, sym, mu, y_slices, rate_ind, beta):
        """Last-slice reconstruction + synthesis.  Returns (image NHWC, see
        ``_synthesis``; y_hat NHWC)."""
        y_hat = self._final_y(hm, support, sym, mu, y_slices)
        return self._synthesis(y_hat, rate_ind, beta), y_hat

    @program("decode_final")
    def _final_y(self, hm, support, sym, mu, y_slices) -> Tensor:
        """``decode_final`` before the synthesis, at the chain's
        precision: y_hat NHWC."""
        y_last = self._reconstruct_last(hm, support, sym, mu)
        return torch.cat(list(y_slices) + [y_last], dim=-1)

    def _synthesis(self, y_hat: Tensor, rate_ind, beta) -> Tensor:
        """Synthesis of NHWC ``y_hat`` at the fixed batch
        (``_fixed_batches``); ``rate_ind`` / ``beta`` (None where the model
        has none, else [1] or one per image) reach each call as one row per
        image, so the beta MLP and its 1x1 projections run at one row count
        too (module doc).  On a spatial mesh it runs in overlap tiles, one
        a replica.  Returns the image NHWC: f32 in [-1, 1], or uint8 with
        codec_uint8_io."""
        yc = _nchw(y_hat)
        n = yc.shape[0]
        conds = [None if t is None else
                 t.reshape(-1).expand(n).contiguous()
                 for t in (rate_ind, beta)]
        plan = self._spatial_plan(yc.shape[2], 1)
        if plan is None:
            img = self._synthesis_rows(yc, conds)
        else:
            img = self._spatial_map(
                yc, plan, 1, self.y_stride, lambda rep, yt: (
                    rep._synthesis_rows(yt, [None if c is None else
                                             c.to(rep.device)
                                             for c in conds])))
        img = img.float()
        lo = 0.0 if self.convert_img_range else -1.0
        img = _nhwc(torch.clamp(img, lo, 1.0))
        if self.codec_uint8_io:
            if self.convert_img_range:
                img = img * 2.0 - 1.0
            img = torch.clamp(torch.round((img + 1.0) * 127.5), 0, 255) \
                .to(torch.uint8)
        return img

    def _synthesis_rows(self, yc: Tensor, conds) -> Tensor:
        """The decoder on NCHW ``yc`` at the fixed batch, in the transform
        dtype (one spatial tile, or the whole latent)."""
        tdt = self.transform_dtype
        if tdt is not None:
            yc = yc.to(tdt)
            conds = [None if t is None else t.to(tdt) for t in conds]

        def call(yi, ri, bi):
            return (self._decode_image(yi, ri, bi),)

        with _tf32(self._transform_tf32):
            img, = _fixed_batches(call, yc, *conds)
        return img

    @program("decode_image")
    def _decode_image(self, y: Tensor, rate_ind, beta) -> Tensor:
        """The decoder on one fixed-batch call, at the transforms'
        precision."""
        return self.net.decode(y, rate_ind, beta, self._dec_t)

    # ---------------- AOT packages (runtime/aot.py) --------------------------

    def _aot_modules(self) -> List[Tuple[str, torch.nn.Module]]:
        """(prefix, module) of the modules whose tensors programs read: the
        net, and the bf16 transform copies when there are any."""
        inside = {id(m) for m in self.net.modules()}
        return [("net", self.net)] + [
            (p, m) for p, m in (("enc_t", self._enc_t),
                                ("henc_t", self._henc_t),
                                ("dec_t", self._dec_t)) if id(m) not in inside]

    def _aot_tensors(self) -> Dict[str, Tensor]:
        """Every model tensor a program may read, by name: the modules'
        parameters and buffers, the packed stacks, the scale table, K2's
        lane tables.  Inputs of an exported program, fed from here."""
        out = {f"{p}.{n}": t for p, mod in self._aot_modules()
               for n, t in itertools.chain(mod.named_parameters(),
                                           mod.named_buffers())}
        out.update({f"packed.{k}": t
                    for k, t in getattr(self, "_packed", {}).items()})
        out["table"] = self._table
        for tab in ("ytab", "ztab"):
            lt = getattr(self, "_" + tab)
            out.update({f"{tab}.{f}": getattr(lt, f)
                        for f in ("cdf", "cdf_len", "cdf_off", "buf")})
        return out

    @contextlib.contextmanager
    def _aot_swapped(self, tensors: Dict[str, Tensor]):
        """Inside the block the model reads ``tensors`` (names of
        ``_aot_tensors``) in place of its own (an export's inputs)."""
        from torch.nn.utils.stateless import _reparametrize_module

        def part(prefix):
            return {n[len(prefix) + 1:]: t for n, t in tensors.items()
                    if n.startswith(prefix + ".")}

        saved = {a: self.__dict__[a] for a in ("_packed", "_table", "_ytab",
                                               "_ztab") if a in self.__dict__}
        try:
            with contextlib.ExitStack() as stack:
                for prefix, mod in self._aot_modules():
                    if part(prefix):
                        stack.enter_context(
                            _reparametrize_module(mod, part(prefix)))
                if part("packed"):
                    self._packed = {**self._packed, **part("packed")}
                if "table" in tensors:
                    self._table = tensors["table"]
                for tab in ("ytab", "ztab"):
                    if part(tab):
                        setattr(self, "_" + tab,
                                getattr(self, "_" + tab)._replace(**part(tab)))
                yield
        finally:
            self.__dict__.update(saved)

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
        host rANS (on a batch mesh, one block of the batch a replica).
        Returns one dict per image with ``string_list = [header, z_str,
        y_str]``."""
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
        x = torch.from_numpy(np.ascontiguousarray(x))
        with codec_numerics(self._chain_tf32):
            shards = self._batch_shards(N)
            if shards is None:
                return self._compress(x.to(self.device), N, H, W, rate_ind)
            parts = self._on_replicas(lambda rep, sl: rep._compress(
                x[sl].to(rep.device), sl.stop - sl.start, H, W,
                _rows_of(rate_ind, sl)), shards)
            return [r for part in parts for r in part]

    def _compress(self, x: Tensor, N: int, H: int, W: int, rate_ind):
        """Encode by replay of the decoder's entropy chain (module doc),
        then the entropy coding of the configured wire."""
        timing = {}
        t0 = time.perf_counter()
        ri = self._cond_arg(rate_ind, N) if self.use_rate else None
        y, z_sym, pred_z_bits = self.encode_head(x, ri)
        if self._is_checkerboard:
            replay = self._encode_cb_replay
        elif self.use_charm:
            replay = self._charm_replay
        else:
            replay = self._generic_replay
        symbols, indexes, scales, y_hat, z_hat = replay(y, z_sym)
        lik = gaussian_likelihood(symbols, scales, self.scale_bound)
        pred_y_bits = -torch.sum(torch.log2(lik), dim=(1, 2, 3))
        maxabs = torch.amax(torch.abs(y_hat), dim=(1, 2, 3))
        meta = torch.stack([pred_y_bits, pred_z_bits, maxabs], 1)
        code = self._lane_wire if self.wire_format == "device" \
            else self._compressai_wire
        with _host():  # the wires launch no precision-sensitive operation
            y_str, z_str, meta = code(symbols, indexes, z_sym, meta, timing,
                                      t0)
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

    def _compressai_wire(self, symbols: Tensor, indexes: Tensor,
                         z_sym: Tensor, meta: Tensor, timing: Dict, t0: float):
        """The compressai wire's host rANS, one stream per image: y
        channel-major (the checkerboard: per slice the anchor subgrids, then
        the non-anchor ones, ``_checkerboard_serialize``), z the reference's
        channel-major stream.  Returns (y strings, z strings, meta)."""
        from ..runtime import rans_encode_with_indexes

        n = symbols.shape[0]
        if self._is_checkerboard:
            sym = symbols.to(torch.int32).cpu().numpy()
            idx = indexes.cpu().numpy()
            ns = self.num_slices
            sym_np = [_checkerboard_serialize(sym[i:i + 1], ns)
                      for i in range(n)]
            idx_np = [_checkerboard_serialize(idx[i:i + 1], ns)
                      for i in range(n)]
        else:
            sym_np = symbols.permute(0, 3, 1, 2).reshape(n, -1) \
                .to(torch.int32).cpu().numpy()
            idx_np = indexes.permute(0, 3, 1, 2).reshape(n, -1).cpu().numpy()
        z_np = z_sym.to(torch.int32).cpu().numpy()
        meta = meta.cpu().numpy()
        timing["device_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_str = self._z_serialize(z_np)
        cy = self.codec_y
        y_str = self._host_pmap(lambda i: rans_encode_with_indexes(
            sym_np[i], idx_np[i], cy.quantized_cdf, cy.cdf_length,
            cy.offset), n)
        timing["host_rans_s"] = time.perf_counter() - t0
        return y_str, z_str, meta

    # ---------------- decompress -------------------------------------------------

    def decompress(self, string_list: List[bytes], beta: float = 0.0):
        """Returns (fake [1, H, W, 3] f32 in [-1, 1], z_hat, y_hat), NHWC."""
        if len(string_list) != 3:
            raise ValueError("string list must be [header, z, y], got "
                             f"{len(string_list)} strings")
        return self.decompress_batch([string_list], beta)

    def decompress_batch(self, string_lists: List[List[bytes]], beta=0.0):
        """Batched decode: N same-size bitstreams through one set of device
        steps (on a batch mesh, one block of the batch a replica); per-image
        host rANS.  ``beta`` is a scalar or one per image.  Returns (fake
        [N, H, W, 3], z_hat, y_hat)."""
        if self.codec_z is None:
            raise RuntimeError("call codec_setup() first")
        for sl in string_lists:
            self._guard_wire_mismatch(sl[2])
        heads = [self.header_handler.decode(sl[0]) for sl in string_lists]
        H, W = heads[0]["img_size"]
        if any(tuple(hd["img_size"]) != (H, W) for hd in heads[1:]):
            raise ValueError("decompress_batch requires equal image sizes")
        padH = math.ceil(H / self.stride) * self.stride
        padW = math.ceil(W / self.stride) * self.stride
        zH, zW = padH // self.model_stride, padW // self.model_stride
        timing: Dict[str, float] = {}
        with codec_numerics(self._chain_tf32):
            shards = self._batch_shards(len(string_lists))
            if shards is None:
                fake, z_hat, y_hat = self._decode_on_device(
                    string_lists, heads, beta, zH, zW, timing)
            else:
                parts = self._on_replicas(lambda rep, sl: (
                    rep._decode_on_device(string_lists[sl], heads[sl],
                                          _rows_of(beta, sl), zH, zW,
                                          timing if sl.start == 0 else {})),
                    shards)
                fake, z_hat, y_hat = (np.concatenate(p) for p in zip(*parts))
        t0 = time.perf_counter()
        if fake.dtype == np.uint8:  # codec_uint8_io: the device sent uint8
            fake = uint8_to_tensor(fake)
            if self.convert_img_range:
                fake = (fake + 1.0) / 2.0
        fake = self.data_postprocess(fake, (H, W))
        timing["postprocess_s"] = time.perf_counter() - t0
        self.last_decode_timing = timing
        return fake, z_hat, y_hat

    def _decode_on_device(self, string_lists, heads, beta, zH: int, zW: int,
                          timing: Dict[str, float]):
        """The device part of ``decompress_batch`` on this model's device:
        (image NHWC as the device gave it, z_hat, y_hat), numpy."""
        n = len(string_lists)
        if self._is_checkerboard:
            chain, decode = self._cb_device_chain, self._decompress_cb
        elif self.use_charm:
            chain, decode = self._charm_device_chain, self._decompress_charm
        else:
            chain, decode = (self._generic_device_chain,
                             self._decompress_generic)
        if self.wire_format == "device":
            decode = functools.partial(self._device_decode, chain)
        ri = bt = None
        if self.use_rate:
            rates = np.asarray([hd["rate_ind"] for hd in heads], np.float32)
            ri = self._cond_arg(
                rates[:1] if np.all(rates == rates[0]) else rates, n)
        if self.use_beta:
            bt = self._cond_arg(beta, n)
        fake, z_hat, y_hat = decode(
            [sl[1] for sl in string_lists], [sl[2] for sl in string_lists],
            zH, zW, ri, bt, timing)
        t0 = time.perf_counter()
        with _host():
            fake = fake.cpu().numpy()  # waits for the device's last steps
            timing["fetch_s"] = time.perf_counter() - t0
            return fake, z_hat.cpu().numpy(), y_hat.cpu().numpy()

    def _decompress_charm(self, z_strs, y_strs, zH: int, zW: int, ri: Tensor,
                          bt: Tensor, timing: Dict[str, float]):
        """Serial Charm decode, batched over N streams: ``decode_begin``, then
        S-1 steps interleaved with the host rANS stream decode (one rANS state
        per image), then ``decode_final``.  Returns (image NHWC, z_hat,
        y_hat) on the device."""
        from ..runtime import RansStreamDecoder

        t0 = time.perf_counter()
        with _host():
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
                with _host():
                    idx_np = idx.cpu().numpy()  # [n, h, w, sc]
                    dec = np.stack(self._host_pmap(
                        lambda j: decoders[j].decode(
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
        with _host():
            z_sym = self.codec_z.decompress(z_strs, (zH, zW))
        z_hat, mean, _scale, idx = self.generic_params(
            torch.from_numpy(z_sym).to(self.device))
        n, h, w, c = idx.shape
        with _host():
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
        """Map ``fn`` over ``range(n)``, in threads when it helps (the C++
        coders release the GIL): host work, outside any precision
        section."""
        with _host():
            if n > 1 and (os.cpu_count() or 1) > 1:
                with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as ex:
                    return list(ex.map(fn, range(n)))
            return [fn(i) for i in range(n)]
