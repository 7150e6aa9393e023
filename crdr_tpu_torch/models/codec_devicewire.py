"""The device wire: lane-interleaved rans32 streams decoded on the GPU, so the
whole Charm decode is one chain of launches (mixin for BaseModel).

Counterpart of the Charm part of ``crdr_tpu/models/codec_devicewire.py``
(``_lane_k``, ``_lane_serialize``, ``_upload_lane_streams``,
``_decompress_charm_device``), of ``codec_tables.py`` (``_ytab``, ``_ztab``,
``_zidx``, ``_z_device``), of ``codec_hostwire.py`` (``_z_serialize``,
``_guard_wire_mismatch``) and of the ``rans_round`` program of
``codec_programs.py``.

Encode: the replay chain of ``models/codec.py`` gives the symbols and CDF
rows; the host C++ lane coder (``runtime/lane_rans.py``) writes one
container per image, y in slice-major order (for each slice, the NHWC slice
[h, w, sc] flattened; one lane round per slice) and z as one round over the
NHWC [h, w, C] latent with the channel as CDF row.

Decode: the containers are unpacked and uploaded once; then the z round
(K2), ``decode_begin``, per slice one K2 round (fixups overlaid at
``lo = i * m``) and the Charm step, and ``decode_final`` are launched with no
host sync in between; the only blocking fetch is the image at the end.
Legacy device-wire streams whose z is a CompressAI stream decode z on the
host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

import torch

from ..ops.device_rans import apply_fixups, init_lane_state
from ..ops.lane_decode import (LaneTable, lane_decode_round,
                               prepare_lane_table)
from ..runtime.lane_rans import (LANE_MAGIC, lane_encode, pack_lane_container,
                                 unpack_lane_container)

Tensor = torch.Tensor
Lanes = Tuple[Tensor, Tensor, Tensor, Tensor]  # words, fix_pos, fix_val, act


def _is_lane(blob: bytes) -> bool:
    return blob[:len(LANE_MAGIC)] == LANE_MAGIC


class DeviceWireCodecMixin:
    def _device_tables(self, codec) -> LaneTable:
        """A codec's CDF tables on the device, in K2's two forms: the dense
        int32 tensors (cdf, len, off) and the kernel-ready buffer."""
        return prepare_lane_table(codec.quantized_cdf, codec.cdf_length,
                                  codec.offset, device=self.device)

    def _lane_k(self, m: int) -> int:
        """Lane count for an ``m``-symbols-per-round stream: the config value,
        reduced for small latents so the fixed per-lane cost (2 state words
        and a u16 length) stays a few percent of the stream; the decoder
        reads K from the container."""
        return min(self.device_wire_lanes,
                   max(8, 1 << max(0, (m // 64).bit_length() - 1)))

    # ---------------- encode -----------------------------------------------

    def _lane_serialize(self, sym_l: np.ndarray, idx_l: np.ndarray,
                        slice_off: np.ndarray, codec=None) -> List[bytes]:
        """Lane-encode [N, M] symbols / CDF rows, already in decode order,
        into one container per image.  ``slice_off``: the round boundaries
        (where the lane assignment restarts).  ``codec``: the tables, y's
        by default."""
        codec = codec or self.codec_y
        k = self._lane_k(int(slice_off[1] - slice_off[0]))
        sym_l = sym_l.astype(np.int32)
        idx_l = idx_l.astype(np.int32)

        def one(i):
            return pack_lane_container(*lane_encode(
                sym_l[i], idx_l[i], slice_off, k, codec.quantized_cdf,
                codec.cdf_length, codec.offset,
                fix_cap=self.device_wire_fixup_cap))

        return self._host_pmap(one, sym_l.shape[0])

    def _z_serialize(self, z_sym_np: np.ndarray) -> List[bytes]:
        """z strings for the configured wire.  Device wire: one lane round in
        flat NHWC [h, w, C] order with the channel as CDF row.  CompressAI
        wire: the reference's channel-major rANS stream."""
        z_sym_np = z_sym_np.astype(np.int32)
        if self.wire_format != "device":
            return self.codec_z.compress_symbols(z_sym_np)
        n, zh, zw, c = z_sym_np.shape
        idx = np.broadcast_to(np.arange(c, dtype=np.int32), (n, zh * zw, c))
        return self._lane_serialize(
            z_sym_np.reshape(n, -1), idx.reshape(n, -1),
            np.asarray([0, zh * zw * c], np.int64), codec=self.codec_z)

    # ---------------- decode -----------------------------------------------

    def _guard_wire_mismatch(self, y_str: bytes) -> None:
        """A device-wire y string (CRDW magic) given to a compressai-wire
        model raises instead of desyncing into garbage; the other mismatch
        raises in ``unpack_lane_container``."""
        if self.wire_format == "compressai" and _is_lane(y_str):
            raise ValueError(
                "this bitstream is in the device wire format (CRDW lane "
                "container) but the model is configured wire_format: "
                "compressai; set wire_format: device to decode it")

    def _upload_lane_streams(self, strs: List[bytes]) -> Lanes:
        """Unpack containers and upload [N, K, W] int32 words, [N, F] fixup
        positions / values and their [N, F] active mask."""
        parts = [unpack_lane_container(s) for s in strs]
        n, k = len(parts), parts[0][0].shape[0]
        if any(p[0].shape[0] != k for p in parts):
            raise ValueError("the streams of one batch have different lane "
                             "counts")
        wmax = max(p[0].shape[1] for p in parts)
        fmax = max(1, max(p[2].size for p in parts))
        words = np.zeros((n, k, wmax), np.int32)
        fix_pos = np.zeros((n, fmax), np.int64)
        fix_val = np.zeros((n, fmax), np.int32)
        fix_act = np.zeros((n, fmax), bool)
        for i, (w, _lens, fp, fv) in enumerate(parts):
            words[i, :, :w.shape[1]] = w
            fix_pos[i, :fp.size] = fp
            fix_val[i, :fp.size] = fv
            fix_act[i, :fp.size] = True
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (words, fix_pos, fix_val, fix_act))

    def _zidx(self, n: int, zh: int, zw: int) -> Tensor:
        """z CDF rows [n, zh*zw*C] int32: the channel id, NHWC order."""
        return torch.arange(self.codec_z.channels, dtype=torch.int32,
                            device=self.device).repeat(n, zh * zw)

    @staticmethod
    def _rans_round(lanes: Lanes, state, idx: Tensor, lo: int,
                    table: LaneTable
                    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """One K2 round over ``idx`` [N, ...] (CDF rows in decode order) with
        the fixups of [lo, lo + m) overlaid.  ``state`` (states, ptrs) carries
        from the previous round (None: seed from the words).  Returns the
        symbols as f32 shaped like ``idx`` and the new state."""
        words, fix_pos, fix_val, fix_act = lanes
        if state is None:
            state = init_lane_state(words)
        n = idx.shape[0]
        m = idx[0].numel()
        vals, states, ptrs = lane_decode_round(
            *state, words, idx.reshape(n, m), table, m)
        vals = apply_fixups(vals, fix_pos, fix_val, fix_act, lo, m)
        return vals.reshape(idx.shape).to(torch.float32), (states, ptrs)

    def _device_wire_inputs(self, z_strs: List[bytes], y_strs: List[bytes],
                            zh: int, zw: int):
        """Host side of the device-wire decode: unpack and upload the lane
        streams; a legacy CompressAI z stream decodes on the host."""
        z_lane = [_is_lane(s) for s in z_strs]
        if all(z_lane):
            z = self._upload_lane_streams(z_strs)
        elif not any(z_lane):
            z = torch.from_numpy(np.ascontiguousarray(
                self.codec_z.decompress(z_strs, (zh, zw)))).to(self.device)
        else:
            raise ValueError("one batch mixes lane and CompressAI z streams")
        return z, self._upload_lane_streams(y_strs)

    def _charm_device_chain(self, z, y_lanes: Lanes, zh: int, zw: int,
                            rate_ind: Tensor, beta: Tensor):
        """Device side of the device-wire Charm decode: launches only, no
        host sync.  Returns (image NHWC, z_hat, y_hat) on the device."""
        if isinstance(z, tuple):  # lane z: one K2 round
            n = z[0].shape[0]
            z, _ = self._rans_round(
                z, None, self._zidx(n, zh, zw).reshape(n, zh, zw, -1), 0,
                self._ztab)
        hm, hs, support, mu, _sigma, idx, z_hat = self.decode_begin(z)
        m = idx[0].numel()
        state = None
        y_slices: List[Tensor] = []
        for i in range(self.num_slices):
            sym, state = self._rans_round(y_lanes, state, idx, i * m,
                                          self._ytab)
            if i < self.num_slices - 1:
                y_prev, support, mu, _sigma, idx = self.charm_step(
                    i + 1, hm, hs, support, sym, mu)
                y_slices.append(y_prev)
        fake, y_hat = self.decode_final(hm, support, sym, mu, y_slices,
                                        rate_ind, beta)
        return fake, z_hat, y_hat

    def _decompress_charm_device(self, z_strs: List[bytes],
                                 y_strs: List[bytes], zh: int, zw: int,
                                 ri: Tensor, bt: Tensor,
                                 timing: Dict[str, float]):
        """Device-wire Charm decode, batched over N streams: the slice steps
        of the compressai-wire decode, with the symbols from K2 instead of
        the host rANS (see the module doc).  Returns (image NHWC, z_hat,
        y_hat) on the device; the caller's fetch of the image is the decode's
        one blocking sync."""
        t0 = time.perf_counter()
        z, y_lanes = self._device_wire_inputs(z_strs, y_strs, zh, zw)
        timing["host_unpack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self._charm_device_chain(z, y_lanes, zh, zw, ri, bt)
        timing["device_chain_s"] = time.perf_counter() - t0  # enqueue only
        return out
