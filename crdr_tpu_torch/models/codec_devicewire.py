"""The device wire: lane-interleaved rans32 streams, encoded by E1 or the
host coder and decoded on the GPU by K2, so a decode is one chain of
launches (mixin for BaseModel); and the checkerboard's codec paths.

Counterpart of ``crdr_tpu/models/codec_devicewire.py`` (``_lane_k``,
``_lane_wire_statics``, ``_lane_wire_dev``, ``_lane_serialize``,
``_encode_cb_replay``, ``_cb_ids``, ``_upload_lane_streams``,
``_checkerboard_decompress``, and the three ``_decompress_*_device`` as one
``_device_decode`` over the family's chain), of
``codec_tables.py`` (``_ytab``, ``_ztab``, ``_zidx``, ``_z_device``), of
``codec_hostwire.py`` (``_z_serialize``, ``_guard_wire_mismatch``) and of the
``rans_round`` and ``lane_wire`` programs of ``codec_programs.py``.

Lane order (``_lane_wire_statics``), one lane round per autoregressive
decode round, as JAX:
* Charm: slice-major, for each slice the NHWC slice [h, w, sc] flattened;
* checkerboard: per slice the anchors, then the non-anchors, each cell-major
  with the slice's channels contiguous (``_cb_ids``' row-major cells: the
  gather order of ``cb_a_dev`` / ``cb_b_dev``);
* generic: one round over the NHWC latent [h, w, C] (``generic_params``'
  order);
* z: one round over the NHWC [h, w, C] latent with the channel as CDF row.

Encode: the replay chain of ``models/codec.py`` gives the symbols and CDF
rows; with ``device_wire_encoder: device`` E1 (``ops/lane_encode.py``)
lane-encodes them on the GPU and only the coded words and the escape
fixups come home; with ``host`` the host C++ lane coder
(``runtime/lane_rans.py``) writes them.  Both give one container per image,
byte for byte the same.  Unlike JAX, whose ``lane_wire`` program has a fixed
fixup buffer of ``device_wire_fixup_cap`` slots and re-encodes the batch on
the host when an image overflows it, E1's fixups keep every escape (eager
PyTorch needs no static shape), so the device encoder never falls back;
the cap is the host coder's first buffer size only.

Decode: the containers are unpacked and uploaded once; then the z round
(K2), the family's chain (Charm: ``decode_begin``, per slice one K2 round and
the Charm step; checkerboard: ``cb_begin``, per slice ``cb_a_dev``, a K2
round over the anchors, ``cb_b_dev``, a K2 round over the non-anchors;
generic: ``generic_params``, one K2 round) and the tail are launched with no
host sync in between; the only blocking fetch is the image at the end.
Legacy device-wire streams whose z is a CompressAI stream decode z on the
host.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

import torch

from ..ops.device_rans import apply_fixups, encode_grid, init_lane_state
from ..ops.lane_decode import (LaneTable, lane_decode_round,
                               prepare_lane_table)
from ..ops.lane_encode import lane_encode_rounds
from ..runtime.aot import program
from ..runtime.lane_rans import (LANE_MAGIC, lane_encode, pack_lane_container,
                                 unpack_lane_container)
from ..subnet.context_model.checkerboard import split_checkerboard
from .codec import _host
from .codec_common import _merge_np

Tensor = torch.Tensor
Lanes = Tuple[Tensor, Tensor, Tensor, Tensor]  # words, fix_pos, fix_val, act


class LaneStatics(NamedTuple):
    """Per latent shape: the y permutation into lane order (``perm`` on the
    device, int64), the y round boundaries (``off``), the lane grids of y
    and z for E1, and z's CDF rows."""
    perm: Tensor
    off: np.ndarray
    grid_y: Tensor
    grid_z: Tensor
    zidx: Tensor


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

    def _cb_ids(self, h: int, w: int):
        """Row-major cell indexes of the checkerboard's anchors ((y + x) % 2
        == 0) and non-anchors: (a_ids, na_ids) as int32 numpy and as int64
        device tensors.  The device wire's gather order, shared by the lane
        order, the phases' gathers / scatters and the host glue."""
        key = (h, w)
        if key not in self._cb_ids_cache:
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            mask = ((yy + xx) % 2 == 0).reshape(-1)
            ids = (np.flatnonzero(mask).astype(np.int32),
                   np.flatnonzero(~mask).astype(np.int32))
            self._cb_ids_cache[key] = ids + tuple(
                torch.from_numpy(a.astype(np.int64)).to(self.device)
                for a in ids)
        return self._cb_ids_cache[key]

    def _lane_wire_statics(self, yh: int, yw: int, zh: int,
                           zw: int) -> LaneStatics:
        """The lane order of this latent shape (module doc), its round
        boundaries, E1's grids and z's CDF rows, on the device; cached."""
        key = (yh, yw, zh, zw)
        if key in self._lane_enc_cache:
            return self._lane_enc_cache[key]
        ylen, zlen = yh * yw * self.yC, zh * zw * self.zC
        ns = getattr(self, "num_slices", 1)
        sc = getattr(self, "slice_ch", self.yC)
        if self._is_checkerboard:
            a_ids, na_ids = self._cb_ids(yh, yw)[:2]
            parts, off = [], [0]
            for s in range(ns):
                for ids in (a_ids, na_ids):
                    parts.append((ids[:, None].astype(np.int64) * self.yC
                                  + s * sc + np.arange(sc)[None, :])
                                 .reshape(-1))
                    off.append(off[-1] + ids.size * sc)
            perm = np.concatenate(parts)
        elif self.use_charm:
            perm = np.arange(ylen, dtype=np.int64) \
                .reshape(yh, yw, ns, sc).transpose(2, 0, 1, 3).reshape(-1)
            off = np.arange(ns + 1, dtype=np.int64) * (yh * yw * sc)
        else:
            perm = np.arange(ylen, dtype=np.int64)
            off = [0, ylen]
        off = np.asarray(off, np.int64)
        dev = self.device
        st = LaneStatics(
            torch.from_numpy(perm).to(dev), off,
            torch.from_numpy(encode_grid(off, self._lane_k(
                int(off[1] - off[0])))).to(dev),
            torch.from_numpy(encode_grid([0, zlen], self._lane_k(zlen)))
            .to(dev),
            (torch.arange(zlen, dtype=torch.int32, device=dev) % self.zC))
        self._lane_enc_cache[key] = st
        return st

    def _lane_wire(self, symbols: Tensor, indexes: Tensor, z_sym: Tensor,
                   meta: Tensor, timing: Dict, t0: float):
        """The device wire's entropy coding (module doc): E1 or the host
        lane coder.  Returns (y strings, z strings, meta)."""
        n, yh, yw, _ = symbols.shape
        zh, zw = z_sym.shape[1:3]
        st = self._lane_wire_statics(yh, yw, zh, zw)
        if self.device_wire_encoder == "device":
            return self._lane_wire_dev(symbols, indexes, z_sym, meta, st,
                                       timing, t0)
        sym_np = symbols.reshape(n, -1).index_select(1, st.perm) \
            .to(torch.int32).cpu().numpy()
        idx_np = indexes.reshape(n, -1).index_select(1, st.perm) \
            .cpu().numpy()
        z_np = z_sym.to(torch.int32).cpu().numpy()
        meta = meta.cpu().numpy()
        timing["device_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        z_str = self._z_serialize(z_np)
        y_str = self._lane_serialize(sym_np, idx_np, st.off)
        timing["host_rans_s"] = time.perf_counter() - t0
        return y_str, z_str, meta

    def _lane_wire_dev(self, symbols: Tensor, indexes: Tensor,
                       z_sym: Tensor, meta: Tensor, st: LaneStatics,
                       timing: Dict, t0: float):
        """E1 on the y and z symbols (the ``lane_wire`` program, every escape
        kept): only the lane lengths and escape counts, then the coded words
        and fixups, come home.  Returns (y strings, z strings, meta)."""
        n = symbols.shape[0]
        y, z, head = self._lane_encode(symbols, indexes, z_sym, meta,
                                       st.perm, st.grid_y, st.grid_z, st.zidx)
        head = head.cpu().numpy()
        ky, kz = y[1].shape[1], z[1].shape[1]
        y_lens, y_esc = head[:, :ky], head[:, ky]
        z_lens, z_esc = head[:, ky + 1:ky + 1 + kz], head[:, ky + 1 + kz]
        meta = np.ascontiguousarray(head[:, -3:]).view(np.float32)
        wy, wz = int(y_lens.max()), int(z_lens.max())
        fy, fz = int(y_esc.max()), int(z_esc.max())
        parts = (y[0][:, :, :wy], y[2][:, :fy], y[3][:, :fy],
                 z[0][:, :, :wz], z[2][:, :fz], z[3][:, :fz])
        body = torch.cat([p.flatten(1) for p in parts], 1).cpu().numpy()
        timing["device_encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sizes = np.cumsum([p[0].numel() for p in parts])[:-1]
        yw, yfp, yfv, zw, zfp, zfv = np.split(body, sizes, axis=1)

        def containers(words, k, lens, fp, fv, esc):
            words = words.reshape(n, k, -1).astype(np.uint16)
            return [pack_lane_container(words[i], lens[i],
                                        fp[i, :esc[i]].astype(np.int64),
                                        fv[i, :esc[i]]) for i in range(n)]

        y_str = containers(yw, ky, y_lens, yfp, yfv, y_esc)
        z_str = containers(zw, kz, z_lens, zfp, zfv, z_esc)
        timing["host_rans_s"] = time.perf_counter() - t0
        return y_str, z_str, meta

    @program("lane_wire")
    def _lane_encode(self, symbols: Tensor, indexes: Tensor, z_sym: Tensor,
                     meta: Tensor, perm: Tensor, grid_y: Tensor,
                     grid_z: Tensor, zidx: Tensor):
        """The device part of ``_lane_wire_dev``: y and z in lane order
        through E1, and the head (lane lengths, escape counts, meta as
        int32) that comes home first.  Returns (y's and z's
        ``lane_encode_rounds``, head)."""
        n = symbols.shape[0]
        yt, zt = self._ytab, self._ztab
        sym_l = symbols.reshape(n, -1).index_select(1, perm).to(torch.int32)
        idx_l = indexes.reshape(n, -1).index_select(1, perm)
        y = lane_encode_rounds(sym_l, idx_l, grid_y, yt.cdf, yt.cdf_len,
                               yt.cdf_off, None)
        z = lane_encode_rounds(z_sym.reshape(n, -1).to(torch.int32),
                               zidx.expand(n, -1), grid_z, zt.cdf,
                               zt.cdf_len, zt.cdf_off, None)
        head = torch.cat([y[1], y[4][:, None], z[1], z[4][:, None],
                          meta.view(torch.int32)], 1)
        return y, z, head

    def _encode_cb_replay(self, y: Tensor, z_sym: Tensor):
        """Checkerboard encode by replay of the decoder's phases:
        ``cb_begin``, then per slice ``cb_a_dev`` -> ``cb_quant`` (anchors)
        -> ``cb_b_dev`` -> ``cb_quant`` (non-anchors), then
        ``cb_replay_pack``.  Every parameter that picks a CDF row comes from
        the function the decoder calls.  Returns (symbols, indexes, scales,
        y_hat, z_hat), NHWC."""
        hm, hs, support, sym_na, y_a, mu_c, z_hat = self.cb_begin(z_sym)
        a_ids, na_ids = self._cb_ids(hm.shape[1], hm.shape[2])[2:]
        syms_a, syms_na, idxs_a, idxs_na, sigmas, sigmas_c = \
            [], [], [], [], [], []
        y_slices: List[Tensor] = []
        for i in range(self.num_slices):
            y_prev, support, mu, sigma, idx_a = self.cb_a_dev(
                i, hm, hs, support, sym_na, y_a, mu_c, a_ids, na_ids)
            if i > 0:
                y_slices.append(y_prev)
            sym_a = self.cb_quant(y, i, mu, a_ids)
            y_a, mu_c, sigma_c, idx_na = self.cb_b_dev(i, sym_a, mu, sigma,
                                                       a_ids, na_ids)
            sym_na = self.cb_quant(y, i, mu_c, na_ids)
            syms_a.append(sym_a)
            syms_na.append(sym_na)
            idxs_a.append(idx_a)
            idxs_na.append(idx_na)
            sigmas.append(sigma)
            sigmas_c.append(sigma_c)
        return self.cb_replay_pack(
            hm, support, sym_na, y_a, mu_c, y_slices, syms_a, syms_na,
            idxs_a, idxs_na, sigmas, sigmas_c, a_ids, na_ids) + (z_hat,)

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

    @program("rans_round")
    def rans_round(self, lanes: Lanes, state, idx: Tensor, lo: int,
                   which: str) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """One K2 round over ``idx`` [N, ...] (CDF rows in decode order) with
        the fixups of [lo, lo + m) overlaid, on the ``which`` ("y" / "z")
        table.  ``state`` (states, ptrs) carries from the previous round
        (None: seed from the words).  Returns the symbols as f32 shaped like
        ``idx`` and the new state."""
        table = self._ytab if which == "y" else self._ztab
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
        hm, hs, support, mu, _sigma, idx, z_hat = self.decode_begin(
            self._lane_z(z, y_lanes[0].shape[0], zh, zw))
        m = idx[0].numel()
        state = None
        y_slices: List[Tensor] = []
        for i in range(self.num_slices):
            sym, state = self.rans_round(y_lanes, state, idx, i * m, "y")
            if i < self.num_slices - 1:
                y_prev, support, mu, _sigma, idx = self.charm_step(
                    i + 1, hm, hs, support, sym, mu)
                y_slices.append(y_prev)
        fake, y_hat = self.decode_final(hm, support, sym, mu, y_slices,
                                        rate_ind, beta)
        return fake, z_hat, y_hat

    def _lane_z(self, z, n: int, zh: int, zw: int) -> Tensor:
        """z symbols [n, zh, zw, C] on the device: one K2 round for lane
        streams, else the host-decoded legacy symbols as they are."""
        if not isinstance(z, tuple):
            return z
        return self.rans_round(
            z, None, self._zidx(n, zh, zw).reshape(n, zh, zw, -1), 0, "z")[0]

    def _cb_device_chain(self, z, y_lanes: Lanes, zh: int, zw: int,
                         rate_ind: Tensor, beta: Tensor):
        """Device side of the device-wire checkerboard decode: per slice two
        K2 rounds ride between ``cb_a_dev`` and ``cb_b_dev`` (anchors, then
        non-anchors); launches only, no host sync.  Returns (image NHWC,
        z_hat, y_hat) on the device."""
        n = y_lanes[0].shape[0]
        hm, hs, support, sym_na, y_a, mu_c, z_hat = self.cb_begin(
            self._lane_z(z, n, zh, zw))
        a_ids, na_ids = self._cb_ids(hm.shape[1], hm.shape[2])[2:]
        state, lo = None, 0
        y_slices: List[Tensor] = []
        for i in range(self.num_slices):
            y_prev, support, mu, sigma, idx_a = self.cb_a_dev(
                i, hm, hs, support, sym_na, y_a, mu_c, a_ids, na_ids)
            if i > 0:
                y_slices.append(y_prev)
            sym_a, state = self.rans_round(y_lanes, state, idx_a, lo, "y")
            lo += idx_a.shape[1]
            y_a, mu_c, _sigma_c, idx_na = self.cb_b_dev(i, sym_a, mu, sigma,
                                                        a_ids, na_ids)
            sym_na, state = self.rans_round(y_lanes, state, idx_na, lo,
                                            "y")
            lo += idx_na.shape[1]
        fake, y_hat = self.cb_final(hm, support, sym_na, y_a, mu_c,
                                    y_slices, na_ids, rate_ind, beta)
        return fake, z_hat, y_hat

    def _generic_device_chain(self, z, y_lanes: Lanes, zh: int, zw: int,
                              rate_ind: Tensor, beta: Tensor):
        """Device side of the generic device-wire decode: ``generic_params``
        (the function the encoder replayed), one K2 round over the whole
        latent in its [h, w, C] order, ``+ mean`` and the synthesis (JAX's
        ``generic_final``); launches only.  Returns (image NHWC, z_hat,
        y_hat) on the device."""
        n = y_lanes[0].shape[0]
        z_hat, mean, _scale, idx = self.generic_params(
            self._lane_z(z, n, zh, zw))
        sym, _ = self.rans_round(y_lanes, None, idx, 0, "y")
        y_hat = sym + mean
        return self._synthesis(y_hat, rate_ind, beta), z_hat, y_hat

    def _device_decode(self, chain, z_strs, y_strs, zh, zw, ri, bt,
                       timing: Dict[str, float]):
        """A device-wire decode: the host unpack and upload, then the
        family's ``chain`` of launches.  Returns the chain's (image NHWC,
        z_hat, y_hat) on the device; the caller's fetch of the image is the
        decode's one blocking sync."""
        t0 = time.perf_counter()
        with _host():
            z, y_lanes = self._device_wire_inputs(z_strs, y_strs, zh, zw)
        timing["host_unpack_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = chain(z, y_lanes, zh, zw, ri, bt)
        timing["device_chain_s"] = time.perf_counter() - t0  # enqueue only
        return out

    def _decompress_cb(self, z_strs: List[bytes], y_strs: List[bytes],
                       zh: int, zw: int, ri: Tensor, bt: Tensor,
                       timing: Dict[str, float]):
        """Compressai-wire checkerboard decode, batched over N streams: the
        same ``cb_begin`` / ``cb_a_dev`` / ``cb_b_dev`` / ``cb_final`` as the
        device wire, with each image's host rANS stream between the phases:
        per slice the anchor subgrids A1, A2, then the non-anchor subgrids
        NA1, NA2, each channel-major.  The glue between the phases' cell
        order and the subgrids is exact integer numpy.  Returns (image NHWC,
        z_hat, y_hat) on the device."""
        from ..runtime import RansStreamDecoder

        t0 = time.perf_counter()
        with _host():
            z_sym = self.codec_z.decompress(z_strs, (zh, zw))
        hm, hs, support, sym_na, y_a, mu_c, z_hat = self.cb_begin(
            torch.from_numpy(z_sym).to(self.device))
        timing["z_hyper_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n, h, w = hm.shape[:3]
        sc, cy = self.slice_ch, self.codec_y
        a_np, na_np, a_ids, na_ids = self._cb_ids(h, w)
        decoders = [RansStreamDecoder(s) for s in y_strs]

        def grid(idx_flat: Tensor, ids: np.ndarray) -> np.ndarray:
            out = np.zeros((n, h * w, sc), np.int32)
            out[:, ids] = idx_flat.cpu().numpy().reshape(n, ids.size, sc)
            return out.reshape(n, h, w, sc)

        def decode(subgrids) -> List[np.ndarray]:
            """Each [n, h2, w2, sc] subgrid of CDF rows -> its symbols,
            image j's from its stream, channel-major."""
            def one(j):
                return [decoders[j].decode(
                    g[j].transpose(2, 0, 1).reshape(-1), cy.quantized_cdf,
                    cy.cdf_length, cy.offset).reshape(
                        sc, g.shape[1], g.shape[2]).transpose(1, 2, 0)
                    for g in subgrids]
            per_image = self._host_pmap(one, n)
            return [np.stack([p[k] for p in per_image])
                    for k in range(len(subgrids))]

        def gather(grid_np: np.ndarray, ids: np.ndarray) -> Tensor:
            flat = grid_np.reshape(n, h * w, sc)[:, ids].reshape(n, -1)
            return torch.from_numpy(flat.astype(np.float32)).to(self.device)

        y_slices: List[Tensor] = []
        try:
            for i in range(self.num_slices):
                y_prev, support, mu, sigma, idx_a = self.cb_a_dev(
                    i, hm, hs, support, sym_na, y_a, mu_c, a_ids, na_ids)
                if i > 0:
                    y_slices.append(y_prev)
                a1, a2 = decode(split_checkerboard(grid(idx_a, a_np))[:2])
                z2 = np.zeros_like(a1)
                sym_a = gather(_merge_np(a1, a2, z2, z2), a_np)
                y_a, mu_c, _sigma_c, idx_na = self.cb_b_dev(
                    i, sym_a, mu, sigma, a_ids, na_ids)
                na1, na2 = decode(split_checkerboard(grid(idx_na, na_np))[2:])
                sym_na = gather(_merge_np(z2, z2, na1, na2), na_np)
        finally:
            for d in decoders:
                d.close()
        timing["cb_loop_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fake, y_hat = self.cb_final(hm, support, sym_na, y_a, mu_c, y_slices,
                                    na_ids, ri, bt)
        timing["decode_final_s"] = time.perf_counter() - t0
        return fake, z_hat, y_hat
