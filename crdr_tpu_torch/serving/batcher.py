"""Micro-batching request scheduler for codec serving.

Counterpart of ``crdr_tpu/serving/batcher.py``, with the same public API and
the same grouping rules.  Serving traffic arrives one request at a time; a
batched ``compress_batch`` / ``decompress_batch`` dispatch shares the
launches of the codec chain over its images.  The scheduler coalesces
concurrent compress / decompress requests into such dispatches, and requests
with different quality settings share one: each image of a batch carries its
own ``rate_ind`` / ``beta``.

Grouping rules (what can share one dispatch):
- compress:   equal image (H, W) and dtype: batch items must stack;
- decompress: equal coded image size (from each container's header) and
  equal string count.
Mixed ``rate_ind`` / ``beta`` values are allowed within a group.

The scheduler is a single worker thread: it takes the oldest request, then
keeps collecting compatible requests until the batch is full or the
coalesce window (``max_wait_s``, counted from the FIRST request in the
group) closes; incompatible requests stay queued in arrival order.  Every
model call runs on that one thread.  The codec entry points set their own
numerics (``models/codec.py::codec_numerics``: the cuDNN / TF32 flags under
a lock, and ``no_grad``, which is per thread), and launch on the worker
thread's current CUDA stream, the device's default stream; the request
threads touch only host bytes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.img_utils import tensor_to_uint8

__all__ = ["MicroBatcher"]


class _Req:
    __slots__ = ("kind", "payload", "cond", "key", "future", "t_enq")

    def __init__(self, kind: str, payload: Any, cond: Optional[float],
                 key: Tuple):
        self.kind = kind
        self.payload = payload
        self.cond = cond  # rate_ind (compress) / beta (decompress) or None
        self.key = key
        self.future: Future = Future()
        self.t_enq = time.perf_counter()


def _resolve(fut: Future, setter, value) -> None:
    """Set one future; a future its caller cancelled is skipped, so it never
    poisons its co-batched neighbours."""
    try:
        setter(fut, value)
    except InvalidStateError:
        pass


class MicroBatcher:
    """Coalesce concurrent codec requests into batched device dispatches.

    Thread-safe producers (``submit_*`` / blocking ``compress`` /
    ``decompress``), single consumer thread.  ``stats()`` exposes dispatch
    counters for monitoring and tests.
    """

    def __init__(self, model, max_batch: int = 8,
                 max_wait_s: float = 0.01,
                 batch_buckets: Optional[List[int]] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.model = model
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        # Groups are trimmed to the largest bucket that fits and the
        # remainder requeued (it dispatches next, its window already spent).
        # Eager PyTorch compiles nothing per batch size, so the port needs no
        # grid of its own; it keeps the JAX package's default (powers of two
        # up to max_batch, and max_batch) so that one request script makes
        # the same dispatches in both packages.
        if batch_buckets is None:
            batch_buckets = [1 << i for i in range(self.max_batch.bit_length())
                             if 1 << i <= self.max_batch]
            if self.max_batch not in batch_buckets:
                batch_buckets.append(self.max_batch)
        if 1 not in batch_buckets:
            raise ValueError("bucket 1 is required as the fallback")
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        self._q: deque[_Req] = deque()
        self._lock = threading.Lock()
        self._notify = threading.Condition(self._lock)
        self._running = True
        self._stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "batched_requests": 0,
            "batch_hist": {},  # batch size -> count
            "queue_wait_s_sum": 0.0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="crdr-microbatcher")
        self._worker.start()

    # ------------------------------------------------------------------ api

    def submit_compress(self, img: np.ndarray,
                        rate_ind: Optional[float] = None) -> Future:
        """Enqueue one image ([H,W,3] uint8 or [-1,1] float32).  Resolves to
        the model's per-image encode dict (``string_list`` et al.)."""
        img = np.asarray(img)
        if img.ndim != 3:
            raise ValueError(f"one [H,W,3] image per request, got {img.shape}")
        key = ("c", img.shape[0], img.shape[1], str(img.dtype))
        return self._enqueue(_Req("compress", img, rate_ind, key))

    def submit_decompress(self, string_list: List[bytes],
                          beta: Optional[float] = None) -> Future:
        """Enqueue one coded container (list of byte strings).  Resolves to
        a uint8 [H,W,3] reconstruction.  The header is parsed here, on the
        caller's thread: a malformed one raises to the caller."""
        head = self.model.header_handler.decode(string_list[0])
        key = ("d", tuple(head["img_size"]), len(string_list))
        return self._enqueue(_Req("decompress", list(string_list), beta, key))

    def compress(self, img, rate_ind: Optional[float] = None) -> Dict:
        return self.submit_compress(img, rate_ind).result()

    def decompress(self, string_list, beta: Optional[float] = None
                   ) -> np.ndarray:
        return self.submit_decompress(string_list, beta).result()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self._stats)
            s["batch_hist"] = dict(self._stats["batch_hist"])
            s["queued"] = len(self._q)
        return s

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue and stop the worker."""
        with self._notify:
            self._running = False
            self._notify.notify_all()
        self._worker.join(timeout)

    # --------------------------------------------------------------- worker

    def _enqueue(self, req: _Req) -> Future:
        with self._notify:
            if not self._running:
                raise RuntimeError("MicroBatcher is closed")
            self._q.append(req)
            self._stats["requests"] += 1
            self._notify.notify_all()
        return req.future

    def _collect_group(self) -> Optional[List[_Req]]:
        """Block for the next request, then coalesce compatible ones until
        the batch fills or the window (from the group head's arrival)
        closes.  Runs on the worker thread."""
        with self._notify:
            while self._running and not self._q:
                self._notify.wait()
            if not self._q:
                return None  # closed and drained
            head = self._q.popleft()
            group = [head]
            deadline = head.t_enq + self.max_wait_s
            while len(group) < self.max_batch:
                # pull every currently-queued compatible request
                rest = deque()
                while self._q and len(group) < self.max_batch:
                    r = self._q.popleft()
                    if r.key == head.key:
                        group.append(r)
                    else:
                        rest.append(r)
                # preserve arrival order of the incompatible remainder
                self._q.extendleft(reversed(rest))
                if len(group) >= self.max_batch:
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._running:
                    break
                self._notify.wait(remaining)
            # trim to a bucket; requeue the tail at the queue front (arrival
            # order kept; it dispatches next round without waiting)
            bucket = max(b for b in self.batch_buckets if b <= len(group))
            if bucket < len(group):
                self._q.extendleft(reversed(group[bucket:]))
                group = group[:bucket]
            return group

    def _run(self) -> None:
        while True:
            group = self._collect_group()
            if group is None:
                return
            t0 = time.perf_counter()
            try:
                results = self._dispatch(group)
                for req, res in zip(group, results):
                    _resolve(req.future, Future.set_result, res)
            except BaseException as e:  # resolve every waiter, never hang
                for req in group:
                    _resolve(req.future, Future.set_exception, e)
                if not isinstance(e, Exception):
                    raise
            with self._lock:
                n = len(group)
                self._stats["batches"] += 1
                self._stats["batched_requests"] += n
                h = self._stats["batch_hist"]
                h[n] = h.get(n, 0) + 1
                self._stats["queue_wait_s_sum"] += t0 - group[0].t_enq

    # ------------------------------------------------------------- dispatch

    def _cond_vector(self, group: List[_Req]) -> Any:
        """Per-request conditioning values -> scalar (uniform) or [N]
        vector (mixed).  An unset value is ALWAYS 0.0: fixed per request,
        never dependent on what the request happened to batch with."""
        filled = [0.0 if r.cond is None else float(r.cond) for r in group]
        if all(v == filled[0] for v in filled):
            return filled[0]
        return np.asarray(filled, np.float32)

    def _dispatch(self, group: List[_Req]) -> List[Any]:
        model = self.model
        cond = self._cond_vector(group)
        if group[0].kind == "compress":
            imgs = np.stack([r.payload for r in group])
            kwargs = {}
            if getattr(model, "use_rate", False):
                kwargs["rate_ind"] = cond
            return model.compress_batch(imgs, **kwargs)
        kwargs = {}
        if getattr(model, "use_beta", False):
            kwargs["beta"] = cond
        fake, _, _ = model.decompress_batch(
            [r.payload for r in group], **kwargs)
        fake = np.asarray(fake)
        if fake.dtype != np.uint8:
            fake = tensor_to_uint8(fake)
        return [fake[i] for i in range(fake.shape[0])]
