"""AOT serving packages: the codec's device programs exported with
``torch.export``, per serving shape bucket, and served from a package.

Counterpart of ``crdr_tpu/runtime/aot.py`` (``ExeDispatch``,
``AotRecorder``, ``AotPackage``, ``export_package``,
``record_serving_roundtrip``, ``load_package``, ``MANIFEST``), same names and
semantics.  A package is a directory of ``.pt2`` files (``torch.export.save``)
and ``manifest.json``; a fresh process loads it with ``torch.export.load``
and runs the programs without running the model's Python for them.

Integration point: every device program of the codec is a method decorated
``@program(name)`` (``models/codec.py``, ``models/codec_devicewire.py``),
named after its JAX program.  A dispatch
- records (name, method, concrete args) on the first call of each signature
  while an ``AotRecorder`` is armed (``record_serving_roundtrip`` drives a
  real compress / decompress round trip at a serving shape), with the model
  tensors the call read;
- runs a loaded package's program when the call's signature is in the
  package (``aot_hits``), else the live method (``aot_misses``): an unseen
  shape still serves;
- is a plain call outside a recorder and a package, and inside another
  dispatch.

The signature key is the program name, the argument tree, each tensor's
(shape, dtype, device), each Python scalar's value (``torch.export``
specialises them, e.g. a slice index), the model's device, and the numerics
the call runs under: the TF32 flags of its precision section, cuDNN's
``deterministic`` / ``benchmark`` / ``enabled``, and grad mode.  Those flags
are process-wide and read by each convolution and matmul when it runs, not
traced into a graph, so an exported program runs inside the same section as
the live call it replaces; a program therefore never spans two sections
(the transforms' ``encode_latents`` / ``decode_image`` are programs of
their own).

The package holds programs, not weights.  Every model tensor a program reads
(parameters and buffers of the net and of its bf16 transform copies, the
packed Charm / checkerboard stacks with K1's bf16 copies, the scale table,
K2's lane tables) is an input of the exported program, fed from the live
model at call time; an entry lists the names, shapes and dtypes it takes,
and a model whose tensors differ there misses.  So a package serves any
checkpoint of the same config, and its size does not grow with the model.

The kernels (K1, K2, K3, E1) are registered ops (``crdr::*``): one node
each in a graph, dispatched at run time by device to the kernel or the twin.
``platforms`` (default ``cuda,cpu``): the programs are recorded on the
model's device and moved to the other platform with
``torch.export.passes.move_to_device_pass``; an entry that does not export
or move is listed in ``skipped`` with its error and stays live, as in JAX.
Loading imports the op registrations first.  A package entry that fails to
deserialize or to run raises; only a signature miss runs live.  The cuda
entries are recorded for ``cuda:0``; a serving-mesh replica on another
card runs them moved to its own card (``move_to_device_pass``, at its first
call of each).
"""

from __future__ import annotations

import contextlib
import functools
import io
import itertools
import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

# the op registrations (crdr::*) an exported program calls
from ..ops import gdn as _k3  # noqa: F401
from ..ops import lane_decode as _k2  # noqa: F401
from ..ops import lane_encode as _e1  # noqa: F401
from ..ops import slice_transform as _k1  # noqa: F401

__all__ = ["ExeDispatch", "AotRecorder", "AotPackage", "export_package",
           "load_package", "record_serving_roundtrip", "MANIFEST", "program",
           "aot_counts"]

MANIFEST = "manifest.json"
FORMAT = "crdr-aot-torch-v1"
_local = threading.local()      # this thread's dispatch depth
_versions = itertools.count(1)  # a model's tensors get a new one each setup


# ---------------- the model side --------------------------------------------

class AotSlot:
    """The AOT state a model shares with its serving-mesh replicas (a
    replica is a shallow copy, so it holds the same slot): the package, the
    recorder, one ``ExeDispatch`` a program name."""

    def __init__(self):
        self.package: Optional[AotPackage] = None
        self.recorder: Optional[AotRecorder] = None
        self.dispatches: Dict[str, ExeDispatch] = {}
        self.lock = threading.Lock()

    def dispatch(self, name: str) -> "ExeDispatch":
        with self.lock:
            if name not in self.dispatches:
                self.dispatches[name] = ExeDispatch(self, name)
            return self.dispatches[name]


def program(name: str):
    """Decorator: the method is the codec device program ``name``.  It runs
    through the model's ``ExeDispatch`` of that name when a package or a
    recorder is attached (``model._aot``), else it is a plain call."""
    def wrap(fn):
        @functools.wraps(fn)
        def dispatch(self, *args):
            slot = getattr(self, "_aot", None)
            if slot is None or (slot.package is None
                                and slot.recorder is None) \
                    or getattr(_local, "depth", 0):
                return fn(self, *args)
            return slot.dispatch(name)(self, fn, args)
        dispatch.program = name
        return dispatch
    return wrap


@contextlib.contextmanager
def _inside():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def model_tensors(owner) -> Tuple[int, Dict[str, torch.Tensor]]:
    """(version, {name: tensor}) of every model tensor a program may read
    (``owner._aot_tensors()``), cached until the next ``codec_setup``."""
    cached = owner.__dict__.get("_aot_tensor_cache")
    if cached is None:
        cached = (next(_versions), owner._aot_tensors())
        owner.__dict__["_aot_tensor_cache"] = cached
    return cached


# ---------------- signatures ------------------------------------------------

def _dev(d: torch.device) -> str:
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _numerics() -> List[bool]:
    b = torch.backends
    return [bool(b.cudnn.allow_tf32), bool(b.cuda.matmul.allow_tf32),
            bool(b.cudnn.deterministic), bool(b.cudnn.benchmark),
            bool(b.cudnn.enabled), torch.is_grad_enabled()]


def _leaf_sig(x) -> list:
    if isinstance(x, torch.Tensor):
        return ["t", list(x.shape), str(x.dtype).replace("torch.", ""),
                _dev(x.device)]
    if x is None or isinstance(x, (bool, int, float, str)):
        return ["py", type(x).__name__, x]
    raise TypeError(f"aot: a program argument of type {type(x).__name__}")


def _key_str(name: str, owner, args: Tuple) -> str:
    """Stable signature of a dispatch (module doc), computed identically at
    record and serve time: a match means the exported program takes the
    call's arguments, under the same numerics."""
    leaves, spec = pytree.tree_flatten(args)
    return json.dumps([name, _dev(torch.device(owner.device)), _numerics(),
                       str(spec), [_leaf_sig(v) for v in leaves]])


def _moved_key(key: str, device: str, src: Optional[str] = None) -> str:
    """The key of the same call with the model, and every tensor on ``src``
    (every tensor when None), on ``device``."""
    name, _, flags, spec, leaves = json.loads(key)
    leaves = [v[:3] + [device] if v[0] == "t" and src in (None, v[3]) else v
              for v in leaves]
    return json.dumps([name, device, flags, spec, leaves])


def _tensor_sig(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


# ---------------- dispatch --------------------------------------------------

class ExeDispatch:
    """One named codec device program: the live method, or a loaded
    package's exported program matched on the call signature.  Counts
    ``aot_hits`` (package runs) and ``aot_misses`` (live runs while a package
    is attached)."""

    def __init__(self, slot: AotSlot, name: str):
        self._slot = slot
        self.name = name
        self.aot_hits = 0
        self.aot_misses = 0

    def __call__(self, owner, fn: Callable, args: Tuple):
        slot = self._slot
        pkg = slot.package
        key = _key_str(self.name, owner, args)
        if pkg is not None:
            call = pkg.lookup(key, owner)
            with slot.lock:
                if call is None:
                    self.aot_misses += 1
                else:
                    self.aot_hits += 1
            if call is not None:
                with _inside():
                    return call(owner, args)
        rec = slot.recorder
        with _inside():
            if rec is not None:
                return rec.record(key, self.name, owner, fn, args)
            return fn(owner, *args)


class _TensorsRead(TorchFunctionMode):
    """The model tensors (by identity) the torch functions of a call read."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        self._names = {id(t): n for n, t in tensors.items()}
        self.read = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for v in itertools.chain(args, kwargs.values()):
            for t in (v if isinstance(v, (list, tuple)) else (v,)):
                name = self._names.get(id(t))
                if name is not None:
                    self.read.add(name)
        return func(*args, **kwargs)


class AotRecorder:
    """Collects (program name, owner, method, concrete args, the model
    tensors it read) per distinct call signature.  Args are kept by
    reference until export (only their shapes, dtypes and devices matter
    there)."""

    def __init__(self):
        self.entries: Dict[str, Tuple[str, Any, Callable, Tuple, List[str]]] \
            = {}

    def record(self, key: str, name: str, owner, fn: Callable, args: Tuple):
        if key in self.entries:
            return fn(owner, *args)
        _, tensors = model_tensors(owner)
        with _TensorsRead(tensors) as seen:
            out = fn(owner, *args)
        self.entries[key] = (name, owner, fn, args,
                             [n for n in tensors if n in seen.read])
        return out


# ---------------- export ----------------------------------------------------

class _Program(torch.nn.Module):
    """A recorded method as a module: ``forward(tensors, args)`` runs it with
    the model's tensors replaced by ``tensors`` (by name), so they are
    inputs of the exported program and no weight is stored in it."""

    def __init__(self, owner, fn: Callable):
        super().__init__()
        object.__setattr__(self, "_owner", owner)  # not a submodule
        self._fn = fn

    def forward(self, tensors: Dict[str, torch.Tensor], args: Tuple):
        with self._owner._aot_swapped(tensors):
            return self._fn(self._owner, *args)


def _export(owner, fn: Callable, args: Tuple, names: List[str]):
    _, tensors = model_tensors(owner)
    used = {n: tensors[n] for n in names}
    with torch.no_grad(), _inside():
        ep = torch.export.export(_Program(owner, fn), (used, args),
                                 strict=False)
    held = sum(t.numel() * t.element_size()
               for t in itertools.chain(ep.state_dict.values(),
                                        ep.constants.values())
               if isinstance(t, torch.Tensor))
    if ep.state_dict or held > (1 << 20):
        raise RuntimeError(f"the program holds {held} bytes of tensors: a "
                           "model tensor it reads is not an input")
    ep._example_inputs = None  # else saved with it: the weights among them
    return ep


def _moved(ep, device):
    """The exported program with its tensors and device arguments on
    ``device`` (a device, or a map {device: device})."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(ep, device)


def _platform_device(platform: str) -> str:
    if platform == "cuda":
        return "cuda:0"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"aot: platform {platform!r}: cuda or cpu")


def export_package(model, out_dir: str,
                   platforms: Tuple[str, ...] = ("cuda", "cpu"),
                   logger=None) -> Dict[str, Any]:
    """Export every program recorded on ``model._aot.recorder`` into
    ``out_dir``, one ``.pt2`` a program and platform.  A program that will
    not export (or move to a platform) is listed in ``skipped`` with its
    error and stays on the live path at load time."""
    rec = model._aot.recorder
    assert rec is not None and rec.entries, \
        "arm an AotRecorder and run a serving roundtrip before exporting"
    os.makedirs(out_dir, exist_ok=True)
    entries: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []

    def skip(name, platform, e):
        skipped.append({"name": name, "platform": platform,
                        "error": f"{type(e).__name__}: {e}"})
        if logger:
            logger.warning(f"aot: skipping {name} ({platform}): {e}")

    for i, (key, (name, owner, fn, args, names)) in enumerate(
            sorted(rec.entries.items(), key=lambda kv: kv[1][0])):
        _, tensors = model_tensors(owner)
        try:
            ep = _export(owner, fn, args, names)
        except Exception as e:  # noqa: BLE001 — skip, keep the live path
            for p in platforms:
                skip(name, p, e)
            continue
        home = torch.device(owner.device).type
        for p in platforms:
            try:
                dev = _platform_device(p)
                moved = ep if p == home else _moved(ep, dev)
                buf = io.BytesIO()
                torch.export.save(moved, buf)
                blob = buf.getvalue()
            except Exception as e:  # noqa: BLE001 — skip, keep the live path
                skip(name, p, e)
                continue
            fname = f"{i:03d}_{name}.{p}.pt2"
            with open(os.path.join(out_dir, fname), "wb") as f:
                f.write(blob)
            entries.append({
                "name": name, "platform": p,
                "key": key if p == home else _moved_key(key, dev),
                "file": fname, "bytes": len(blob),
                "tensors": [[n] + _tensor_sig(tensors[n]) for n in names]})
    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "model_class": type(model).__name__,
        "wire_format": getattr(model, "wire_format", "compressai"),
        "entries": entries,
        "skipped": skipped,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def record_serving_roundtrip(model, batch: int, height: int, width: int,
                             rate_ind: float = 0.0, beta: float = 0.0
                             ) -> AotRecorder:
    """Arm (or reuse) the model's recorder and drive one full compress +
    decompress round trip at the given serving shape, capturing every
    device program the shape needs.  Call once per (batch, H, W) bucket the
    deployment will serve."""
    if model._aot.recorder is None:
        model._aot.recorder = AotRecorder()
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (batch, height, width, 3), dtype=np.uint8)
    kw = {"rate_ind": float(rate_ind)} if model.use_rate else {}
    encs = model.compress_batch(imgs, **kw)
    dkw = {"beta": float(beta)} if model.use_beta else {}
    model.decompress_batch([e["string_list"] for e in encs], **dkw)
    return model._aot.recorder


# ---------------- load ------------------------------------------------------

_modules: Dict[Tuple, torch.nn.Module] = {}  # by file, size, mtime, device
_modules_lock = threading.Lock()


def _load_module(path: str, move: Optional[Dict[str, str]] = None
                 ) -> torch.nn.Module:
    """The unlifted module of a ``.pt2`` file, deserialized once a process
    (several models may load one package), moved by ``move`` ({recorded
    device: device}, ``move_to_device_pass``) when given; a file that fails
    to load raises."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns,
           json.dumps(move))
    with _modules_lock:
        mod = _modules.get(key)
        if mod is None:
            ep = torch.export.load(path)
            mod = (_moved(ep, move) if move else ep).module()
            _modules[key] = mod
    return mod


class _Loaded:
    """One deserialized program: the unlifted module, and the model tensors
    it takes (names, shapes, dtypes)."""

    def __init__(self, path: str, tensors: List[list],
                 move: Optional[Dict[str, str]] = None):
        self.module = _load_module(path, move)
        self.names = [t[0] for t in tensors]
        self.sigs = [t[1:] for t in tensors]
        self._fits: Dict[int, bool] = {}

    def fits(self, owner) -> bool:
        version, tensors = model_tensors(owner)
        ok = self._fits.get(version)
        if ok is None:
            ok = all(n in tensors and _tensor_sig(tensors[n]) == s
                     for n, s in zip(self.names, self.sigs))
            self._fits[version] = ok
        return ok

    def __call__(self, owner, args: Tuple):
        _, tensors = model_tensors(owner)
        return self.module({n: tensors[n] for n in self.names}, args)


class AotPackage:
    """Loaded package: lazy-deserializing signature -> exported-program
    map."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} package "
                             f"({self.manifest.get('format')!r})")
        self._entries: Dict[str, Dict] = {e["key"]: e
                                          for e in self.manifest["entries"]}
        self._calls: Dict[str, _Loaded] = {}
        self._lock = threading.Lock()

    def lookup(self, key: str, owner) -> Optional[_Loaded]:
        """The program of ``key`` when the package has it and it takes the
        owner's tensors, else None.  A call on another card than the one
        the package was recorded for (a serving-mesh replica on ``cuda:1``)
        takes the recorded card's program, moved to its own at first use.
        A file that fails to load raises."""
        call = self._calls.get(key)
        if call is None:
            entry, move = self._entries.get(key), None
            dev = _dev(torch.device(owner.device))
            if entry is None and dev.startswith("cuda:") \
                    and dev != _platform_device("cuda"):
                home = _platform_device("cuda")
                entry = self._entries.get(_moved_key(key, home, dev))
                move = {home: dev, "cuda": dev}
            if entry is None:
                return None
            with self._lock:
                call = self._calls.get(key)
                if call is None:
                    call = _Loaded(os.path.join(self.path, entry["file"]),
                                   entry["tensors"], move)
                    self._calls[key] = call
        return call if call.fits(owner) else None


def load_package(model, path: str, logger=None) -> AotPackage:
    """Attach a package to a model (and its serving-mesh replicas): matching
    codec dispatches run the exported programs, everything else stays live.
    Warns on provenance mismatches (model class / wire format / torch
    version) instead of refusing: the signature is what gates a program."""
    pkg = AotPackage(path)
    man = pkg.manifest
    for field, have in (("model_class", type(model).__name__),
                        ("wire_format", getattr(model, "wire_format",
                                                "compressai")),
                        ("torch_version", torch.__version__)):
        want = man.get(field)
        if want != have and logger:
            logger.warning(
                f"aot package {field} mismatch: package={want} live={have}")
    model._aot.package = pkg
    return pkg


def aot_counts(model) -> Dict[str, Dict[str, int]]:
    """{program name: {"hits": n, "misses": n}} of the model's dispatches
    (its replicas' included)."""
    return {n: {"hits": d.aot_hits, "misses": d.aot_misses}
            for n, d in sorted(model._aot.dispatches.items())}
