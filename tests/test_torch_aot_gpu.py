"""The kernels' registered ops and an AOT serving package on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_aot_gpu.py -m gpu

Without a GPU its tests skip (what they hold is the card's).

* ``torch.library.opcheck`` of K1, K2, K3 and E1's ops (``crdr::*``) on
  CUDA tensors: schema, fake (meta) implementation, autograd registration
  and dispatch under ``torch.compile``'s tracing, each against the op's own
  eager result;
* K3's backward (``crdr::gdn_backward``) bit-equal to autograd of the
  plain twin ``gdn_plain`` with TF32 off, the gradient GDN had before its
  kernel became an op;
* a package of ``config/crdr_throughput.yaml`` at full width, recorded on
  the card at 2x64x64 on both wires (E1 encoding the device wire) and
  exported for cuda and cpu: a fresh model on the same weights serves from
  it with streams byte-equal and decodes equal to the live model's, hits
  on encode and decode, and the same K1 / K2 / E1 launch counts;
* with two cards or more, a serving mesh with a replica on ``cuda:1``
  serves from that package (its programs moved to the replica's card).

``op_args`` (each op's arguments, seeded) and ``gdn_grads_by_autograd``
also serve the CPU tests of ``tests/test_torch_aot.py``.
"""

import os

import numpy as np
import pytest

import torch

from crdr_tpu_torch.ops.device_rans import (encode_grid, encode_table,
                                            lane_positions)
from crdr_tpu_torch.ops.lane_decode import prepare_lane_table
from crdr_tpu_torch.runtime import aot  # noqa: F401  (registers crdr::*)
from crdr_tpu_torch.runtime.lane_rans import lane_encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("slice_transform", "lane_decode_round", "gdn", "lane_encode")


def op_args(name: str, device="cpu") -> tuple:
    """Seeded arguments of the op ``crdr::name`` on ``device``, at shapes
    the kernel takes (K1: channels multiples of 8, K3: 64 channels)."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    if name == "slice_transform":
        args = (rand(2, 3, 4, 24), rand(2, 5, 5, 24, 16).bfloat16(),
                rand(2, 16), rand(2, 5, 5, 16, 8).bfloat16(), rand(2, 8),
                rand(2, 3, 3, 8, 8).bfloat16(), rand(2, 8), 1)
    elif name == "gdn":
        args = (rand(2, 64, 3, 4), torch.rand(64, generator=g) + 0.5,
                torch.rand(64, 64, generator=g) * 0.05, True)
    else:
        rng = np.random.default_rng(1)
        cdf = np.stack([np.r_[0, np.sort(rng.choice(
            np.arange(1, 65536), 6, replace=False)), 65536]
            for _ in range(3)]).astype(np.int32)
        ln, off = np.full(3, 8, np.int32), np.full(3, -3, np.int32)
        m, k = 40, 8
        sym = rng.integers(-3, 4, (2, m)).astype(np.int32)
        idx = rng.integers(0, 3, (2, m)).astype(np.int32)
        if name == "lane_encode":  # symbols in a produced order
            grid = torch.from_numpy(encode_grid([0, m], k))
            perm = torch.from_numpy(rng.permutation(m))
            args = (torch.from_numpy(sym), torch.from_numpy(idx), grid,
                    lane_positions(grid, perm), encode_table(cdf, ln, off),
                    torch.from_numpy(ln), torch.from_numpy(off))
        else:
            words = np.zeros((2, k, 16), np.int32)
            for i in range(2):
                w = lane_encode(sym[i], idx[i], np.array([0, m]), k, cdf, ln,
                                off)[0]
                words[i, :, :w.shape[1]] = w
            t = prepare_lane_table(cdf, ln, off)
            w = torch.from_numpy(words)
            st = (w[..., 0].long() << 16) | w[..., 1].long()
            args = (st, torch.full((2, k), 2, dtype=torch.int32), w,
                    torch.from_numpy(idx), t.cdf, t.cdf_len, t.cdf_off,
                    t.buf, t.bits, m)
    args = tuple(a.to(device) if torch.is_tensor(a) else a for a in args)
    if name == "gdn":  # the op's gradient is checked too
        args = (args[0].requires_grad_(), args[1].requires_grad_()) + args[2:]
    return args


def gdn_grads_by_autograd(grad, x, beta, gamma, inverse):
    """The gradients of x, beta and gamma as autograd of ``gdn_plain`` gives
    them, TF32 off."""
    from crdr_tpu_torch.ops.gdn import gdn_plain

    leaves = [t.detach().requires_grad_() for t in (x, beta, gamma)]
    with torch.enable_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False):
        return torch.autograd.grad(gdn_plain(*leaves, inverse), leaves, grad)


def gdn_backward_check(device, inverse, shape=(2, 192, 8, 12)):
    """The op's gradients equal ``gdn_grads_by_autograd``'s bit for bit."""
    from crdr_tpu_torch.ops.gdn import gdn

    g = torch.Generator().manual_seed(4)
    c = shape[1]
    x, grad = (torch.randn(*shape, generator=g).to(device) for _ in "xg")
    beta = (torch.rand(c, generator=g) + 0.5).to(device)
    gamma = (torch.rand(c, c, generator=g) * 0.05).to(device)
    leaves = [t.clone().requires_grad_() for t in (x, beta, gamma)]
    got = torch.autograd.grad(gdn(*leaves, inverse), leaves, grad)
    want = gdn_grads_by_autograd(grad, x, beta, gamma, inverse)
    for name, a, b in zip(("x", "beta", "gamma"), got, want):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the ops' CUDA implementations are "
                    "the kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_opcheck_on_gpu(cuda, name):
    torch.library.opcheck(getattr(torch.ops.crdr, name).default,
                          op_args(name, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_is_autograd_of_the_twin_on_gpu(cuda, inverse):
    gdn_backward_check(cuda, inverse, (2, 192, 32, 48))


def _model(cuda):
    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    model = build_comp_model(cfg, device=cuda)
    with torch.no_grad():  # the y tables carry the rate (chip_smoke.py)
        for st in model.net.context_model.scale_slice_transforms:
            st.model[4].bias += 8.0
    return model


@pytest.mark.gpu
def test_package_round_trip_on_gpu(cuda, tmp_path):
    from crdr_tpu_torch.ops.lane_decode import lane_decode_round
    from crdr_tpu_torch.ops.lane_encode import lane_encode_rounds
    from crdr_tpu_torch.ops.slice_transform import slice_transform
    from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                            load_package,
                                            record_serving_roundtrip)

    live, fresh = _model(cuda), _model(cuda)
    kernels = (slice_transform, lane_decode_round, lane_encode_rounds)
    wires = ("compressai", "device")
    for wire in wires:
        live.opt["wire_format"] = wire
        live.codec_setup()
        record_serving_roundtrip(live, 2, 64, 64, rate_ind=2.0, beta=2.56)
    man = export_package(live, str(tmp_path / "pkg"))
    assert not [s for s in man["skipped"] if s["platform"] == "cuda"]
    load_package(fresh, str(tmp_path / "pkg"))
    x = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), np.uint8)
    for wire in wires:
        for m in (live, fresh):
            m.opt["wire_format"] = wire
            m.codec_setup()
        runs = []
        for m in (live, fresh):
            for k in kernels:
                k.launches = 0
            enc = m.compress_batch(x, rate_ind=2.0)
            dec = m.decompress_batch([e["string_list"] for e in enc],
                                     beta=2.56)
            runs.append((enc, dec, [k.launches for k in kernels]))
        (e_l, d_l, n_l), (e_p, d_p, n_p) = runs
        assert [e["string_list"] for e in e_l] == \
            [e["string_list"] for e in e_p]
        np.testing.assert_array_equal(d_l[0], d_p[0])
        np.testing.assert_array_equal(d_l[2], d_p[2])
        assert n_l == n_p and n_l[0] == 6 * live.num_slices
        counts = aot_counts(fresh)
        assert counts["encode_latents"]["hits"] and \
            counts["decode_image"]["hits"]


@pytest.mark.gpu
def test_package_serves_a_replica_on_a_second_card(cuda, tmp_path):
    """A package recorded on cuda:0 serves a serving mesh whose second
    replica is on cuda:1: each replica's shard hits, and the streams equal
    one device's live streams."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs: a replica on cuda:1")
    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.runtime.aot import (aot_counts, export_package,
                                            load_package,
                                            record_serving_roundtrip)
    from crdr_tpu_torch.utils.config import Config

    live = _model(cuda)
    live.codec_setup()
    record_serving_roundtrip(live, 2, 64, 64, rate_ind=2.0, beta=2.56)
    export_package(live, str(tmp_path / "pkg"), platforms=("cuda",))
    live._aot.recorder = None
    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    cfg["serving_devices"] = 2
    mesh = build_comp_model(cfg, device="cuda:0")
    mesh.load_state_dict(live.state_dict())
    mesh.codec_setup(["cuda:0", "cuda:1"])
    load_package(mesh, str(tmp_path / "pkg"))
    x = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3), np.uint8)
    want = live.compress_batch(x, rate_ind=2.0)
    got = mesh.compress_batch(x, rate_ind=2.0)
    assert [e["string_list"] for e in want] == \
        [e["string_list"] for e in got]
    counts = aot_counts(mesh)
    assert counts["encode_latents"]["hits"] == 2, counts
    _, _, y_m = mesh.decompress_batch([e["string_list"] for e in got],
                                      beta=2.56)
    np.testing.assert_array_equal(y_m, np.concatenate(
        [e["y_hat"] for e in want]))
