"""The evaluation slice's kernels and metric networks on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_eval_gpu.py -m gpu

Without a GPU its tests skip (the kernels have no CPU mode; the CPU tests of
the modules are ``tests/test_torch_{cheng20,hific,metrics,eval_cli}.py``).

* The sweep's shapes: ``crdr_throughput.yaml`` (seeded init, y scales
  raised) on the device wire with E1, one image repeated at 17 qualities in
  one ``compress_batch`` / ``decompress_batch``: the first K1, K2 and E1
  call at N 17 against its plain twin (K1 within 2e-3, K2 and E1 exactly),
  every stream equal to the image's batch-1 stream at its quality.
* K3 inside the Cheng20 hyperprior at full width (N 192), batch 4 of
  128x192 images: 6 launches a round trip, every call within 2e-5 |plain| +
  1e-6 of ``gdn_plain``, the decode giving the encoder's symbols.
* Inception (pool3 features of 4 patches, within 1e-3 of the largest) and
  DISTS (within 1e-4) on the card against the CPU, on seeded weights.
"""

import contextlib
import importlib
import os

import numpy as np
import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_ATOL, K3_RTOL, K3_ATOL = 2e-3, 2e-5, 1e-6
SITES = {"slice_transform": "crdr_tpu_torch.ops.charm_uniform",
         "lane_decode_round": "crdr_tpu_torch.models.codec_devicewire",
         "lane_encode_rounds": "crdr_tpu_torch.models.codec_devicewire",
         "gdn": "crdr_tpu_torch.nn.norm"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def calls(name):
    """Every call of the kernel wrapper ``name`` made by the codec within
    the block: [(cloned arguments, output)]."""
    mod = importlib.import_module(SITES[name])
    real, kept = getattr(mod, name), []

    def wrapper(*args):
        out = real(*args)
        kept.append((tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args), out))
        return out

    setattr(mod, name, wrapper)
    try:
        yield kept
    finally:
        setattr(mod, name, real)


def _flagship(cuda):
    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    cfg.update(wire_format="device", device_wire_encoder="device")
    model = build_comp_model(cfg, device=cuda)
    with torch.no_grad():
        for st in model.net.context_model.scale_slice_transforms:
            st.model[4].bias += 8.0
        ca = model.net.encoder.interp_ca_list[-1]  # the rate matters
        for q in range(ca.weight.shape[0]):
            ca.weight[q] = torch.log(torch.expm1(torch.tensor(2.0 ** q)))
    model.codec_setup()
    return model


@pytest.mark.gpu
def test_sweep_kernels_at_n17_on_gpu(cuda):
    from crdr_tpu_torch.ops import device_rans
    from crdr_tpu_torch.ops.slice_transform import slice_transform_plain

    model = _flagship(cuda)
    qs = np.arange(17, dtype=np.float32) * 0.25
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1, 128, 192, 3), dtype=np.uint8)
    with calls("slice_transform") as k1, calls("lane_encode_rounds") as e1:
        encs = model.compress_batch(np.repeat(img, 17, axis=0), rate_ind=qs)
    with calls("lane_decode_round") as k2:
        _, _, y_hat = model.decompress_batch(
            [e["string_list"] for e in encs], beta=3.84)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in encs]))
    (x, *stacks, idx), out = k1[0]
    assert x.shape[0] == 17
    plain = slice_transform_plain(x, *(t[idx] for t in stacks))
    assert float((out - plain).abs().max()) <= K1_ATOL
    args, out = e1[0]
    assert args[0].shape[0] == 17
    # the twin takes the wrapper's arguments up to perm (not pos, etab)
    for a, b in zip(out, device_rans.lane_encode_rounds(*args[:8])):
        assert torch.equal(a, b)
    (st, pt, words, idx, table, m), out = k2[0]
    assert st.shape[0] == 17
    ref = device_rans.lane_decode_round_instep(
        st, pt, words, idx, table.cdf, table.cdf_len, table.cdf_off, m)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for q in (0, 7, 16):
        one = model.compress(img, rate_ind=float(qs[q]))
        assert one["string_list"] == encs[q]["string_list"]


@pytest.mark.gpu
def test_cheng20_k3_on_gpu(cuda):
    import chip_smoke

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.ops import gdn as k3
    from crdr_tpu_torch.ops.gdn import gdn_plain
    from crdr_tpu_torch.utils.config import ConfigDict

    model = build_comp_model(ConfigDict(chip_smoke.family_config(
        "cheng20")), device=cuda)
    with torch.no_grad():
        model.net.hyperdecoder.c5.bias[192:] += 4.0
    model.codec_setup()
    imgs = np.random.default_rng(1).integers(0, 256, (4, 128, 192, 3),
                                             dtype=np.uint8)
    k3.gdn.launches = 0
    with calls("gdn") as seen:
        encs = model.compress_batch(imgs)
        _, _, y_hat = model.decompress_batch([e["string_list"]
                                              for e in encs])
    assert k3.gdn.launches == 6 and len(seen) == 6
    assert sorted(a[3] for a, _ in seen) == [False] * 3 + [True] * 3
    for args, out in seen:
        ref = gdn_plain(*args)
        assert float(((out - ref).abs() / (K3_RTOL * ref.abs() + K3_ATOL))
                     .max()) <= 1.0
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in encs]))


@pytest.mark.gpu
def test_inception_and_dists_card_vs_cpu(cuda):
    from crdr_tpu_torch.metrics.dists import (DISTS, load_dists_params,
                                              seeded_dists_state)
    from crdr_tpu_torch.metrics.inception import (f32_numerics,
                                                  load_inception,
                                                  seeded_inception_state)

    state = seeded_inception_state(0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 255, (4, 3, 256, 256)).astype(
        np.float32))
    with f32_numerics():
        ref = load_inception(state, "cpu")(x)
        got = load_inception(state, cuda)(x.to(cuda)).cpu()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
    vals = []
    a = torch.from_numpy(rng.uniform(0, 1, (1, 3, 128, 128)).astype(
        np.float32))
    b = (a + 0.1 * torch.randn(a.shape, generator=torch.Generator()
                               .manual_seed(3))).clamp(0, 1)
    for dev in ("cpu", cuda):
        mod = DISTS()
        mod.load_state_dict(load_dists_params(seeded_dists_state(0)))
        with f32_numerics():
            vals.append(float(mod.to(dev)(a.to(dev), b.to(dev))[0]))
    assert abs(vals[0] - vals[1]) <= 1e-4
