"""The port's evaluation metrics (``metrics/{bd,fid,inception,dists}.py``)
against the JAX package's, on the CPU.

* BD-rate / BD-quality (Akima and poly3, both orientations, unsorted and
  repeated points) and the FID host math (the HiFiC patch crop, the
  statistics, the Frechet distance, the whole protocol on a cheap
  extractor): exactly equal, since both run the same numpy / scipy code.
* Inception: one seeded state dict in pytorch-fid's layout
  (``seeded_inception_state``) loaded by each package (JAX through
  ``load_inception_params``, the port with ``load_state_dict``); the
  bilinear resize to 299 against ``jax.image.resize``, edges included
  (atol 2e-4 on [0, 255]); each of the eleven Mixed blocks on the same input
  (rtol 1e-4, atol 1e-4 of the block's largest output); the whole net at
  batch 2 (features within 1e-4 of their largest).
* DISTS at 64x64: one seeded state dict in the official layout through each
  package's ``load_dists_params`` (distance within 1e-5, every stage's
  features within 1e-4 of their largest).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.metrics import bd as jbd
from crdr_tpu.metrics import dists as jdists
from crdr_tpu.metrics import fid as jfid
from crdr_tpu.metrics import inception as jinc
from crdr_tpu_torch.metrics import bd, fid
from crdr_tpu_torch.metrics.dists import (DISTS, load_dists_params,
                                          seeded_dists_state)
from crdr_tpu_torch.metrics.inception import (load_inception,
                                              seeded_inception_state)
from tests.torch_pairs import one_torch_thread  # noqa: F401

# ---------------- BD ----------------------------------------------------------


def _curves(seed):
    rng = np.random.default_rng(seed)
    r = np.sort(rng.uniform(0.1, 2.0, 9))
    m = 28 + 6 * np.log(r) + rng.normal(0, 0.05, 9)
    r2 = r * rng.uniform(0.85, 1.05, 9)
    m2 = m + rng.normal(0.1, 0.1, 9)
    return r, m, r2, m2


@pytest.mark.parametrize("method", ["akima", "poly3"])
@pytest.mark.parametrize("higher_better", [True, False])
def test_bd_equal_to_jax(method, higher_better):
    for seed in range(4):
        r, m, r2, m2 = _curves(seed)
        if not higher_better:
            m, m2 = 1.0 / m, 1.0 / m2
        args = (r, m, r2, m2, higher_better, method)
        assert bd.bd_rate(*args) == jbd.bd_rate(*args)
        assert bd.bd_quality(*args) == jbd.bd_quality(*args)
    # unsorted, with a repeated operating point
    r, m, r2, m2 = _curves(9)
    idx = np.r_[3, 0, 8, 1, 1, 5, 2, 7, 6, 4]
    assert bd.bd_rate(r[idx], m[idx], r2, m2, method=method) == \
        jbd.bd_rate(r[idx], m[idx], r2, m2, method=method)


def test_bd_refusals_as_jax():
    r, m, r2, m2 = _curves(1)
    for args, kw in [((r[:3], m[:3], r, m), {}), ((r, m, -r, m), {}),
                     ((r, m, r, m + 100.0), {}),
                     ((r, m, r, m), {"method": "spline9"})]:
        with pytest.raises(ValueError) as mine:
            bd.bd_rate(*args, **kw)
        with pytest.raises(ValueError) as ref:
            jbd.bd_rate(*args, **kw)
        assert str(mine.value) == str(ref.value)

# ---------------- FID host math --------------------------------------------------


@pytest.mark.parametrize("shape", [(512, 768, 3), (300, 260, 3),
                                   (200, 900, 3), (256, 300, 3)])
def test_hific_patches_equal_to_jax(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    a = fid.crop_hific_fid_patches(img)
    b = jfid.crop_hific_fid_patches(img)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_fid_statistics_and_distance_equal_to_jax():
    rng = np.random.default_rng(1)
    f1 = rng.standard_normal((80, 24))
    f2 = rng.standard_normal((70, 24)) * 1.2 + 0.3
    mu, s = fid.activation_statistics(f1)
    jmu, js = jfid.activation_statistics(f1)
    assert np.array_equal(mu, jmu) and np.array_equal(s, js)
    assert fid.compute_fid(f1, f2) == jfid.compute_fid(f1, f2)
    assert fid.compute_fid(f1, f1) == pytest.approx(0.0, abs=1e-6)
    # a singular product takes the eps-offset branch in both
    g = np.ones((10, 24))
    assert fid.compute_fid(g, f2[:10]) == jfid.compute_fid(g, f2[:10])


def test_fid_protocol_equal_to_jax():
    rng = np.random.default_rng(2)
    reals = [rng.integers(0, 256, (384, 512, 3), dtype=np.uint8)
             for _ in range(6)]
    fakes = [np.clip(r.astype(np.int32) + rng.integers(-30, 30, r.shape),
                     0, 255).astype(np.uint8) for r in reals]
    kw = dict(extractor=fid.mean_pool_extractor, batch_size=7)
    mine = fid.fid_from_image_lists(iter(reals), iter(fakes), **kw)
    ref = jfid.fid_from_image_lists(iter(reals), iter(fakes), **kw)
    assert mine == ref and mine > 0

# ---------------- Inception ----------------------------------------------------


@pytest.fixture(scope="module")
def inception():
    state = seeded_inception_state(3)
    return load_inception(state), jinc.load_inception_params(state)["params"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("hw", [(256, 256), (64, 48), (299, 299)])
def test_resize_to_299_matches_jax(hw):
    x = np.random.default_rng(4).uniform(0, 255, (2,) + hw + (3,)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear")
    got = torch.nn.functional.interpolate(_nchw(x), size=(299, 299),
                                          mode="bilinear",
                                          align_corners=False)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0,
                               atol=2e-4)


_BLOCKS = [("Mixed_5b", jinc.InceptionA(32), 192, 35),
           ("Mixed_5c", jinc.InceptionA(64), 256, 35),
           ("Mixed_5d", jinc.InceptionA(64), 288, 35),
           ("Mixed_6a", jinc.InceptionB(), 288, 35),
           ("Mixed_6b", jinc.InceptionC(128), 768, 17),
           ("Mixed_6c", jinc.InceptionC(160), 768, 17),
           ("Mixed_6d", jinc.InceptionC(160), 768, 17),
           ("Mixed_6e", jinc.InceptionC(192), 768, 17),
           ("Mixed_7a", jinc.InceptionD(), 768, 17),
           ("Mixed_7b", jinc.InceptionE(), 1280, 8),
           ("Mixed_7c", jinc.InceptionE(use_max_pool=True), 2048, 8)]


@pytest.mark.parametrize("name,flax,ch,hw", _BLOCKS,
                         ids=[b[0] for b in _BLOCKS])
def test_inception_block_matches_flax(inception, name, flax, ch, hw):
    port, params = inception
    x = np.maximum(np.random.default_rng(5).standard_normal(
        (2, hw, hw, ch)), 0).astype(np.float32)
    ref = np.asarray(flax.apply({"params": params[name]}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(getattr(port, name)(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_inception_features_match_flax(inception):
    port, params = inception
    x = np.random.default_rng(6).uniform(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, a: jinc.InceptionV3Features().apply(
        {"params": p}, a))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(_nchw(x)).numpy()
    assert got.shape == ref.shape == (2, 2048)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert np.abs(got[0] - got[1]).max() > 1e-3 * np.abs(ref).max()


def test_inception_loads_pytorch_fid_names_only():
    state = seeded_inception_state(0)
    assert "fc.weight" in state and "Mixed_7c.branch_pool.bn.running_var" \
        in state
    load_inception({k: v for k, v in state.items()
                    if not k.endswith("num_batches_tracked")})
    bad = dict(state)
    bad.pop("Mixed_5b.branch1x1.conv.weight")
    with pytest.raises(KeyError, match="missing"):
        load_inception(bad)

# ---------------- DISTS ----------------------------------------------------------


def test_dists_matches_flax():
    state = seeded_dists_state(7)
    jvars = jdists.load_dists_params(state)
    port = DISTS()
    port.load_state_dict(load_dists_params(state))
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    ref = np.asarray(jdists.DISTS().apply(jvars, jnp.asarray(x),
                                          jnp.asarray(y)))
    with torch.no_grad():
        got = port(_nchw(x), _nchw(y)).numpy()
        feats = port.vgg(_nchw(x))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    jfeats = jdists.VGG16Stages().apply({"params": jvars["params"]["vgg"]},
                                        jnp.asarray(x))
    for a, b in zip(feats, jfeats):
        b = np.asarray(b)
        np.testing.assert_allclose(_nhwc(a), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    with torch.no_grad():
        same = port(_nchw(x), _nchw(x)).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-6)
    assert (got > 1e-3).all()
