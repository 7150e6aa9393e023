"""GDN at ``transform_dtype: bfloat16`` against the JAX package, on the CPU.

JAX's bf16 GDN is the einsum composite of ``crdr_tpu/nn/norm.py`` (its
Pallas kernel cannot store bf16, and it is off unless ``CRDR_PALLAS=1``),
each step rounded to bf16.  The port's twin (``ops/gdn.py::gdn_plain``) runs
the same steps; K3's bf16 mode runs them on the card
(``tests/test_torch_gdn_gpu.py``).  Inputs are numpy-seeded, gamma
non-symmetric.

* The reparameterization of bf16 ``beta`` / ``gamma`` (values below the
  bound included): bit-equal to JAX's ``NonNegativeParam``.
* GDN / IGDN with bf16 parameters and input, the port's module against
  flax's: at most 2 bf16 ulps apart, on at most 1e-3 of the elements (the
  two 1x1 products sum in f32 in other orders, so a sum may round to the
  neighbouring bf16 value, and the rsqrt and product after it carry that
  on; the share apart is printed).
* The premise of K3's bf16 mode on tensor cores: an output whose f32 sum
  was taken in any order a tensor core may take (16-term chunks added in
  order, reversed, pairwise, an f32 accumulation that truncates toward
  zero at each add) is the composite of a sum within 1 ulp of the twin's
  (``bf16_unexplained`` 0), at every channel count the kernel takes; a
  transposed gamma leaves elements unexplained.
* The wrapper refuses a mix of dtypes, naming them.
* ``HyperpriorModel`` from ``config/balle18_mean_scale.yaml`` and Cheng20
  (``chip_smoke.py::family_config``) at tiny widths, weights JAX -> port
  through ``export_state_dict``, both at bf16:
  - the analysis (y, z) and the synthesis against JAX's
    ``_apply_encode_latents`` / ``_apply_decode`` at bf16, within a
    relative L2 error of ``REL_L2``, about twice the largest error seen
    (Balle18 y / z / image 4.6e-3 / 7.5e-3 / 3.3e-3, Cheng20 7.7e-3 /
    1.1e-2 / 1.4e-2): bf16's epsilon is 3.9e-3, each layer rounds, and the
    two frameworks round at other places (XLA keeps a conv's bias and
    activation in f32 where PyTorch rounds each; the deeper Cheng20 stacks
    more of them);
  - on both wires, each package's stream decodes to the encoder's
    ``y_hat`` in both packages (the streams differ: y is rounded from
    bf16 transforms that round at other places);
  - the port's bf16 reconstruction within ``RECON_PSNR`` dB of its f32
    reconstruction of the same streams (the hyper-decoder and the entropy
    chain stay f32, so the y_hat decoded is the same).
"""

import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.models.codec_common import _apply_decode, _apply_encode_latents
from crdr_tpu.nn.norm import GDN as FlaxGDN
from crdr_tpu.nn.norm import NonNegativeParam as JaxNonNegativeParam
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.nn import GDN, NonNegativeParam
from crdr_tpu_torch.ops.gdn import (bf16_sum, bf16_tail, bf16_unexplained, gdn,
                                    gdn_plain)
from crdr_tpu_torch.utils.config import Config, ConfigDict
from test_torch_families import Y_CONV, config, edit, nchw, nhwc

BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BALLE18 = os.path.join(ROOT, "config", "balle18_mean_scale.yaml")
BALLE18_TINY = {"encoder": {"out_ch": 32, "main_ch": 16},
                "decoder": {"in_ch": 32, "main_ch": 16},
                "hyperencoder": {"in_ch": 32, "out_ch": 16, "main_ch": 16},
                "hyperdecoder": {"in_ch": 16, "out_ch": 64, "main_ch": 16},
                "entropy_model_z": {"channels": 16}}
ULPS, SHARE_APART = 2, 1e-3
REL_L2 = {"balle18": 1e-2, "cheng20": 3e-2}
RECON_PSNR = 40.0


def _ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps (same-sign values: their bit patterns' gap)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def _stored(rng, shape, low, high):
    """Stored (sqrt) parameters as numpy f32, with some below the bound."""
    v = np.sqrt(rng.uniform(low, high, shape)).astype(np.float32)
    v[rng.random(shape) < 0.05] = 1e-7
    return v


@pytest.mark.parametrize("minimum,shape", [(1e-6, (192,)), (0.0, (192, 192)),
                                           (0.0, (64, 64))])
def test_bf16_reparameterization_bit_equal_to_jax(minimum, shape):
    stored = _stored(np.random.default_rng(shape[0]), shape, 0.0, 0.5)
    want = np.asarray(JaxNonNegativeParam(minimum)(
        jnp.asarray(stored, jnp.bfloat16)).astype(jnp.float32))
    got = NonNegativeParam(minimum)(torch.from_numpy(stored).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("ch", [64, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_bf16_gdn_matches_flax(ch, inverse):
    rng = np.random.default_rng(ch + inverse)
    x = (rng.standard_normal((2, 16, 24, ch)) * 2).astype(np.float32)
    beta = _stored(rng, (ch,), 0.5, 2.0)
    gamma = _stored(rng, (ch, ch), 0.0, 2.0 / ch)  # non-symmetric
    params = {"params": {"beta": jnp.asarray(beta, jnp.bfloat16),
                         "gamma": jnp.asarray(gamma, jnp.bfloat16)}}
    want = FlaxGDN(ch, inverse=inverse).apply(params,
                                              jnp.asarray(x, jnp.bfloat16))
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(BF16)
    mod = GDN(ch, inverse=inverse).to(BF16)
    mod.load_state_dict({"beta": torch.from_numpy(beta).to(BF16),
                         "gamma": torch.from_numpy(gamma).to(BF16)})
    with torch.no_grad():
        got = mod(nchw(x).to(BF16)).permute(0, 2, 3, 1).contiguous()
    assert got.dtype == BF16
    apart = _ulps_apart(got, want)
    share = float((apart > 0).float().mean())
    print(f"GDN bf16 C {ch} {'inverse' if inverse else 'forward'}: "
          f"{share:.2e} of the elements apart from flax's, at most "
          f"{int(apart.max())} ulp")
    assert int(apart.max()) <= ULPS and share <= SHARE_APART
    # the twin is the composite, not the f32 product rounded once at the end
    f32 = gdn_plain(nchw(x).to(BF16).float(), mod._beta_rp(mod.beta).float(),
                    mod._gamma_rp(mod.gamma).float(), inverse)
    assert not torch.equal(f32.to(BF16).permute(0, 2, 3, 1), got)


def _sums_in_other_orders(xx: np.ndarray, gamma: np.ndarray) -> dict:
    """f32 sums of gamma[o, c] * xx[c, p] (xx [C, P], each term exact in
    f32) in orders a tensor core may take: {order: [C_out, P] f32}."""
    terms = (gamma.astype(np.float64)[:, :, None]
             * xx.astype(np.float64)[None]).astype(np.float32)

    def in_order(t):  # t [O, K, P]: f32 adds, round to nearest
        acc = np.zeros((t.shape[0], t.shape[2]), np.float32)
        for k in range(t.shape[1]):
            acc = acc + t[:, k]
        return acc

    def pairwise(t):  # an odd count carries its last term up a level
        while t.shape[1] > 1:
            h = t.shape[1] // 2
            t = np.concatenate([t[:, 0:2 * h:2] + t[:, 1:2 * h:2],
                                t[:, 2 * h:]], 1)
        return t[:, 0]

    def truncating(t):  # each add rounded toward zero (all terms >= 0)
        acc = np.zeros((t.shape[0], t.shape[2]), np.float32)
        for k in range(t.shape[1]):
            exact = acc.astype(np.float64) + t[:, k]
            acc = exact.astype(np.float32)
            acc = np.where(acc.astype(np.float64) > exact,
                           np.nextafter(acc, np.float32(0)), acc)
        return acc

    o, c, p = terms.shape
    chunks = terms.reshape(o, c // 16, 16, p)
    return {"k16_chunks": in_order(np.stack(
                [in_order(chunks[:, j]) for j in range(c // 16)], 1)),
            "reversed": in_order(terms[:, ::-1]),
            "pairwise": pairwise(terms),
            "truncating": truncating(terms)}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ch", [64, 128, 192, 256])
def test_bf16_sum_in_any_tensor_core_order_is_explained(ch, inverse):
    """K3's bf16 mode sums its f32 product on the tensor cores, in another
    order than the twin's: every output it can give is still the composite
    of a sum within 1 ulp of the twin's, and the check still sees a
    transposed gamma."""
    rng = np.random.default_rng(17 * ch + inverse)
    x = torch.from_numpy((rng.standard_normal((1, ch, 8, 16)) * 2)
                         .astype(np.float32)).to(BF16)
    beta = torch.from_numpy(rng.uniform(0.5, 2.0, ch).astype(np.float32)) \
        .to(BF16)
    gamma = torch.from_numpy(rng.uniform(0.0, 0.1, (ch, ch))
                             .astype(np.float32)).to(BF16)
    xx = (x * x).float().reshape(ch, -1).numpy()
    twin = bf16_sum(x, gamma)
    moved = 0
    for order, sums in _sums_in_other_orders(
            xx, gamma.float().numpy()).items():
        norm = torch.from_numpy(sums).reshape(x.shape).to(BF16)
        moved += int((norm != twin).sum())
        out = bf16_tail(x, beta, norm, inverse)
        assert bf16_unexplained(out, x, beta, gamma, inverse) == 0, order
        assert bf16_unexplained(out, x, beta, gamma.t(), inverse) > 0, order
    print(f"C {ch}: {moved} sums rounded to another bf16 than the twin's, "
          "over the four orders")


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32)])
def test_wrapper_refuses_mixed_dtypes(dtypes):
    x = torch.ones((1, 16, 2, 2), dtype=dtypes[0])
    beta = torch.ones(16, dtype=dtypes[1])
    gamma = torch.eye(16, dtype=dtypes[2])
    with pytest.raises(ValueError, match="share one dtype") as e:
        gdn(x, beta, gamma)
    assert all(str(d) in str(e.value) for d in dtypes)


# ---------------- the two GDN families at bf16 -------------------------------

def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = []
    for _ in range(n):
        f = rng.uniform(2, 9, 3)
        imgs.append(np.stack([np.sin(f[0] * xx + 1) * np.cos(f[1] * yy),
                              np.cos(f[2] * xx * yy), np.sin(3 * yy + xx)],
                             -1))
    noise = rng.uniform(-0.1, 0.1, (n, h, w, 3))
    return np.clip(np.round((np.stack(imgs) * 0.7 + noise + 1.0) * 127.5),
                   0, 255).astype(np.uint8)


def _balle18_edit(params, seed):
    """``tests/test_torch_generic.py``'s edits: gamma re-drawn
    non-symmetric, y spread over bins, the y tables carrying the rate."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k == "gamma":
                v = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
            elif path[-2:] == ("encoder", "conv_6"):
                v = v * 40.0
            elif path[-2:] == ("hyperdecoder", "c3") and k == "bias":
                v[v.size // 2:] += 2.0
            out[k] = v
        return out

    return walk(params)


def _configs(family):
    """(JAX config, port config) at tiny widths, ``transform_dtype``
    bfloat16 set in code."""
    if family == "balle18":
        jc, pc = JaxConfig.from_file(BALLE18), Config.from_file(BALLE18)
        for cfg in (jc, pc):
            for key, kw in BALLE18_TINY.items():
                for k, v in kw.items():
                    cfg.subnet[key][k] = v
    else:
        opt = config(family)
        jc, pc = JaxConfigDict(copy.deepcopy(opt)), ConfigDict(
            copy.deepcopy(opt))
    for cfg in (jc, pc):
        cfg["transform_dtype"] = "bfloat16"
    return jc, pc


@pytest.fixture(scope="module", params=["balle18", "cheng20"])
def family_pair(request):
    family = request.param
    jc, pc = _configs(family)
    jm = jax_build(jc)
    jm.init_params(input_size=64)
    params = jax.device_get(jm.params)
    params = _balle18_edit(params, 7) if family == "balle18" else edit(
        params, 7, Y_CONV[family], ("hyperdecoder", "c5"))
    jm.params = jax.device_put(params)
    jm.codec_setup()
    pm = build_comp_model(pc, device="cpu")
    pm.load_state_dict(export_state_dict(params, pm.net, pm.use_rate,
                                         pm.use_beta))
    pm.codec_setup()
    assert pm.transform_dtype == BF16
    assert {p.dtype for p in pm._enc_t.parameters()} == {BF16}
    return family, jm, pm, _images(2, 64, 96, 11)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_transforms_match_jax(family_pair):
    family, jm, pm, x = family_pair
    xf = (x.astype(np.float32) / 255.0 - 0.5) * 2.0
    jy, jz = _apply_encode_latents(jm.net, jm.params, jnp.asarray(xf), {},
                                   jnp.bfloat16)
    with torch.no_grad():
        ty, tz = pm._encode_latents(nchw(xf).to(BF16), None)
    assert ty.dtype == tz.dtype == BF16
    y_hat = np.round(np.asarray(jy))
    ji = _apply_decode(jm.net, jm.params, jnp.asarray(y_hat), {},
                       jnp.bfloat16)
    with torch.no_grad():
        ti = pm._decode_image(nchw(y_hat).to(BF16), None, None)
    for name, got, want in (("y", ty, jy), ("z", tz, jz), ("image", ti, ji)):
        err = _rel_l2(nhwc(got.float()), np.asarray(want))
        print(f"{family} bf16 {name}: relative L2 error {err:.2e} against "
              "JAX")
        assert err <= REL_L2[family], (name, err)


@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_bf16_streams_decode_to_the_encoders_y_hat(family_pair, wire):
    family, jm, pm, x = family_pair
    try:
        for m in (jm, pm):
            m.opt["wire_format"] = wire
            m.opt["device_wire_lanes"] = 16
            m.codec_setup()
        port, ref = pm.compress_batch(x), jm.compress_batch(x)
        y_port = np.concatenate([e["y_hat"] for e in port])
        y_ref = np.concatenate([np.asarray(e["y_hat"]) for e in ref])
        assert np.unique(y_port).size > 8
        print(f"{family} bf16, {wire} wire: "
              f"{float((np.abs(y_port - y_ref) > 0.5).mean()):.2e} of y_hat "
              "apart between the packages' encoders")
        _, _, y_pp = pm.decompress_batch([e["string_list"] for e in port])
        np.testing.assert_array_equal(y_pp, y_port)
        _, _, y_jp = jm.decompress_batch([e["string_list"] for e in port])
        np.testing.assert_allclose(np.asarray(y_jp), y_port, rtol=1e-5,
                                   atol=1e-5)
        _, _, y_pj = pm.decompress_batch([e["string_list"] for e in ref])
        np.testing.assert_allclose(y_pj, y_ref, rtol=1e-5, atol=1e-5)
        # the analysis runs at the fixed batch: batch 1 gives the same bits
        assert pm.compress(x[1:])["string_list"] == port[1]["string_list"]
    finally:
        for m in (jm, pm):
            m.opt["wire_format"] = "compressai"
            m.codec_setup()


def test_bf16_reconstruction_near_the_f32_one(family_pair):
    family, _, pm, x = family_pair
    strings = [e["string_list"] for e in pm.compress_batch(x)]
    fake16, _, y16 = pm.decompress_batch(strings)
    try:
        pm.opt["transform_dtype"] = None
        pm.codec_setup()
        fake32, _, y32 = pm.decompress_batch(strings)
    finally:
        pm.opt["transform_dtype"] = "bfloat16"
        pm.codec_setup()
    np.testing.assert_array_equal(y16, y32)
    levels = (fake16 - fake32) * 127.5
    psnr = 10 * np.log10(255.0 ** 2 / float(np.mean(levels ** 2)))
    print(f"{family}: bf16 reconstruction {psnr:.2f} dB from the f32 one, "
          f"at most {float(np.abs(levels).max()):.1f} levels apart")
    assert psnr >= RECON_PSNR
