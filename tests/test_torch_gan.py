"""The port's GAN pieces against the JAX package's, on the CPU: the five
GAN losses, the ten discriminator classes (on weights carried over from
flax's init by ``export_discriminator_state``), their state after a D step
(BatchNorm's running moments, spectral norm's ``u`` / ``sigma``), the
upsampling of the latent-conditional classes, and the full-width
discriminators of ``endurance_stage3.yaml`` and ``examples/example_2.yaml``
mapped key for key onto JAX's tree (``jax.eval_shape``, no JAX init).

Tolerances: the losses rtol 1e-6; the discriminators' outputs rtol 1e-5
in f32, with an atol of 1e-5 of the map's largest magnitude (the convs sum
in another order, and BatchNorm divides by a tiny batch's deviation); the
state rtol 1e-5 (the power step and the batch moments sum in another
order).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from crdr_tpu.losses import build_loss as jax_loss
from crdr_tpu.subnet.discriminator import build_discriminator as jax_build_d
from crdr_tpu.utils.config import Config as JaxConfig
from crdr_tpu_torch.importers.jax_params import export_discriminator_state
from crdr_tpu_torch.losses import build_loss
from crdr_tpu_torch.nn import ChannelNorm2D, InstanceNorm2D, make_norm
from crdr_tpu_torch.subnet.discriminator import build_discriminator
from crdr_tpu_torch.utils.config import Config
from crdr_tpu_torch.utils.registry import DISCRIMINATOR_REGISTRY, LOSS_REGISTRY
from tests.torch_pairs import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
RATE = 1.7      # a multi-rate discriminator truncates it to rate 1
Y_CH, SIDE = 16, 64


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------- the GAN losses ---------------------------------------------------

LOSSES = ["VanillaGANLoss", "MaskedVanillaGANLoss", "MultiscaleVanillaGANLoss",
          "HingeGANLoss", "MultiscaleHingeGANLoss"]


def test_every_gan_loss_is_registered():
    assert set(LOSSES) <= set(LOSS_REGISTRY.keys())


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("is_real,is_disc", [(True, True), (False, True),
                                             (True, False), (False, False)])
def test_gan_losses_match_jax(name, is_real, is_disc):
    opt = {"type": name, "loss_weight": 0.37}
    mine, ref = build_loss(opt), jax_loss(opt)
    multi = name.startswith("Multiscale")
    xs = [_x((2, 1, 8, 8), 1, 3.0), _x((2, 1, 4, 4), 2, 3.0)]
    kw = {}
    if name == "MaskedVanillaGANLoss":
        kw["mask"] = (np.random.default_rng(3).uniform(size=(2, 1, 8, 8))
                      > 0.4).astype(np.float32)
    if name.endswith("HingeGANLoss") and not is_disc and not is_real:
        with pytest.raises(ValueError):
            mine(xs if multi else xs[0], is_real=False, is_disc=False)
        return
    got = mine([torch.from_numpy(x) for x in xs] if multi
               else torch.from_numpy(xs[0]), is_real=is_real, is_disc=is_disc,
               **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = ref([jnp.asarray(x) for x in xs] if multi else jnp.asarray(xs[0]),
               is_real=is_real, is_disc=is_disc,
               **{k: jnp.asarray(v) for k, v in kw.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_bce_is_jaxs_formula_at_large_logits():
    """max(x, 0) - x t + log1p(exp(-|x|)): finite and exact where a naive
    log(sigmoid) overflows."""
    x = np.array([-200.0, -30.0, 0.0, 30.0, 200.0], np.float32)
    for is_real in (True, False):
        got = build_loss({"type": "VanillaGANLoss", "loss_weight": 1.0})(
            torch.from_numpy(x), is_real=is_real, is_disc=True)
        want = jax_loss({"type": "VanillaGANLoss", "loss_weight": 1.0})(
            jnp.asarray(x), is_real=is_real, is_disc=True)
        assert np.isfinite(float(got))
        assert float(got) == pytest.approx(float(want), rel=1e-7)


# ---------------- the norms ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["CN", "IN"])
def test_channel_and_instance_norm_match_flax(kind):
    from crdr_tpu.nn.norm import make_norm as jax_make_norm

    x = _x((2, 7, 6, 5), 4, 2.0) + 0.5
    m = make_norm(kind, 5)
    assert isinstance(m, ChannelNorm2D if kind == "CN" else InstanceNorm2D)
    with torch.no_grad():
        m.gamma.copy_(torch.linspace(0.5, 1.5, 5))
        m.beta.copy_(torch.linspace(-0.2, 0.3, 5))
    jm = jax_make_norm(kind, 5, "n")
    params = {"gamma": jnp.linspace(0.5, 1.5, 5), "beta":
              jnp.linspace(-0.2, 0.3, 5)}
    want = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert make_norm("none", 5) is None
    with pytest.raises(ValueError):
        make_norm("BN", 5)


# ---------------- the ten discriminators ---------------------------------------------

# (class, fields, norm types it takes, conditional on y_hat, multi-rate)
CLASSES = {
    "CLIC21GVAEDiscriminator": ({}, True, False, False),
    "CLIC21GVAELatentConditionalDiscriminator": (
        {"y_ch": Y_CH, "latent_nc": 4}, True, True, False),
    "ModuleListDiscriminator": ({"_num_subd": 3}, True, False, True),
    "SharedBackboneClic21GvaeDiscriminator": ({"rate_level": 3}, True, False,
                                              True),
    "SharedHeadClic21GvaeDiscriminator": ({"rate_level": 3}, True, False,
                                          True),
    "MultirateSeparateClic21GvaeDiscriminator": ({"_num_subd": 3}, True,
                                                 False, True),
    "RateCondClic21GvaeDiscriminator": ({"rate_level": 3}, True, False, True),
    "MultirateSharedRateCondClic21GvaeDiscriminator": ({"rate_level": 3}, True,
                                                       False, True),
    "HiFiCDiscriminator": ({}, False, False, False),
    "HiFiCConditionalDiscriminator": ({"y_ch": Y_CH, "latent_nc": 4}, False,
                                      True, False),
}
CASES = [(c, n) for c, (_, norms, _, _) in CLASSES.items()
         for n in (("none", "BN", "IN", "CN") if norms else (None,))]


def _pair(cls, norm, host_rate=False, **extra):
    """(port D, flax D, flax variables, D kwargs of both) at main_ch 8, the
    port's D on the flax init.  JAX gets ``rate_ind`` as an array (its
    ``lax.switch``, as the trainer passes it) or, with ``host_rate``, as a
    number (its list index: a BatchNorm's state cannot leave a switch)."""
    fields, _, cond, multi = CLASSES[cls]
    opt = {"type": cls, "main_ch": 8, **fields, **extra}
    if norm is not None:
        opt["norm_type"] = norm
    jd = jax_build_d(opt)
    jkw, tkw = {}, {}
    if multi:
        jkw["rate_ind"] = RATE if host_rate else jnp.asarray([RATE])
        tkw["rate_ind"] = RATE
    if cond:
        y = _x((2, SIDE // 16, SIDE // 16, Y_CH), 9)
        jkw["y_hat"], tkw["y_hat"] = jnp.asarray(y), _nchw(y)
    init_kw = dict(jkw)
    if multi:
        init_kw["rate_ind"] = 0
    variables = jax.device_get(jd.init(
        jax.random.PRNGKey(1), jnp.zeros((2, SIDE, SIDE, 3)), **init_kw))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    td = build_discriminator(opt, torch.Generator().manual_seed(0))
    td.load_state_dict(export_discriminator_state(variables, td),
                       strict=True)
    return td, jd, variables, jkw, tkw


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_every_discriminator_is_registered():
    assert set(CLASSES) == set(DISCRIMINATOR_REGISTRY.keys())


@pytest.mark.parametrize("cls,norm", CASES)
def test_discriminator_matches_flax(cls, norm):
    td, jd, variables, jkw, tkw = _pair(cls, norm)
    x = _x((2, SIDE, SIDE, 3), 5)
    mutable = ["batch_stats"] if "batch_stats" in variables else False
    want = jd.apply(variables, jnp.asarray(x), train=True, mutable=mutable,
                    **jkw)
    want = want[0] if mutable else want
    with torch.no_grad():
        got = td(_nchw(x), update_stats=False, **tkw)
    assert got.shape == (2, 1) + tuple(want.shape[1:3])
    _close(got, want)


@pytest.mark.parametrize("cls,norm", [
    ("CLIC21GVAEDiscriminator", "BN"),
    ("CLIC21GVAELatentConditionalDiscriminator", "BN"),
    ("ModuleListDiscriminator", "BN"),
    ("HiFiCDiscriminator", None),
    ("HiFiCConditionalDiscriminator", None)])
def test_state_after_a_d_step_matches_flax(cls, norm):
    """Two passes, real then fake, each starting from the state the one
    before left (the D step's chaining): the outputs and every state tensor
    against flax's ``batch_stats`` after the same two ``apply`` calls, in
    f32.  Then the gradient of a seeded weighting of both outputs, both
    packages in float64, within a relative L2 error of 1e-9 (in f32, JAX's
    BatchNorm gradient of the early layers is 1% off a float64 one, the
    port's 1e-6: the fast variance E[x^2] - E[x]^2 cancels, and XLA's CPU
    sums in another order)."""
    td, jd, variables, jkw, tkw = _pair(cls, norm, host_rate=True)
    real, fake = _x((2, SIDE, SIDE, 3), 6), _x((2, SIDE, SIDE, 3), 7, 0.5)
    with torch.no_grad():
        shape = _nhwc(td(_nchw(real), update_stats=False, **tkw)).shape
    wa, wb = _x(shape, 12), _x(shape, 13)

    def two_passes(params, v, real, fake, wa, wb, jkw):
        v = {**v, "params": params}
        a, st1 = jd.apply(v, real, train=True, mutable=["batch_stats"], **jkw)
        b, st2 = jd.apply({**v, **st1}, fake, train=True,
                          mutable=["batch_stats"], **jkw)
        return jnp.sum(a * wa) + jnp.sum(b * wb), (a, b, st2)

    args = [jnp.asarray(a) for a in (real, fake, wa, wb)]
    _, (a, b, st2) = two_passes(variables["params"], variables, *args, jkw)
    before = export_discriminator_state(variables, td)
    ta = td(_nchw(real), **tkw)
    tb = td(_nchw(fake), **tkw)
    _close(ta, a)
    _close(tb, b)
    after = export_discriminator_state(
        {"params": variables["params"],
         "batch_stats": jax.device_get(st2["batch_stats"])}, td)
    buffers = dict(td.named_buffers())
    assert buffers
    moved = [n for n in buffers if not torch.equal(before[n], after[n])]
    assert moved  # (a 1-wide u stays +-1)
    if cls == "ModuleListDiscriminator":  # the picked rate's only
        assert all(n.startswith("subD_list.1.") for n in moved)
    for name, t in buffers.items():
        np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)

    td.load_state_dict(before)
    td.double()
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64), t)
        grads = jax.grad(lambda p: two_passes(
            p, f64(variables), *[jnp.asarray(x, jnp.float64) for x in
                                 (real, fake, wa, wb)],
            {k: f64(v) if k == "y_hat" else v for k, v in jkw.items()})[0])(
            f64(variables["params"]))
        grads = jax.tree_util.tree_map(np.asarray, jax.device_get(grads))
    tkw = {k: v.double() if isinstance(v, torch.Tensor) else v
           for k, v in tkw.items()}
    ta = td(_nchw(real).double(), **tkw)
    tb = td(_nchw(fake).double(), **tkw)
    ((ta * _nchw(wa)).sum() + (tb * _nchw(wb)).sum()).backward()
    ref = _export64(grads, variables["batch_stats"], td)
    top = max(float(torch.linalg.vector_norm(r)) for r in ref.values())
    for name, p in td.named_parameters():
        mine = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float(torch.linalg.vector_norm(mine - ref[name]))
        # a conv's bias before a norm has a zero gradient: noise against noise
        assert err <= 1e-9 * float(torch.linalg.vector_norm(ref[name])) + \
            1e-12 * top, name


def _export64(grads, stats, td):
    """``export_discriminator_state`` in float64 (it converts to f32)."""
    import crdr_tpu_torch.importers.jax_params as jp

    flat = jp._flatten
    try:
        jp._flatten = lambda tree, prefix="": {
            k: np.asarray(v, np.float64) for k, v in _flat64(tree, prefix)}
        return {k: v.double() for k, v in export_discriminator_state(
            {"params": grads, "batch_stats": stats}, td).items()}
    finally:
        jp._flatten = flat


def _flat64(tree, prefix):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat64(v, key)
        else:
            yield key, v


def test_update_stats_off_leaves_the_state():
    td, *_ = _pair("HiFiCDiscriminator", None)
    before = {k: v.clone() for k, v in td.named_buffers()}
    with torch.no_grad():
        td(_nchw(_x((2, SIDE, SIDE, 3), 6)), update_stats=False)
    for k, v in td.named_buffers():
        assert torch.equal(v, before[k]), k


def test_multirate_picks_the_truncated_rate_and_refuses_others():
    td, *_ = _pair("ModuleListDiscriminator", "none")
    x = _nchw(_x((1, SIDE, SIDE, 3), 8))
    with torch.no_grad():
        a = td(x, rate_ind=1.99)
        b = td.subD_list[1](x)
    assert torch.equal(a, b)
    for bad in (3.0, -1.0):
        with pytest.raises(IndexError):
            td(x, rate_ind=bad)
    with pytest.raises(TypeError):
        td(x, rate_ind=torch.tensor([1.0]))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_x16_upsampling_matches_jax_image_resize(mode):
    """The latent-conditional classes' x16 upsampling, borders included."""
    c = _x((2, 3, 5, 4), 11)
    want = jax.image.resize(jnp.asarray(c), (2, 48, 80, 4), mode)
    kw = {"align_corners": False} if mode == "bilinear" else {}
    got = F.interpolate(_nchw(c), size=(48, 80), mode=mode, **kw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_unbuildable_discriminators_raise():
    with pytest.raises(KeyError):
        build_discriminator({"type": "NoSuchDiscriminator"})
    with pytest.raises(ValueError):
        build_discriminator({"type": "CLIC21GVAEDiscriminator",
                             "norm_type": "GN"})
    td, *_ = _pair("CLIC21GVAELatentConditionalDiscriminator", "none")
    with pytest.raises(ValueError):
        td(_nchw(_x((1, SIDE, SIDE, 3), 1)))


# ---------------- the recipes' discriminators at full width ---------------------------

RECIPES = ["endurance_stage3.yaml", os.path.join("examples", "example_2.yaml")]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_discriminator_maps_onto_jaxs_at_full_width(name):
    """Built on the meta device, the recipe's discriminator maps key for
    key and shape for shape onto the flax tree of ``jax.eval_shape``."""
    path = os.path.join(ROOT, "config", name)
    d_opt = Config.from_file(path).discriminator
    with torch.device("meta"):
        td = build_discriminator(d_opt)
    jd = jax_build_d(JaxConfig.from_file(path).discriminator)
    size = 256
    kw = {"rate_ind": 0}
    tree = jax.eval_shape(lambda: jd.init(
        jax.random.PRNGKey(1), jnp.zeros((1, size, size, 3)), **kw))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), dict(tree))
    state = export_discriminator_state(zeros, td)  # strict both ways
    assert set(state) == set(td.state_dict())
    for k, v in td.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    n = sum(v.numel() for v in td.state_dict().values())
    assert n == sum(int(np.prod(s.shape)) for s in
                    jax.tree_util.tree_leaves(tree))
    assert n > 1e6
