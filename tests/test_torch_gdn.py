"""K3's plain twin and the port's GDN against the JAX package, on the CPU.

* ``gdn_plain`` against ``pallas_gdn`` (Pallas interpreter) and
  ``gdn_reference``, both directions, at C = 192 and 128 and a row count
  that is not a multiple of the TPU kernel's 256-row tile; rtol 1e-5 /
  atol 1e-6, as ``tests/test_pallas.py`` holds the Pallas kernel.
* ``nn.norm.GDN`` against flax ``nn.norm.GDN`` on the same stored params,
  drawn so that the lower bound of the reparameterization clamps some
  entries while the norm stays away from 0.
* ``export_state_dict`` keeps a non-symmetric ``gamma`` as it is (only Dense
  weights are transposed).
* The gradient: ``gdn``'s backward (``GDNFunction``) against ``jax.grad`` of
  ``gdn_reference`` for x, beta and gamma, both directions, C = 64 and 192,
  rtol 1e-4 / atol 1e-5 (the gradients of beta and gamma sum over every
  pixel, x's over C channels, in another order than XLA's; measured <= 4e-6
  absolute at gradients up to ~23); ``gradcheck`` in float64; the ``GDN``
  module's parameter gradients against ``jax.grad`` of flax ``GDN``, through
  the reparameterization and its lower bound (JAX's custom VJP).

``gamma`` is never symmetric here: the init value ``0.1 * I`` would hide a
transposed product.  The kernel itself is held against the twin on the card
(``tests/test_torch_gdn_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jax

from crdr_tpu.entropy.ops import lower_bound as jax_lower_bound
from crdr_tpu.nn.norm import GDN as FlaxGDN
from crdr_tpu.ops.pallas_gdn import gdn_reference, pallas_gdn
from crdr_tpu_torch.entropy.ops import lower_bound
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.nn import GDN, Dense
from crdr_tpu_torch.ops.gdn import GDNFunction, gdn, gdn_plain

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(c, shape_nhwc, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_nhwc).astype(np.float32)
    beta = rng.uniform(0.5, 2.0, c).astype(np.float32)
    gamma = rng.uniform(0.0, 0.1, (c, c)).astype(np.float32)
    return x, beta, gamma


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [192, 128])
def test_plain_twin_matches_pallas_and_reference(c, inverse):
    x, beta, gamma = _inputs(c, (1, 7, 43, c), c + inverse)  # 301 rows
    args = (jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma))
    pallas = np.asarray(pallas_gdn(*args, inverse, interpret=True))
    ref = np.asarray(gdn_reference(*args, inverse))
    out = gdn_plain(_nchw(x), torch.from_numpy(beta), torch.from_numpy(gamma),
                    inverse).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, ref, **TOL)
    # the check sees a transposed gamma and the other direction
    wrong = gdn_plain(_nchw(x), torch.from_numpy(beta),
                      torch.from_numpy(gamma.T.copy()), inverse).numpy()
    assert np.abs(wrong.transpose(0, 2, 3, 1) - ref).max() > 1e-3
    other = gdn_plain(_nchw(x), torch.from_numpy(beta),
                      torch.from_numpy(gamma), not inverse).numpy()
    assert np.abs(other.transpose(0, 2, 3, 1) - ref).max() > 1e-1


def test_wrapper_runs_the_twin_on_the_cpu():
    x, beta, gamma = _inputs(64, (2, 5, 3, 64), 3)
    args = (_nchw(x), torch.from_numpy(beta), torch.from_numpy(gamma))
    before = gdn.launches
    torch.testing.assert_close(gdn(*args, True), gdn_plain(*args, True),
                               rtol=0, atol=0)
    assert gdn.launches == before  # the count is of kernel launches


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_matches_flax(inverse):
    c = 24
    rng = np.random.default_rng(5 + inverse)
    # negative stored gamma entries clamp to the bound (value 0); stored beta
    # stays above its bound, so the norm stays away from 0
    stored = {"beta": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "gamma": rng.uniform(-0.1, 0.3, (c, c)).astype(np.float32)}
    x = rng.standard_normal((2, 6, 5, c)).astype(np.float32)
    jy = FlaxGDN(c, inverse=inverse).apply({"params": stored}, jnp.asarray(x))
    port = GDN(c, inverse=inverse)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in stored.items()})
    assert sorted(port.state_dict()) == ["beta", "gamma"]
    with torch.no_grad():
        ty = port(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ty, np.asarray(jy), **TOL)


def test_gdn_init_matches_flax():
    flax = FlaxGDN(8).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 8)))
    port = GDN(8)
    port.reset_parameters(torch.Generator().manual_seed(0))
    for k in ("beta", "gamma"):
        np.testing.assert_array_equal(port.state_dict()[k].numpy(),
                                      np.asarray(flax["params"][k]))


def test_exporter_keeps_gamma_and_transposes_dense():
    """GDN's [C_out, C_in] gamma has the same layout in both trees; a Dense
    weight is (in, out) in flax and (out, in) in torch."""
    net = torch.nn.Module()
    net.norm = GDN(4)
    net.fc = Dense(4, 4, bias=False)
    rng = np.random.default_rng(0)
    gamma = rng.uniform(0.0, 1.0, (4, 4)).astype(np.float32)
    dense = rng.standard_normal((4, 4)).astype(np.float32)
    assert not np.allclose(gamma, gamma.T)
    params = {"norm": {"beta": np.ones(4, np.float32), "gamma": gamma},
              "fc": {"weight": dense}}
    state = export_state_dict(params, net, use_rate=False, use_beta=False)
    np.testing.assert_array_equal(state["norm.gamma"].numpy(), gamma)
    np.testing.assert_array_equal(state["fc.weight"].numpy(), dense.T)


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [64, 192])
def test_backward_matches_jax_grad(c, inverse):
    x, beta, gamma = _inputs(c, (2, 5, 7, c), 11 * c + inverse)
    w = np.random.default_rng(c - inverse).standard_normal(x.shape).astype(
        np.float32)

    def loss(a, b, g):
        return jnp.sum(gdn_reference(a, b, g, inverse) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma))
    args = [_nchw(x).requires_grad_(), torch.from_numpy(beta).requires_grad_(),
            torch.from_numpy(gamma).requires_grad_()]
    out = gdn(*args, inverse)
    assert out.grad_fn is not None
    (out * _nchw(w)).sum().backward()
    got = (_nhwc(args[0].grad), args[1].grad.numpy(), args[2].grad.numpy())
    for name, a, b in zip(("x", "beta", "gamma"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **GRAD_TOL)
    # the check sees a gradient of gamma read transposed
    assert np.abs(got[2] - np.asarray(want[2]).T).max() > 1e-1


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_function_gradcheck(inverse):
    rng = np.random.default_rng(21 + inverse)
    x = torch.from_numpy(rng.standard_normal((2, 6, 3, 4))).requires_grad_()
    beta = torch.from_numpy(rng.uniform(0.5, 2.0, 6)).requires_grad_()
    gamma = torch.from_numpy(rng.uniform(0.0, 0.2, (6, 6))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: GDNFunction.apply(*a, inverse), (x, beta, gamma))


def test_gdn_builds_a_graph_only_when_a_gradient_is_needed():
    x, beta, gamma = (torch.from_numpy(a) for a in _inputs(64, (1, 3, 2, 64),
                                                          4))
    x = x.permute(0, 3, 1, 2).contiguous()
    assert gdn(x, beta, gamma).grad_fn is None
    beta.requires_grad_()
    assert gdn(x, beta, gamma).grad_fn is not None
    with torch.no_grad():
        assert gdn(x, beta, gamma).grad_fn is None


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_grads_match_flax(inverse):
    c = 24
    rng = np.random.default_rng(31 + inverse)
    # as in test_gdn_module_matches_flax: some stored gamma entries sit
    # below the bound, where the lower bound's custom gradient decides
    stored = {"beta": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "gamma": rng.uniform(-0.1, 0.3, (c, c)).astype(np.float32)}
    x = rng.standard_normal((2, 6, 5, c)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    module = FlaxGDN(c, inverse=inverse)

    def loss(params, a):
        return jnp.sum(module.apply({"params": params}, a) * w)

    jp, jx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in stored.items()}, jnp.asarray(x))
    port = GDN(c, inverse=inverse)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in stored.items()})
    tx = _nchw(x).requires_grad_()
    (port(tx) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jx), **GRAD_TOL)
    for k in ("beta", "gamma"):
        np.testing.assert_allclose(getattr(port, k).grad.numpy(),
                                   np.asarray(jp[k]), err_msg=k, **GRAD_TOL)
    # clamped entries with a negative gradient pass it on, as in JAX
    clamped = stored["gamma"] < port._gamma_rp.bound
    assert clamped.any()
    assert (port.gamma.grad.numpy()[clamped] != 0).any()


def test_lower_bound_gradient_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0, 1.0, 64).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_lower_bound(a, 0.1) * w))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (lower_bound(tx, 0.1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    with torch.no_grad():  # the forward is the clamp either way
        np.testing.assert_array_equal(lower_bound(tx, 0.1).numpy(),
                                      np.maximum(x, np.float32(0.1)))
