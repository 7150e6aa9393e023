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

``gamma`` is never symmetric here: the init value ``0.1 * I`` would hide a
transposed product.  The kernel itself is held against the twin on the card
(``tests/test_torch_gdn_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from crdr_tpu.nn.norm import GDN as FlaxGDN
from crdr_tpu.ops.pallas_gdn import gdn_reference, pallas_gdn
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.nn import GDN, Dense
from crdr_tpu_torch.ops.gdn import gdn, gdn_plain

TOL = dict(rtol=1e-5, atol=1e-6)


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
    import jax

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
