"""HiFiC with ``InstanceNorm2D`` (``channel_norm: False``) at 256x256: the
port's analysis against the JAX package's, layer by layer, on the CPU.

The two packages' codecs give one symbol of 8192 apart on
``images(1, 256, 256, seed=12)`` (``tests/test_torch_spatial_global.py``).
This test shows that the difference is f32 rounding and not a fault of the
port: on the same weights (``tests/test_torch_families.py``'s edited JAX
init at tiny widths) and the same f32 input, each layer's output of each
package is held to the port's analysis run in float64 on that input.  At
every layer the port is no further from float64 than the JAX package is
(times 1.5, or 4 ulps of the layer's largest value) and both are within
4e-6 of that value; the symbols apart between the two are exactly ones
whose float64 ``y - mean`` lies within the f32 analyses' distance from
float64 of a rounding boundary, so either side is a correct rounding
(here one symbol: float64 ``y - mean`` 10.49999629, the f32 analyses
within 6.4e-5 of float64).
"""

import copy

import numpy as np

import jax.numpy as jnp
import torch

from crdr_tpu_torch.models.codec import device_uint8_to_tensor
from tests.test_torch_families import nchw, pair
from tests.torch_pairs import images, one_torch_thread  # noqa: F401

EPS32 = float(np.finfo(np.float32).eps)
LAYERS = (["conv_block1", "norm1"]
          + [f"{k}{i}" for i in range(2, 6) for k in ("conv_block", "norm")]
          + ["conv_block_out"])


def _port_layers(encoder, x: torch.Tensor) -> dict:
    """Each layer's output of the port's ``encoder`` on NCHW ``x``, as
    float64 NHWC numpy."""
    outs = {}
    hooks = [getattr(encoder, n).register_forward_hook(
        lambda m, i, o, n=n: outs.__setitem__(
            n, o.detach().double().numpy().transpose(0, 2, 3, 1)))
        for n in LAYERS]
    with torch.no_grad():
        encoder(x)
    for h in hooks:
        h.remove()
    return outs


def test_hific_in_analysis_apart_from_jax_by_f32_rounding_only():
    jm, pm = pair("hific", instance_norm=True)
    x8 = images(1, 256, 256, seed=12)
    x = device_uint8_to_tensor(torch.from_numpy(x8))  # the codec's input
    assert not pm.convert_img_range
    x_nchw = nchw(x.numpy())
    port = _port_layers(pm.net.encoder, x_nchw)
    f64 = _port_layers(copy.deepcopy(pm.net.encoder).double(),
                       x_nchw.double())
    _, state = jm.net.apply({"params": jm.params}, jnp.asarray(x.numpy()),
                            method=lambda n, xx: n.encode(xx),
                            capture_intermediates=True,
                            mutable=["intermediates"])
    inter = state["intermediates"]["encoder"]
    print("layer            scale      |port-jax|  |port-f64|  |jax-f64|")
    for name in LAYERS:
        j = np.asarray(inter[name]["__call__"][0], np.float64)
        p, d = port[name], f64[name]
        scale = float(np.abs(d).max())
        e_pj, e_p, e_j = (float(np.abs(a - b).max())
                          for a, b in ((p, j), (p, d), (j, d)))
        print(f"{name:15s} {scale:9.4g}  {e_pj:10.3g}  {e_p:10.3g}  "
              f"{e_j:10.3g}")
        assert e_p <= max(1.5 * e_j, 4 * EPS32 * scale), name
        assert max(e_p, e_j) <= 4e-6 * scale, name
        assert e_pj <= e_p + e_j
    # the symbols: each package's y around the port's means
    with torch.no_grad():
        y, z_sym, _ = pm.encode_head(torch.from_numpy(x8), None)
        _, mean, _, _ = pm.generic_params(z_sym)
    mean = mean.double().numpy()
    # each codec's own y (its own conv algorithms; JAX's jitted program)
    y_p = y.double().numpy()
    y_j = np.asarray(jm._codec_fn("encode_head")(
        jm.params, jnp.asarray(x8), None)[0], np.float64)
    r64 = f64["conv_block_out"] - mean
    err = max(float(np.abs(y_p - f64["conv_block_out"]).max()),
              float(np.abs(y_j - f64["conv_block_out"]).max()))
    assert err <= 4e-6 * np.abs(r64 + mean).max()
    apart = np.round(y_p - mean) != np.round(y_j - mean)
    print(f"{int(apart.sum())} of {apart.size} symbols apart; float64 y - "
          f"mean there {r64[apart]}, the f32 analyses within {err:.3g} of "
          "float64")
    assert 1 <= apart.sum() <= 1e-3 * apart.size
    assert np.all(np.abs(r64[apart] - np.floor(r64[apart]) - 0.5) <= err)
