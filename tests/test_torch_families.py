"""The in-memory Cheng20 / HiFiC configs at full width (one test), and the
shared set-up of the Cheng20 and HiFiC tests (``tests/test_torch_cheng20.py``,
``tests/test_torch_hific.py``): the three in-memory configs at tiny widths
(``chip_smoke.py::family_config``; no file in ``config/`` builds these
autoencoders), the edited JAX init, and a (JAX model, port model) pair on
the same weights.

Weights go JAX -> port through ``export_state_dict``: the JAX importer takes
``hyperdecoder.c1`` / ``c2`` as transposed convs by name, which is wrong for
the Cheng20 hyper-decoder (``c2`` / ``c4`` are).  The JAX init is edited in
the flax tree, for both packages: every GDN's ``gamma`` re-drawn
non-symmetric, the other constant inits (GDN's ``beta``, the norms'
``gamma`` / ``beta``, InterpCA's rows) jittered, the latent's last conv scaled up so that y spans several
quantization bins, and the scale half of the hyper-decoder's last bias
raised so that the y Gaussian tables carry the rate.
"""

from __future__ import annotations

import copy

import numpy as np

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu_torch.importers.jax_params import export_state_dict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.utils.config import ConfigDict
from chip_smoke import family_config



def subnets(family: str, tiny: bool = True) -> dict:
    """The family's subnet options (``chip_smoke.py::family_config``);
    ``tiny``: y 32, z 16, main 16 (HiFiC: filters 8-32, 2 residual
    blocks)."""
    return family_config(family, tiny)["subnet"]


def config(family: str, instance_norm: bool = False, **opt) -> dict:
    """The whole tiny model config as a plain dict, seed 7, with ``opt``;
    ``instance_norm``: HiFiC with ``channel_norm: False`` in the encoder
    and the decoder (``InstanceNorm2D``)."""
    out = dict(family_config(family, tiny=True), seed=7, **opt)
    if instance_norm:
        for part in ("encoder", "decoder"):
            out["subnet"][part]["channel_norm"] = False
    return out


# the latent's last conv, per family (flax path tail)
Y_CONV = {"cheng20": ("encoder", "conv7"),
          "cheng20_interp_ca": ("encoder", "conv7"),
          "hific": ("encoder", "conv_block_out")}
Y_GAIN, SCALE_BIAS = 20.0, 2.0


def edit(params, seed: int, y_conv=None, last_hyper=None):
    """The flax tree with the module doc's edits (numpy, a copy)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.array(v, np.float32)
            if k == "gamma" and v.ndim == 2:
                v = rng.uniform(0.0, 0.3, v.shape).astype(np.float32)
            elif k in ("gamma", "beta") or any(
                    p.startswith("interp_ca_") for p in path):
                # constant inits (GDN's beta, the norms, InterpCA) jittered
                v = v + rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            elif y_conv and path[-2:] == y_conv:
                v = v * Y_GAIN
            elif last_hyper and path[-2:] == last_hyper and k == "bias":
                v[v.size // 2:] += SCALE_BIAS
            out[k] = v
        return out

    return walk(params)


def jax_init(jm, input_size: int = 64):
    """``jm.init_params(input_size=input_size)``'s parameters as one jitted
    call: the same draws, bit for bit, without its per-operation
    compiles (~10 s for HiFiC against ~30 s)."""
    jm._rng, rng = jax.random.split(jm._rng)
    size = min(input_size, 64)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        return jax.jit(lambda r, xx: jm.net.init(
            {"params": r}, xx, is_train=False, **jm._dummy_args()))(
            rng, x)["params"]


def pair(family: str, input_size: int = 64, **kw):
    """(JAX model, port model) on the same edited JAX init, codecs set
    up; ``kw`` goes to ``config``."""
    opt = config(family, **kw)
    jm = jax_build(JaxConfigDict(copy.deepcopy(opt)))
    last = ("hyperdecoder", "c5" if family != "hific" else "c3")
    params = edit(jax.device_get(jax_init(jm, input_size)), 7,
                  Y_CONV[family], last)
    jm.params = jax.device_put(params)
    jm.codec_setup()
    pm = build_comp_model(ConfigDict(copy.deepcopy(opt)), device="cpu")
    pm.load_state_dict(export_state_dict(params, pm.net, pm.use_rate,
                                         pm.use_beta))
    pm.codec_setup()
    return jm, pm


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_family_configs_at_full_width():
    """``chip_smoke.py``'s three configs build at full width (on the meta
    device): CompressAI's cheng2020-attn N 192 (every GDN at a width K3
    takes), Cheng20-InterpCA at rate_level 5, HiFiC's y 220 and filters
    60-960 with the Balle18 hyper pair 220 -> 192 / 440."""
    from crdr_tpu_torch.models.net import CompNet
    from crdr_tpu_torch.nn import GDN
    from crdr_tpu_torch.ops.gdn import KERNEL_CHANNELS

    for family, rate in (("cheng20", False), ("cheng20_interp_ca", True),
                         ("hific", False)):
        with torch.device("meta"):
            net = CompNet(family_config(family)["subnet"], use_rate=rate)
        shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        gdns = [m for m in net.modules() if isinstance(m, GDN)]
        if family == "hific":
            assert not gdns
            assert shapes["encoder.conv_block_out.weight"] == (220, 960, 3,
                                                                3)
            assert shapes["hyperdecoder.c3.weight"] == (440, 192, 3, 3)
            assert shapes["decoder.upconv_block4.deconv.weight"] == \
                (120, 60, 3, 3)
        else:
            assert len(gdns) == 6 and all(
                m.gamma.shape[0] in KERNEL_CHANNELS for m in gdns)
            assert shapes["hyperdecoder.c5.weight"] == (384, 192, 3, 3)
            assert shapes["encoder.block1.actv2.gdn.gamma"] == (192, 192)
            assert shapes["decoder.up0.actv2.igdn.beta"] == (192,)
        if rate:
            assert shapes["encoder.interp_ca_list.8.weight"] == (5, 1, 192,
                                                                 1, 1)
