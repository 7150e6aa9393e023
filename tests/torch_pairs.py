"""Shared set-up of the port-vs-JAX model tests (``tests/test_torch_models_*.py``,
``tests/test_torch_cli.py``): tiny configs of the six ELIC model classes, the
port model on the CPU with its seeded init, and the JAX model on the same
weights.

Weights go port -> JAX through the JAX importer (``import_state_dict(...,
strict=True)`` on a ``jax.eval_shape`` template, the pattern of
``tests/test_reference_source_parity.py``), so no JAX init is compiled.  The
init is edited in the port first: the last analysis conv is scaled up so
that y spans several quantization bins, and the y scale heads are raised (the
Charm scale transforms' last bias, or the hyper-decoder's scale half) so
that the y Gaussian tables carry the rate.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crdr_tpu.importers.torch_import import import_state_dict
from crdr_tpu.models import build_comp_model as jax_build
from crdr_tpu.utils.config import ConfigDict as JaxConfigDict
from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.utils.config import ConfigDict
from tests.test_comp_model import tiny_opt

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module of these tiny models runs: the test
    workers share the machine's cores, and torch's thread pool, spinning on
    tensors this small, made the modules several times slower under load.
    Restored after the module.  Import it into a test module to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# model class -> (charm, rate, beta)
CLASSES = {
    "HyperpriorModel": (False, False, False),
    "HyperpriorCharmModel": (True, False, False),
    "InterpCaHyperpriorModel": (False, True, False),
    "InterpCaHyperpriorCharmModel": (True, True, False),
    "BetaCondInterpCaHyperpriorModel": (False, True, True),
    "BetaCondInterpCaHyperpriorCharmModel": (True, True, True),
}
Y_GAIN, SCALE_BIAS = 20.0, 2.0
Q, BETA = 1.5, 2.56


def tiny_config(model_type: str, seed: int = 7, pixel_shuffle: bool = False,
                **extra) -> ConfigDict:
    """main_ch 16, block_mid 8, y 32, z 16, 2 Charm slices, rate_level 3."""
    opt = tiny_opt(model_type, *CLASSES[model_type]).to_dict()
    opt["seed"] = seed
    opt["subnet"]["decoder"]["pixel_shuffle"] = pixel_shuffle
    if "context_model" in opt["subnet"]:
        opt["subnet"]["context_model"]["num_slices"] = 2
    opt.update(extra)
    return ConfigDict(opt)


def port_model(opt: ConfigDict):
    """The port model on the CPU with the module doc's edits; no
    codec_setup."""
    pm = build_comp_model(ConfigDict(opt.to_dict()), device="cpu")
    net = pm.net
    with torch.no_grad():
        net.encoder.conv4.weight.mul_(Y_GAIN)
        net.encoder.conv4.bias.mul_(Y_GAIN)
        if pm.use_charm:
            for st in net.context_model.scale_slice_transforms:
                st.model[4].bias += SCALE_BIAS
        else:
            net.hyperdecoder.hd_std.conv3.bias += SCALE_BIAS
    return pm


def jax_params(pm, opt: ConfigDict):
    """The port's weights as the JAX model's param tree (strict import)."""
    jm = jax_build(JaxConfigDict(opt.to_dict()))
    kw = {}
    if jm.use_rate:
        kw["rate_ind"] = jnp.zeros((1,), jnp.float32)
    if jm.use_beta:
        kw["beta"] = jnp.zeros((1,), jnp.float32)
    template = jax.eval_shape(lambda: jm.net.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
        is_train=False, **kw))["params"]
    state = {k: v.numpy() for k, v in pm.state_dict().items()}
    return jm, import_state_dict(
        state, template, pm.use_rate, pm.use_beta,
        pixel_shuffle=bool(opt.subnet.decoder.get("pixel_shuffle", False)),
        strict=True)


def jax_model(pm, opt: ConfigDict):
    """The JAX model of ``opt`` on the port model's weights, codec set up."""
    jm, params = jax_params(pm, opt)
    jm.params = jax.device_put(params)
    jm.codec_setup()
    return jm


def pair(model_type: str, **extra):
    """(port model, JAX model), both with the codec set up."""
    opt = tiny_config(model_type, **extra)
    pm = port_model(opt)
    jm = jax_model(pm, opt)
    pm.codec_setup()
    return pm, jm


def images(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth seeded uint8 RGB images with a little noise."""
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


def codec_kwargs(model) -> tuple:
    """(compress kwargs, decompress kwargs) for the class's rate / beta."""
    enc = {"rate_ind": Q} if model.use_rate else {}
    dec = {"beta": BETA} if model.use_beta else {}
    return enc, dec
