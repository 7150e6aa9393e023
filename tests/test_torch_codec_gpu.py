"""The codec's card-only numerics, on the card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_codec_gpu.py -m gpu

Without a GPU its tests skip (what they hold differs only on a CUDA device).

* The on-device uint8 -> f32 conversion of ``codec_uint8_io`` equals the
  host's ``uint8_to_tensor`` on all 256 values (CUDA divides by a CPU scalar
  as a multiply by its reciprocal, which does not).
* ``config/crdr_fastchain.yaml`` (TF32 in the chain), K1 on and off, at
  full width on small images: the decode's ``y_hat`` equals the encoder's
  and a batch-1 stream equals its batch-4 stream, on both wires.
"""

import os

import numpy as np
import pytest

import torch

from crdr_tpu_torch.models import build_comp_model
from crdr_tpu_torch.models.codec import device_uint8_to_tensor
from crdr_tpu_torch.utils.config import Config
from crdr_tpu_torch.utils.img_utils import uint8_to_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the numerics held here are the card's")
    return torch.device("cuda")


@pytest.mark.gpu
def test_uint8_conversion_is_the_hosts_on_gpu(cuda):
    v = torch.arange(256, dtype=torch.uint8, device=cuda)
    host = uint8_to_tensor(np.arange(256, dtype=np.uint8))
    np.testing.assert_array_equal(device_uint8_to_tensor(v).cpu().numpy(),
                                  host)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("wire", ["compressai", "device"])
def test_tf32_chain_round_trip_on_gpu(cuda, fused, wire):
    cfg = Config.from_file(os.path.join(ROOT, "config", "crdr_fastchain.yaml"))
    cfg.update(fused_slice_kernel=fused, wire_format=wire,
               device_wire_encoder="host")
    model = build_comp_model(cfg, device=cuda)
    with torch.no_grad():  # the y tables carry the rate (chip_smoke.py)
        for st in model.net.context_model.scale_slice_transforms:
            st.model[4].bias += 8.0
    model.codec_setup()
    assert model._chain_tf32
    rng = np.random.default_rng(int(fused) + 2 * (wire == "device"))
    imgs = rng.integers(0, 256, (4, 128, 192, 3), dtype=np.uint8)
    encs = model.compress_batch(imgs, rate_ind=1.5)
    _, _, y_hat = model.decompress_batch([e["string_list"] for e in encs],
                                         beta=2.56)
    np.testing.assert_array_equal(y_hat, np.concatenate(
        [e["y_hat"] for e in encs]))
    one = model.compress(imgs[2:3], rate_ind=1.5)
    assert one["string_list"] == encs[2]["string_list"]
    _, _, y2 = model.decompress(encs[2]["string_list"], beta=2.56)
    np.testing.assert_array_equal(y2, encs[2]["y_hat"])
