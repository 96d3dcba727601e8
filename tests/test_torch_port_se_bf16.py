"""The port's squeeze-excite layer in bf16 vs JAX's Pallas path, on the CPU.

JAX's ``SELayer(use_pallas=True, dtype=bfloat16)`` hands ``se_scale`` its
fp32 weights rounded to bf16 (rcnn_ocr_tpu/models/seresnet31.py:62-65), and
the kernel (interpret mode here) computes the gate in fp32 and rounds it to
bf16 before the multiply.  The port's ``SELayer`` must round the weights the
same way: with the fp32 weights unrounded about 1% of the gates land one
bf16 ulp away.  The gate-scaled outputs are held bit-equal on at least 99.9%
of elements and within one bf16 ulp everywhere (the rest differ only where
the fp32 channel sum, taken in another order, rounds a gate the other way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcnn_ocr_tpu.models.seresnet31 import SELayer as JaxSELayer
from rcnn_ocr_tpu_torch.models.seresnet31 import SEResNet31


@pytest.fixture(scope="module")
def bf16_se_layers():
    """The squeeze-excite layers of a bf16 backbone, by channel count: they
    get the compute dtype from SEResNet31, as in the JAX module tree."""
    model = SEResNet31(dtype=torch.bfloat16)
    return {256: model.layer1_block0.se, 512: model.layer3_block0.se}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as ordered integers: adjacent bf16 numbers differ by one."""
    b = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


@pytest.mark.parametrize("shape", [(4, 8, 32, 256), (8, 4, 16, 512)])
def test_se_layer_bf16_matches_jax_pallas(bf16_se_layers, shape):
    rng = np.random.default_rng(7)
    c = shape[-1]
    s = c // 16
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    fc1 = (rng.normal(size=(c, s)) / np.sqrt(c)).astype(np.float32)
    fc2 = (rng.normal(size=(s, c)) / np.sqrt(s)).astype(np.float32)

    jm = JaxSELayer(channels=c, dtype=jnp.bfloat16, use_pallas=True)
    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = jm.apply({"params": {"fc1": jnp.asarray(fc1), "fc2": jnp.asarray(fc2)}}, x_j)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(torch.bfloat16)

    layer = bf16_se_layers[c]
    with torch.no_grad():
        layer.fc1.copy_(torch.from_numpy(fc1))
        layer.fc2.copy_(torch.from_numpy(fc2))
        got = layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape

    ulps = (_bits(got) - _bits(want)).abs()
    equal = (ulps == 0).float().mean().item()
    assert equal >= 0.999, f"only {equal:.4%} of elements bit-equal"
    assert ulps.max().item() <= 1
