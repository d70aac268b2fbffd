"""The port's fused L1 conv + GroupNorm-stats op against the JAX Pallas kernel
(interpret mode) on the CPU, where the port takes its plain version.

Tolerances: in fp32 both sides sum the same products in another order, so
y1 and the sums agree to fp32 rounding (rtol 1e-5). In bf16 the fp32
accumulations may round to neighbouring bf16 values where the two orders
straddle a rounding boundary: y1 is held to one bf16 ulp (rtol 2**-7), and
each such flip moves a sum over t1 rows by at most 2**-8 of one term, so the
sums are held at rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.pallas.l1_frontend import l1_conv_with_stats as jax_l1
from unispeech_tpu_torch.ops.kernels.l1_frontend import l1_conv_with_stats

C, K, STRIDE = 64, 10, 5


def _inputs(ns, seed=0, B=2):
    rng = np.random.RandomState(seed)
    wav = rng.randn(B, ns).astype(np.float32)
    kern = (rng.randn(K, 1, C) * 0.05).astype(np.float32)
    return wav, kern


# ns 2565 -> t1 = 512 = 2 tiles of 256 exactly; 3001 -> ragged last tile;
# 700 -> t1 = 139, shorter than one tile
@pytest.mark.parametrize("ns", [2565, 3001, 700], ids=["aligned", "ragged", "short"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_matches_pallas(ns, dtype):
    wav, kern = _inputs(ns)
    jy, js1, js2, jt1 = jax_l1(jnp.asarray(wav), jnp.asarray(kern), STRIDE,
                               dtype=getattr(jnp, dtype), tile=256, interpret=True)
    y, s1, s2, t1 = l1_conv_with_stats(torch.from_numpy(wav), torch.from_numpy(kern),
                                       STRIDE, dtype=getattr(torch, dtype))
    assert t1 == jt1 and y.shape == (2, t1, C)
    assert y.dtype == getattr(torch, dtype)
    y_tol, s_tol = (1e-5, 1e-5) if dtype == "float32" else (2.0**-7, 1e-3)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy[:, :t1], np.float32),
                               rtol=y_tol, atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=s_tol, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=s_tol, atol=1e-4)


@pytest.mark.parametrize("k,stride", [(4, 5), (11, 5), (18, 9)])
def test_l1_guard_rejects_geometry(k, stride):
    """stride <= k <= 2*stride and stride <= 8; the JAX guard admitted k <
    stride and then failed while tracing."""
    wav = torch.zeros(1, 2000)
    with pytest.raises(ValueError):
        l1_conv_with_stats(wav, torch.zeros(k, 1, C), stride)
