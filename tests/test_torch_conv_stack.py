"""The port's fused conv+GELU block against the JAX Pallas block (interpret
mode) and the exact-erf XLA math, on the CPU (the port's plain version).

Tolerances, fp32: against the Pallas block atol 1e-3, because the TPU block
evaluates GELU by a clamped polynomial whose tail error reaches 5e-4 (the
port uses exact erf); against the XLA path (strided_conv1d_as_matmul + erf
GELU) rtol 2e-4 / atol 2e-5, fp32 rounding of two summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.models.encoder import strided_conv1d_as_matmul
from unispeech_tpu.ops.pallas.conv_stack import conv_gelu_block as jax_block
from unispeech_tpu_torch.ops.kernels.conv_stack import conv_gelu_block

B, T, C = 2, 300, 64


def _inputs(k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    w = (rng.randn(k, C, C) * 0.05).astype(np.float32)
    a = (rng.rand(B, C) + 0.5).astype(np.float32)
    b = (rng.randn(B, C) * 0.1).astype(np.float32)
    return x, w, a, b


def _xla_ref(x, w, valid_len, gelu_in, affine):
    gelu = lambda v: jax.nn.gelu(v, approximate=False)
    h = jnp.asarray(x[:, :valid_len])
    if affine is not None:
        h = h * affine[0][:, None, :] + affine[1][:, None, :]
    if gelu_in:
        h = gelu(h)
    return gelu(strided_conv1d_as_matmul(h, jnp.asarray(w), 2))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("gelu_in,use_affine", [(False, False), (True, False), (True, True)],
                         ids=["plain", "gelu_in", "affine_gelu_in"])
@pytest.mark.parametrize("valid_len", [T, 257], ids=["full", "short_valid"])
def test_block_matches_jax(k, gelu_in, use_affine, valid_len):
    x, w, a, b = _inputs(k)
    affine = (a, b) if use_affine else None
    jy, jt = jax_block(jnp.asarray(x), jnp.asarray(w), valid_len=valid_len,
                       gelu_in=gelu_in, tile=128, interpret=True,
                       affine=None if affine is None else tuple(map(jnp.asarray, affine)))
    y, t_out = conv_gelu_block(
        torch.from_numpy(x), torch.from_numpy(w), valid_len=valid_len, gelu_in=gelu_in,
        affine=None if affine is None else tuple(map(torch.from_numpy, affine)))
    assert t_out == jt == (valid_len - k) // 2 + 1
    assert y.shape == (B, t_out, C)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy[:, :t_out]), atol=1e-3)
    ref = _xla_ref(x, w, valid_len, gelu_in, affine)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_block_without_output_gelu():
    x, w, _, _ = _inputs(3)
    y, _ = conv_gelu_block(torch.from_numpy(x), torch.from_numpy(w), valid_len=T,
                           gelu_out=False)
    ref = strided_conv1d_as_matmul(jnp.asarray(x), jnp.asarray(w), 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape,valid_len", [((4, C, C), T), ((3, C, C), T + 1),
                                              ((3, C, 32), T)])
def test_block_rejects(shape, valid_len):
    x = torch.zeros(B, T, C)
    with pytest.raises(ValueError):
        conv_gelu_block(x, torch.zeros(shape), valid_len=valid_len)
