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
from unispeech_tpu_torch.ops.kernels.conv_stack import (
    conv_gelu_block,
    conv_gelu_block_backward_plain,
    conv_gelu_block_plain,
)

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


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("gelu_in,use_affine", [(False, False), (True, False), (True, True)],
                         ids=["plain", "gelu_in", "affine_gelu_in"])
@pytest.mark.parametrize("valid_len", [T, 257], ids=["full", "short_valid"])
def test_block_backward_matches_jax(k, gelu_in, use_affine, valid_len):
    """The plain backward (dx, dW, da, db) against jax.grad through the Pallas
    block (interpret mode; its polynomial GELU' is off by up to 1.5e-4, so
    atol 1e-3 of the gradient's scale) and through the exact-erf XLA math
    (rtol 2e-4, atol 1e-5 of the scale: fp32 sums in other orders)."""
    x, w, a, b = _inputs(k, seed=1)
    t_out = (valid_len - k) // 2 + 1
    dy = np.random.RandomState(2).randn(B, t_out, C).astype(np.float32)
    affine = (a, b) if use_affine else None

    def pallas_loss(xx, ww, aa, bb):
        y, _ = jax_block(xx, ww, valid_len=valid_len, gelu_in=gelu_in, tile=128,
                         interpret=True, affine=(aa, bb) if use_affine else None)
        return jnp.sum(y[:, :t_out] * dy)

    def xla_loss(xx, ww, aa, bb):
        h = xx[:, :valid_len]
        if use_affine:
            h = h * aa[:, None, :] + bb[:, None, :]
        if gelu_in:
            h = jax.nn.gelu(h, approximate=False)
        y = jax.nn.gelu(strided_conv1d_as_matmul(h, ww, 2), approximate=False)
        return jnp.sum(y * dy)

    jargs = tuple(map(jnp.asarray, (x, w, a, b)))
    want_k = jax.grad(pallas_loss, argnums=(0, 1, 2, 3))(*jargs)
    want_x = jax.grad(xla_loss, argnums=(0, 1, 2, 3))(*jargs)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    taff = None if affine is None else tuple(map(torch.from_numpy, affine))
    _, _, pre = conv_gelu_block_plain(tx, tw, valid_len, gelu_in, True, taff, return_pre=True)
    got = conv_gelu_block_backward_plain(tx, tw, valid_len, gelu_in, True, taff,
                                         torch.from_numpy(dy), pre)
    n = 4 if use_affine else 2
    for g, wk, wx in zip(got[:n], want_k[:n], want_x[:n]):
        scale = float(np.abs(np.asarray(wx)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(wk), atol=1e-3 * scale)
        np.testing.assert_allclose(g.numpy(), np.asarray(wx), rtol=2e-4, atol=1e-5 * scale)

    # the op's autograd (the plain backward on the CPU) against torch
    # autograd of the plain forward
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, w, a, b)]
    ref = [torch.from_numpy(v).requires_grad_() for v in (x, w, a, b)]
    for fn, (lx, lw, la, lb) in ((conv_gelu_block, leaves), (conv_gelu_block_plain, ref)):
        y, _ = fn(lx, lw, valid_len, gelu_in, True, (la, lb) if use_affine else None)
        (y * torch.from_numpy(dy)).sum().backward()
    for l, r in zip(leaves[:n], ref[:n]):
        scale = float(r.grad.abs().max())
        np.testing.assert_allclose(l.grad.numpy(), r.grad.numpy(), rtol=2e-4,
                                   atol=1e-5 * scale)


def test_block_backward_without_output_gelu():
    """gelu_out=False: g is dy itself (no pre-activation is read)."""
    x, w, _, _ = _inputs(3, seed=3)
    t_out = (T - 3) // 2 + 1
    dy = np.random.RandomState(4).randn(B, t_out, C).astype(np.float32)
    jx, jw = jax.grad(lambda xx, ww: jnp.sum(strided_conv1d_as_matmul(xx, ww, 2) * dy),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    dx, dw, da, db = conv_gelu_block_backward_plain(
        torch.from_numpy(x), torch.from_numpy(w), T, False, False, None,
        torch.from_numpy(dy), None)
    assert da is None and db is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jw), rtol=2e-4, atol=2e-4)
