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
from unispeech_tpu_torch.ops.kernels.l1_frontend import (
    l1_conv_backward_plain,
    l1_conv_with_stats,
    l1_conv_with_stats_plain,
)

C, K, STRIDE = 64, 10, 5


def _inputs(ns, seed=0, B=2, k=K):
    rng = np.random.RandomState(seed)
    wav = rng.randn(B, ns).astype(np.float32)
    kern = (rng.randn(k, 1, C) * 0.05).astype(np.float32)
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


def _cotangents(B, t1, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, t1, C).astype(np.float32), rng.randn(B, C).astype(np.float32),
            (rng.randn(B, C) * 0.1).astype(np.float32))


_NS_IDS = {2565: "aligned", 3001: "ragged", 700: "short"}
# WavLM's (10, 5) at three lengths, then every other kind of geometry the
# kernel's generic instantiation takes: k = stride (no second collapsed
# row), k = 2 stride, and stride 8 (all eight lanes)
_BWD_CASES = [(ns, stats, K, STRIDE) for stats in (True, False) for ns in _NS_IDS] + [
    (ns, stats, k, stride) for k, stride in ((8, 4), (5, 5), (16, 8))
    for stats in (True, False) for ns in (3001, 700)]


@pytest.mark.parametrize(
    "ns,stats,k,stride", _BWD_CASES,
    ids=[f"{'stats' if st else 'no_stats'}-{_NS_IDS[ns]}"
         + ("" if (k, sd) == (K, STRIDE) else f"-k{k}s{sd}") for ns, st, k, sd in _BWD_CASES])
def test_l1_backward_matches_pallas(ns, stats, k, stride):
    """The plain backward against jax.grad through the Pallas op (interpret
    mode) and against torch autograd of the plain forward, fp32: the same
    products summed over t1 rows in other orders, rtol 1e-4 / atol 1e-4 of
    the gradient's scale."""
    wav, kern = _inputs(ns, k=k)
    t1 = (ns - k) // stride + 1
    dy, d1, d2 = _cotangents(2, t1)
    if not stats:
        d1 = d2 = np.zeros_like(d1)

    def jloss(kk):
        y, s1, s2, _ = jax_l1(jnp.asarray(wav), kk, stride, dtype=jnp.float32, tile=256,
                              interpret=True, with_stats=stats)
        out = jnp.sum(y[:, :t1] * dy)
        if stats:
            out = out + jnp.sum(s1 * d1) + jnp.sum(s2 * d2)
        return out

    want = np.asarray(jax.grad(jloss)(jnp.asarray(kern)))
    tw = torch.from_numpy(wav)
    sums = (torch.from_numpy(d1), torch.from_numpy(d2)) if stats else (None, None)
    got = l1_conv_backward_plain(tw, torch.from_numpy(kern), stride, torch.from_numpy(dy),
                                 *sums, dtype=torch.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * scale)

    # the op's autograd (the plain backward on the CPU) and torch autograd of
    # the plain forward
    k_op = torch.from_numpy(kern).requires_grad_()
    k_ref = torch.from_numpy(kern).requires_grad_()
    for fn, kk in ((l1_conv_with_stats, k_op), (l1_conv_with_stats_plain, k_ref)):
        y, s1, s2, _ = fn(tw, kk, stride, dtype=torch.float32)
        loss = (y * torch.from_numpy(dy)).sum()
        if stats:
            loss = loss + (s1 * sums[0]).sum() + (s2 * sums[1]).sum()
        loss.backward()
    np.testing.assert_allclose(k_op.grad.numpy(), k_ref.grad.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(k_op.grad.numpy(), want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("ns", [2565, 3001, 700], ids=["aligned", "ragged", "short"])
@pytest.mark.parametrize("k,stride", [(K, STRIDE), (8, 4)])
def test_l1_no_sums_matches_pallas(ns, k, stride):
    """with_stats=False (the layer_norm extractor's call) against the Pallas
    op's no-sums form in interpret mode, bf16: y1 within one bf16 ulp (as in
    test_l1_matches_pallas), no sums on either side, and y1 bit-equal to the
    with-sums form's. Its gradient (the backward without the sums'
    cotangents) against jax.grad, fp32: rtol 1e-4 / atol 1e-4 of its scale."""
    wav, kern = _inputs(ns, k=k)
    jy, js1, js2, jt1 = jax_l1(jnp.asarray(wav), jnp.asarray(kern), stride, dtype=jnp.bfloat16,
                               tile=256, interpret=True, with_stats=False)
    tw, tk = torch.from_numpy(wav), torch.from_numpy(kern)
    y, s1, s2, t1 = l1_conv_with_stats(tw, tk, stride, with_stats=False)
    assert js1 is None and js2 is None and s1 is None and s2 is None
    assert t1 == jt1 and y.shape == (2, t1, C) and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy[:, :t1], np.float32),
                               rtol=2.0**-7, atol=1e-6)
    assert torch.equal(y, l1_conv_with_stats(tw, tk, stride)[0])

    dy = _cotangents(2, t1)[0]
    want = np.asarray(jax.grad(lambda kk: jnp.sum(jax_l1(
        jnp.asarray(wav), kk, stride, dtype=jnp.float32, tile=256, interpret=True,
        with_stats=False)[0][:, :t1] * dy))(jnp.asarray(kern)))
    kk = tk.clone().requires_grad_()
    y, s1, s2, _ = l1_conv_with_stats(tw, kk, stride, dtype=torch.float32, with_stats=False)
    assert s1 is None and s2 is None
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(kk.grad.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
