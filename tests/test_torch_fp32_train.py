"""fp32 training's kernels on the CPU: the backward wrappers' dtype contract
through their CUDA checkers (which read only shapes, dtypes and strides),
the fp32 attention backward against the Pallas backward in interpret mode,
the fp32 dropout forward's keep pattern, and the sum-of-|terms| rule that
the card holds the fp32 kernels' atomic sums to.

The fp32 train step itself is held against JAX by
``tests/test_torch_train.py`` (3 steps in the Base and the layer_norm
structure); the fp32 L1 and conv-block backwards by the L1 and conv-stack
test files. Tolerances: attention gradients rtol 1e-4 / atol 1e-5 of the
gradient's scale against jax.grad through the Pallas kernels
(test_torch_flash_attention.py's backward tolerance: the same function
summed in other orders, through exp and the softmax Jacobian).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend
from unispeech_tpu_torch.ops.kernels.philox import attention_keep
from unispeech_tpu_torch.ops.kernels.sum_terms import (
    SUM_RTOL,
    attn_terms,
    conv_terms,
    l1_terms,
    sum_error,
)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (q, out, dO dtypes): bf16 and fp32 pass; fp16, a bf16 dO or out under
# fp32 q, and an fp32 dO under bf16 q raise
@pytest.mark.parametrize("dtypes,ok", [
    ((F32, F32, F32), True), ((BF16, BF16, BF16), True), ((F16, F16, F16), False),
    ((F32, F32, BF16), False), ((F32, BF16, F32), False), ((BF16, BF16, F32), False),
], ids=["fp32", "bf16", "fp16", "fp32_q_bf16_dout", "fp32_q_bf16_out", "bf16_q_fp32_dout"])
def test_attention_backward_dtype_contract(dtypes, ok):
    q, out, dout = (torch.zeros(2, 24, 2, 64, dtype=d) for d in dtypes)
    if ok:
        flash_attention._check_backward(q, out, dout)
        with pytest.raises(ValueError):  # dO of another shape
            flash_attention._check_backward(q, out, dout[:, :-1])
    else:
        with pytest.raises(ValueError):
            flash_attention._check_backward(q, out, dout)


# (compute dtype, dy dtype)
@pytest.mark.parametrize("dtype,dy_dtype,ok", [
    (F32, F32, True), (BF16, BF16, True), (F16, F16, False), (F32, BF16, False),
    (BF16, F32, False)], ids=["fp32", "bf16", "fp16", "fp32_bf16_dy", "bf16_fp32_dy"])
def test_l1_backward_dtype_contract(dtype, dy_dtype, ok):
    wav = torch.zeros(2, 400)
    kern = torch.zeros(10, 1, 64)
    t1 = (400 - 10) // 5 + 1
    dy = torch.zeros(2, t1, 64, dtype=dy_dtype)
    if ok:
        *_, w = l1_frontend._check_backward(wav, kern, 5, dy, dtype)
        assert w.dtype == dtype and w.shape == (10, 64)
        with pytest.raises(ValueError):  # dy of another length
            l1_frontend._check_backward(wav, kern, 5, dy[:, 1:], dtype)
    else:
        with pytest.raises(ValueError):
            l1_frontend._check_backward(wav, kern, 5, dy, dtype)


# (x, dy, pre dtypes): bf16 and fp32 pass; fp16, a bf16 pre or dy under
# fp32 x, and fp32 under bf16 x raise
@pytest.mark.parametrize("dtypes,ok", [
    ((F32, F32, F32), True), ((BF16, BF16, BF16), True), ((F16, F16, F16), False),
    ((F32, F32, BF16), False), ((F32, BF16, F32), False), ((BF16, BF16, F32), False),
], ids=["fp32", "bf16", "fp16", "fp32_bf16_pre", "fp32_bf16_dy", "bf16_fp32_pre"])
def test_conv_block_backward_dtype_contract(dtypes, ok):
    xd, dyd, pred = dtypes
    x = torch.zeros(2, 64, 128, dtype=xd)
    kern = torch.zeros(3, 128, 128)
    affine = (torch.ones(2, 128), torch.zeros(2, 128))
    dy = torch.zeros(2, 31, 128, dtype=dyd)
    pre = torch.zeros(2, 31, 128, dtype=pred)
    if ok:
        *_, w, ab = conv_stack._check_backward(x, kern, 64, True, affine, dy, pre)
        assert w.dtype == xd and all(t.dtype == F32 for t in ab)
        # without the output GELU pre is not read
        conv_stack._check_backward(x, kern, 64, False, None, dy, None)
        with pytest.raises(ValueError):  # the output GELU needs pre
            conv_stack._check_backward(x, kern, 64, True, None, dy, None)
    else:
        with pytest.raises(ValueError):
            conv_stack._check_backward(x, kern, 64, True, affine, dy, pre)


# WavLM-Large's layout (16 heads of 64) and HuBERT X-Large's head dim (80,
# padded to 128 on the card), gated bias and key padding, a third row of
# length 0 with dO 0 on it (as in training, ROADMAP 3.5)
@pytest.mark.parametrize("B,T,H,hd", [(3, 40, 16, 64), (3, 45, 2, 80)],
                         ids=["large_16x64", "hd80"])
def test_attention_fp32_backward_matches_pallas(B, T, H, hd):
    """dq, dk, dv, dbias and dgate of the port's op (the plain fp32 forward
    and backward on the CPU) against jax.grad through the Pallas kernels in
    interpret mode, fp32."""
    rng = np.random.RandomState(T + hd + 1)
    q, k, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    bias = rng.randn(H, T, T).astype(np.float32)
    gate = (1.0 / (1.0 + np.exp(-rng.randn(B, H, T))) + 1.0).astype(np.float32)
    kpm = np.arange(T)[None, :] >= np.asarray([T, T - 13, 0])[:, None]
    dout = rng.randn(B, T, H, hd).astype(np.float32)
    dout[2] = 0.0

    def jloss(qq, kk, vv, bb, gg):
        out = jax_fused(qq, kk, vv, bb, gg, key_padding_mask=jnp.asarray(kpm), interpret=True)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                                       for a in (q, k, v, bias, gate)))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v, bias, gate)]
    out = flash_attention.fused_attention(*leaves, key_padding_mask=torch.from_numpy(kpm))
    assert out.dtype == F32
    (out * torch.from_numpy(dout)).sum().backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        assert leaf.grad.dtype == F32
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


def test_attention_fp32_dropout_keep_pattern():
    """The plain fp32 dropout forward drops exactly the bf16 plain version's
    elements at the same seed, the Philox mask of ``attention_keep``: q = k =
    0 makes every probability 1/S, and v the identity over the keys turns
    out[t, s] into keep(t, s) / (S (1 - rate))."""
    B, T, H, rate = 2, 32, 3, 0.25
    q = torch.zeros(B, T, H, 32)
    v = torch.eye(32)[None, :, None, :].expand(B, T, H, 32).contiguous()
    seed = torch.tensor([123456789], dtype=torch.int64)
    out32 = flash_attention.fused_attention_plain(q, q, v, dropout_rate=rate, dropout_seed=seed)
    out16 = flash_attention.fused_attention_plain(q.to(BF16), q.to(BF16), v.to(BF16),
                                                  dropout_rate=rate, dropout_seed=seed)
    keep = attention_keep(seed, B, H, T, T, rate).permute(0, 2, 1, 3)
    assert out32.dtype == F32 and torch.equal(out32 != 0, keep)
    assert torch.equal(out16 != 0, keep)
    # the kept elements carry 1 / (S (1 - rate)) in fp32
    np.testing.assert_allclose(out32[keep].numpy(), 1.0 / (32 * (1 - rate)), rtol=1e-6)


def _plain_sums(op, dy_scale):
    """The plain fp32 sums of ``op``'s backward with the last frame's
    cotangent scaled by ``dy_scale``, and their sums of |terms|."""
    g = torch.Generator().manual_seed(7)
    if op == "l1":
        wav = torch.randn(2, 400, generator=g) * 0.1
        w = torch.randn(10, 1, 16, generator=g) * 0.4
        dy = torch.randn(2, 79, 16, generator=g)
        ds1, ds2 = (torch.randn(2, 16, generator=g) * 1e-2 for _ in range(2))
        dy[:, -1] *= dy_scale
        want = l1_frontend.l1_conv_backward_plain(wav, w, 5, dy, ds1, ds2, F32)
        return [want], [l1_terms(wav, w, 5, dy, ds1, ds2)]
    if op == "conv":
        x = torch.randn(2, 40, 16, generator=g)
        w = torch.randn(3, 16, 16, generator=g) * 0.2
        ab = (torch.rand(2, 16, generator=g) + 0.5, torch.randn(2, 16, generator=g) * 0.1)
        _, t_out, pre = conv_stack.conv_gelu_block_plain(x, w, 37, True, True, ab,
                                                         return_pre=True)
        dy = torch.randn(2, t_out, 16, generator=g)
        dy[:, -1] *= dy_scale
        want = conv_stack.conv_gelu_block_backward_plain(x, w, 37, True, True, ab, dy, pre)
        return list(want[1:]), list(conv_terms(x, w, 37, True, True, ab, dy, pre, want[0]))
    B, T, H, hd = 2, 24, 3, 16
    q, k, v = (torch.randn(B, T, H, hd, generator=g) for _ in range(3))
    bias = torch.randn(H, T, T, generator=g)
    gate = torch.rand(B, H, T, generator=g) + 1.0
    kpm = torch.arange(T)[None, :] >= torch.tensor([T, T - 5])[:, None]
    seed = torch.tensor([99], dtype=torch.int64)
    out, lse = flash_attention.fused_attention_plain(q, k, v, bias, gate, key_padding_mask=kpm,
                                                     dropout_rate=0.1, dropout_seed=seed,
                                                     return_lse=True)
    dout = torch.randn(B, T, H, hd, generator=g)
    dout[:, -1] *= dy_scale
    args = (q, k, v, bias, gate, kpm, None, 0.1, seed, out, lse, dout)
    want = flash_attention.fused_attention_backward_plain(*args)
    return list(want[3:]), list(attn_terms(*args))


@pytest.mark.parametrize("op", ["l1", "conv", "attention"])
def test_sum_terms_bound_the_plain_sums(op):
    """Each plain fp32 sum (L1 dW; conv dW, da, db; attention dbias, dgate)
    is within its sum of |terms| (fp32 rounding: 1e-5 of it), so SUM_RTOL
    of that sum is a bound that reordering can meet; and the rule catches
    a sum that lost one frame's terms (the last frame's cotangent 0)."""
    sums, terms = _plain_sums(op, 1.0)
    lost, _ = _plain_sums(op, 0.0)
    assert len(sums) == len(terms) == len(lost)
    for s, t, miss in zip(sums, terms, lost):
        assert t.shape == s.shape and t.dtype == F32 and (t >= 0).all()
        assert (s.abs() <= t * (1 + 1e-5) + 1e-30).all()
        assert sum_error(s, s.clone(), t) == 0.0
        assert sum_error(miss, s, t) > SUM_RTOL
