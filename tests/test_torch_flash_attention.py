"""The port's fused attention against the JAX Pallas kernel (interpret mode)
and the JAX XLA attention, on the CPU (the port's plain version).

hd=32, H=4 makes the JAX wrapper take its packed (B, T, H*hd) layout and
hd=16, H=2 its head-major one; hd=80 (HuBERT X-Large's head) and hd=24, H=2,
whose 128 % hd != 0, take the head-major one too, with a q scale that is
not a power of two. Tolerance rtol/atol 2e-5 in fp32: the same function
summed in other orders (the JAX repo's own kernel tests use it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.attention import multihead_attention as jax_mha
from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu.ops.rel_pos import compute_rel_pos_bias as jax_rel_pos_bias
from unispeech_tpu_torch.ops.attention import multihead_attention
from unispeech_tpu_torch.ops.kernels.flash_attention import (
    MAX_HEAD_DIM,
    _check_cuda,
    fused_attention,
    fused_attention_backward_plain,
    fused_attention_plain,
    kernel_head_dim,
    kernel_q,
    pad_head,
)
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias

TOL = 2e-5
LAYOUTS = [(4, 32), (2, 16), (2, 80), (2, 24)]
LAYOUT_IDS = ["packed", "head_major", "head_major_hd80", "head_major_hd24"]


def _make(B=2, T=100, H=4, hd=32, bias=True, gate=True, mask=True, amask=False, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    args = dict(
        bias=rng.randn(H, T, T).astype(np.float32) if bias else None,
        gate=(1.0 / (1.0 + np.exp(-rng.randn(B, H, T))) + 1.0).astype(np.float32)
        if gate else None,
        key_padding_mask=(np.arange(T)[None, :] >= np.asarray([T, T - 37])[:B, None])
        if mask else None,
        attn_mask=np.where(np.abs(np.arange(T)[:, None] - np.arange(T)[None, :]) > 40,
                           -1e4, 0.0).astype(np.float32) if amask else None,
    )
    return q, k, v, args


def _both(q, k, v, args):
    jargs = {n: None if a is None else jnp.asarray(a) for n, a in args.items()}
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    got = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **targs)
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **jargs)
    return got.numpy(), np.asarray(want)


CASES = {
    "bias_gate_pad": dict(),
    "bias_pad": dict(gate=False),
    "pad_only": dict(bias=False, gate=False),
    "bias_gate": dict(mask=False),
    "attn_mask": dict(amask=True),
    "ragged_t": dict(T=97),
}


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_matches_pallas(case, layout):
    H, hd = layout
    got, want = _both(*_make(H=H, hd=hd, **CASES[case]))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fused_matches_xla_and_lse():
    q, k, v, args = _make(T=97)
    bias = args["gate"][..., None] * args["bias"][None]
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
                   key_padding_mask=jnp.asarray(args["key_padding_mask"]))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    got, lse = fused_attention(tq, tk, tv, **targs, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    mine = multihead_attention(tq, tk, tv, bias=torch.from_numpy(bias),
                               key_padding_mask=targs["key_padding_mask"])
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # lse of the same logits, in float64 numpy
    logits = np.einsum("bthd,bshd->bhts", q / np.sqrt(32.0), k).astype(np.float64) + bias
    logits += np.where(args["key_padding_mask"], -1e30, 0.0)[:, None, None, :]
    m = logits.max(-1)
    ref_lse = m + np.log(np.exp(logits - m[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-4)


def test_dropout_seeded_and_regenerated():
    """Dropout is ported: the output depends on the seed and only on it, its
    keep rate matches, and the op's backward regenerates the forward's mask
    (torch autograd of the plain forward agrees to fp32 rounding)."""
    q, k, v, args = _make(B=2, T=40, H=4, hd=32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    seed = torch.tensor([1234567], dtype=torch.int64)
    out = fused_attention(tq, tk, tv, **targs, dropout_rate=0.3, dropout_seed=seed)
    again = fused_attention(tq, tk, tv, **targs, dropout_rate=0.3, dropout_seed=seed)
    other = fused_attention(tq, tk, tv, **targs, dropout_rate=0.3,
                            dropout_seed=torch.tensor([7], dtype=torch.int64))
    plain = fused_attention(tq, tk, tv, **targs)
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert not torch.allclose(out, plain)
    with pytest.raises(ValueError):  # dropout needs a seed
        fused_attention(tq, tk, tv, dropout_rate=0.1)

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    ref = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    dout = torch.from_numpy(np.random.RandomState(3).randn(*out.shape).astype(np.float32))
    for fn, (a, b, c) in ((fused_attention, leaves), (fused_attention_plain, ref)):
        (fn(a, b, c, **targs, dropout_rate=0.3, dropout_seed=seed) * dout).sum().backward()
    for l, r in zip(leaves, ref):
        np.testing.assert_allclose(l.grad.numpy(), r.grad.numpy(), rtol=1e-4, atol=1e-5)


BWD_CASES = {
    "bias_gate_pad": dict(),
    "bias_pad": dict(gate=False),
    "pad_only": dict(bias=False, gate=False),
    "attn_mask": dict(amask=True),
    "ragged_t": dict(T=97),
}


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_matches_pallas(case, layout):
    """The plain merged backward (dq, dk, dv, dbias, dgate) against jax.grad
    through the Pallas kernels (interpret mode) in both layouts, fp32:
    rtol 1e-4 / atol 1e-5 of the gradient's scale (the same function summed
    in other orders, through exp and the softmax Jacobian)."""
    H, hd = layout
    q, k, v, args = _make(H=H, hd=hd, **BWD_CASES[case])
    dout = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    bias, gate = args["bias"], args["gate"]
    jkw = {n: None if a is None else jnp.asarray(a) for n, a in args.items()
           if n in ("key_padding_mask", "attn_mask")}
    diff = [jnp.asarray(a) for a in (q, k, v)] + [
        jnp.asarray(a) for a in (bias, gate) if a is not None]

    def jloss(*xs):
        qq, kk, vv = xs[:3]
        bb = xs[3] if bias is not None else None
        gg = xs[4] if gate is not None else None
        return jnp.sum(jax_fused(qq, kk, vv, bb, gg, interpret=True, **jkw) * dout)

    want = jax.grad(jloss, argnums=tuple(range(len(diff))))(*diff)
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = fused_attention_plain(tq, tk, tv, **targs, return_lse=True)
    got = fused_attention_backward_plain(
        tq, tk, tv, targs["bias"], targs["gate"], targs["key_padding_mask"],
        targs["attn_mask"], 0.0, None, out, lse, torch.from_numpy(dout))
    got = [g for g in got[:3]] + [g for g in got[3:] if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())

    # the op's autograd (the plain backward on the CPU) gives the same
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in diff]
    kw = dict(key_padding_mask=targs["key_padding_mask"], attn_mask=targs["attn_mask"])
    lb = leaves[3] if bias is not None else None
    lg = leaves[4] if gate is not None else None
    (fused_attention(*leaves[:3], lb, lg, **kw) * torch.from_numpy(dout)).sum().backward()
    for l, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(l.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_padded_bias_view_matches_pallas(layout):
    """compute_rel_pos_bias's (H, T, S) bias, a view of rows padded to 8
    keys (S = 97), through the plain forward and the op's backward (into the
    bucket table) against the Pallas kernels in interpret mode with the JAX
    package's bias, fp32: the forward at TOL, the gradients at rtol 1e-4 /
    atol 1e-5 of their scale, as above."""
    H, hd = layout
    T, buckets, max_dist = 97, 32, 64
    q, k, v, args = _make(T=T, H=H, hd=hd, bias=False)
    gate, kpm = args["gate"], args["key_padding_mask"]
    table = np.random.RandomState(5).randn(buckets, H).astype(np.float32)
    dout = np.random.RandomState(6).randn(*q.shape).astype(np.float32)

    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v, table)]
    bias = compute_rel_pos_bias(leaves[3], T, T, buckets, max_dist)
    assert bias.shape == (H, T, T) and bias.stride(1) == 104 and not bias.is_contiguous()
    got = fused_attention(*leaves[:3], bias, torch.from_numpy(gate),
                          key_padding_mask=torch.from_numpy(kpm))
    (got * torch.from_numpy(dout)).sum().backward()

    def jloss(qq, kk, vv, tt):
        b = jax_rel_pos_bias(tt, T, T, buckets, max_dist)
        out = jax_fused(qq, kk, vv, b, jnp.asarray(gate), key_padding_mask=jnp.asarray(kpm),
                        interpret=True)
        return jnp.sum(out * dout), out

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (q, k, v, table)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for leaf, w in zip(leaves, grads):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("hd", [16, 24, 36, 64, 80, 120])
def test_bf16_prescaled_q_matches_jax(hd):
    """In bf16, q as the kernels read it times the scale they fold in is,
    bit for bit, the JAX wrapper's pre-scaled q, bf16(q * bf16(hd**-0.5)):
    q itself and the scale where that is a power of two (hd 16, 64), else
    the rounded product and 1. The plain bf16 forward (which the kernels
    are held to on the card) against the Pallas kernel in bf16, interpret
    mode: within 2 bf16 ulps of the output's scale (both round P to bf16,
    against a running max in the kernel, the final one in the plain
    version)."""
    q, k, v, args = _make(B=2, T=40, H=2, hd=hd)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_qs = np.asarray((jq * jnp.asarray(hd ** -0.5, jnp.bfloat16)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    kq, kscale = kernel_q(tq)
    assert kq.dtype == torch.bfloat16
    assert (kscale != 1.0) == (hd in (16, 64))
    np.testing.assert_array_equal((kq.float() * kscale).numpy(), want_qs)

    jargs = {n: None if a is None else jnp.asarray(a) for n, a in args.items()}
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    want = np.asarray(jax_fused(jq, jk, jv, interpret=True, **jargs).astype(jnp.float32))
    got = fused_attention(tq, tk, tv, **targs).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * np.abs(want).max()


def test_kernel_head_dim_contract():
    """The wrapper's guard and padding on CPU tensors: every multiple of 8
    from 8 to 128 goes to the kernels as it is; another hd <= 128 runs on a
    copy zero-padded to the next multiple of 8; above 128 raises."""
    def q_of(hd):
        return torch.zeros(1, 8, 2, hd, dtype=torch.bfloat16)

    for hd in range(8, MAX_HEAD_DIM + 1, 8):
        assert kernel_head_dim(hd) == hd
        q = q_of(hd)
        _check_cuda(q, q, q, None, None, None, None, None)
    for hd, want in ((1, 8), (36, 40), (100, 104), (127, 128)):
        assert kernel_head_dim(hd) == want
        with pytest.raises(ValueError):  # unpadded: rows are not whole 16-byte units
            _check_cuda(q_of(hd), q_of(hd), q_of(hd), None, None, None, None, None)
        q = pad_head(q_of(hd), want)
        _check_cuda(q, q, q, None, None, None, None, None)
    for hd in (136, 192):
        with pytest.raises(ValueError):
            kernel_head_dim(hd)
        with pytest.raises(ValueError):
            _check_cuda(q_of(hd), q_of(hd), q_of(hd), None, None, None, None, None)


def test_padded_head_dim_route_matches_plain():
    """hd 36 as the CUDA wrapper runs it: q pre-scaled (36**-0.5 is not a
    power of two, so the kernels take scale 1), q/k/v zero-padded to 40
    columns, the kernels' function on the copy (fp32 products times that
    scale, the gated bias and the key mask, softmax, P.V), the output
    sliced back to 36 columns: the plain version of the unpadded inputs at
    TOL, and zeros in the padded columns."""
    q, k, v, args = _make(B=2, T=40, H=2, hd=36)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    targs = {n: None if a is None else torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    kq, kscale = kernel_q(tq)
    assert kscale == 1.0 and kernel_head_dim(36) == 40
    qp, kp, vp = (pad_head(t, 40) for t in (kq, tk, tv))
    assert qp.shape == (2, 40, 2, 40) and not qp[..., 36:].any() and not vp[..., 36:].any()
    s = torch.einsum("bthd,bshd->bhts", qp, kp) * kscale
    s = s + targs["gate"][..., None] * targs["bias"][None]
    s = s + torch.where(targs["key_padding_mask"], -1e30, 0.0)[:, None, None, :]
    out = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), vp)
    assert not out[..., 36:].any()
    want = fused_attention_plain(tq, tk, tv, **targs)
    np.testing.assert_allclose(out[..., :36].numpy(), want.numpy(), rtol=TOL, atol=TOL)
