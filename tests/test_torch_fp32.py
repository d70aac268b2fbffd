"""The fp32 forms of the port's forward kernels (the models' default dtype)
against the JAX Pallas kernels in interpret mode, on the CPU, where the
wrappers take their plain versions; and the wrappers' dtype contract through
their CUDA checkers, which read only shapes, dtypes and strides.

What the other files already hold in fp32 is not repeated here: the L1 op
with its sums, the conv block in the default extractor's forms, attention
at 2-4 heads of 16-80, and whole fp32 models against the JAX models.

Tolerances are the files' own: y1 rtol 1e-5 / atol 1e-6 (the same products
summed in another order, test_torch_l1_frontend.py); attention rtol/atol
2e-5 (test_torch_flash_attention.py's TOL); the conv block atol 1e-3
against the Pallas block, whose GELU is a clamped polynomial that differs
from exact erf by up to 5e-4, and rtol 2e-4 / atol 2e-5 against the XLA
math with exact erf (test_torch_conv_stack.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.models.encoder import strided_conv1d_as_matmul
from unispeech_tpu.ops.pallas.conv_stack import conv_gelu_block as jax_block
from unispeech_tpu.ops.pallas.flash_attention import fused_attention as jax_fused
from unispeech_tpu.ops.pallas.l1_frontend import l1_conv_with_stats as jax_l1
from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

ATTN_TOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ns", [2565, 3001, 700], ids=["aligned", "ragged", "short"])
@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4)])
def test_l1_no_sums_fp32_matches_pallas(ns, k, stride):
    """with_stats=False in fp32 (the layer_norm extractor at the models'
    default dtype): y1 fp32, no sums on either side."""
    rng = np.random.RandomState(ns + k)
    wav = rng.randn(2, ns).astype(np.float32)
    kern = (rng.randn(k, 1, 64) * 0.05).astype(np.float32)
    jy, js1, js2, jt1 = jax_l1(jnp.asarray(wav), jnp.asarray(kern), stride, dtype=jnp.float32,
                               tile=256, interpret=True, with_stats=False)
    y, s1, s2, t1 = l1_frontend.l1_conv_with_stats(torch.from_numpy(wav), torch.from_numpy(kern),
                                                   stride, dtype=torch.float32, with_stats=False)
    assert js1 is None and js2 is None and s1 is None and s2 is None
    assert t1 == jt1 and y.shape == (2, t1, 64) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy[:, :t1]), rtol=1e-5, atol=1e-6)


def _attention_inputs(B, T, H, hd, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    args = dict(
        bias=rng.randn(H, T, T).astype(np.float32),
        gate=(1.0 / (1.0 + np.exp(-rng.randn(B, H, T))) + 1.0).astype(np.float32),
        key_padding_mask=np.arange(T)[None, :] >= np.asarray([T, T - 29, 0])[:B, None],
    )
    return q, k, v, args


# WavLM-Large's layout (16 heads of 64) and HuBERT X-Large's head dim (80,
# padded to 128 on the card), with the gated bias, key padding and, in the
# second case, a third row whose keys are all padded
@pytest.mark.parametrize("B,T,H,hd", [(2, 70, 16, 64), (3, 45, 2, 80)],
                         ids=["large_16x64", "hd80_zero_row"])
def test_attention_fp32_matches_pallas(B, T, H, hd):
    """The rows with a key against the Pallas kernel. A row whose keys are
    all padded is uniform over its S keys (the mean of v), as the JAX XLA
    attention has it and the port's kernels keep it; the Pallas kernel
    spreads such a row over its tile-padded keys, whose v rows are zero."""
    q, k, v, args = _attention_inputs(B, T, H, hd, seed=T + hd)
    targs = {n: torch.from_numpy(np.asarray(a)) for n, a in args.items()}
    got, lse = flash_attention.fused_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), **targs, return_lse=True)
    assert got.dtype == torch.float32 and lse.dtype == torch.float32
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                     **{n: jnp.asarray(a) for n, a in args.items()})
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    if B == 3:
        np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(v[2].mean(0), got[2].shape),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("valid_len", [300, 257], ids=["full", "short_valid"])
def test_conv_block_layer_norm_form_fp32_matches_jax(k, valid_len):
    """The block as the layer_norm extractor runs it (input GELU, no affine,
    no output GELU) in fp32."""
    rng = np.random.RandomState(k + valid_len)
    x = rng.randn(2, 300, 64).astype(np.float32)
    w = (rng.randn(k, 64, 64) * 0.05).astype(np.float32)
    jy, jt = jax_block(jnp.asarray(x), jnp.asarray(w), valid_len=valid_len, gelu_in=True,
                       gelu_out=False, tile=128, interpret=True)
    y, t_out = conv_stack.conv_gelu_block(torch.from_numpy(x), torch.from_numpy(w),
                                          valid_len=valid_len, gelu_in=True, gelu_out=False)
    assert t_out == jt == (valid_len - k) // 2 + 1 and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy[:, :t_out]), atol=1e-3)
    h = jax.nn.gelu(jnp.asarray(x[:, :valid_len]), approximate=False)
    ref = strided_conv1d_as_matmul(h, jnp.asarray(w), 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# (compute dtype, weights dtype): fp32 or bf16 compute with fp32 weights (the
# models' parameters) or weights already in the compute dtype; fp16 compute,
# and bf16 weights under fp32 compute (a mixed input), are rejected
DTYPE_CASES = [(F32, F32, True), (BF16, F32, True), (BF16, BF16, True), (F16, F32, False),
               (F16, F16, False), (F32, BF16, False)]
DTYPE_IDS = ["fp32", "bf16_fp32_weights", "bf16", "fp16", "fp16_fp16_weights", "fp32_bf16_weights"]


@pytest.mark.parametrize("dtype,w_dtype,ok", DTYPE_CASES, ids=DTYPE_IDS)
def test_l1_dtype_contract(dtype, w_dtype, ok):
    wav = torch.zeros(2, 400)
    kern = torch.zeros(10, 1, 64, dtype=w_dtype)
    if ok:
        *_, w = l1_frontend._geometry_cuda(wav, kern, 5, dtype)
        assert w.dtype == dtype and w.shape == (10, 64)
    else:
        with pytest.raises(ValueError):
            l1_frontend._geometry_cuda(wav, kern, 5, dtype)
    with pytest.raises(ValueError):  # the waveform stays fp32
        l1_frontend._geometry_cuda(wav.to(BF16), kern, 5, dtype)


@pytest.mark.parametrize("dtype,w_dtype,ok", DTYPE_CASES, ids=DTYPE_IDS)
def test_conv_block_dtype_contract(dtype, w_dtype, ok):
    x = torch.zeros(2, 64, 128, dtype=dtype)
    kern = torch.zeros(3, 128, 128, dtype=w_dtype)
    affine = (torch.ones(2, 128), torch.zeros(2, 128))
    if ok:
        *_, w, ab = conv_stack._check_cuda(x, kern, 64, affine)
        assert w.dtype == dtype and all(t.dtype == F32 for t in ab)
    else:
        with pytest.raises(ValueError):
            conv_stack._check_cuda(x, kern, 64, affine)


@pytest.mark.parametrize("dtypes,ok", [
    ((F32, F32, F32), True), ((BF16, BF16, BF16), True), ((F16, F16, F16), False),
    ((F32, BF16, F32), False), ((BF16, BF16, F32), False), ((F32, F32, F16), False),
], ids=["fp32", "bf16", "fp16", "fp32_q_bf16_k", "bf16_qk_fp32_v", "fp32_qk_fp16_v"])
def test_attention_dtype_contract(dtypes, ok):
    B, T, H, hd = 2, 24, 2, 64
    q, k, v = (torch.zeros(B, T, H, hd, dtype=d) for d in dtypes)
    bias = torch.zeros(H, T, T, dtype=dtypes[0])
    gate = torch.ones(B, H, T)
    kpm = torch.zeros(B, T, dtype=torch.bool)
    call = lambda bias: flash_attention._check_cuda(q, k, v, bias, gate, kpm, None, None)
    if ok:
        call(bias)
        with pytest.raises(ValueError):  # the bias comes in q's dtype
            call(bias.to(BF16 if dtypes[0] == F32 else F32))
    else:
        with pytest.raises(ValueError):
            call(bias)
