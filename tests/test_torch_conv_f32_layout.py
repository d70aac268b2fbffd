"""The operand layouts the fp32 conv-block kernels read, on the CPU.

The GEMMs of ``csrc/conv_stack_f32.cu`` read their operands where they lie
instead of the plain version's ``conv1d``: the forward the stride-2 windows
of H in place times the weight as (C_out, k C_in); dx, per input-row
parity, g's rows shifted by the tap times W_p as stored; dW, H's rows 2t + p
against g's rows in (utterance, 32-row) steps, split into ranges of steps
whose sums add up. Each product is formed here with torch, with the
wrapper's own ``gemm_weight`` and ``dw_split_plan`` and the kernel's
windows and parity taps written out below, for every form of the block (the
first block's affine + input GELU, a plain block, the layer_norm
extractor's input GELU without output GELU), k in {2, 3}, and a full and a
short odd ``valid`` (the last input row of parity 0). Each is held against
the plain versions (``conv_gelu_block_plain``,
``conv_gelu_block_backward_plain``) and against the Pallas block in
interpret mode (forward) and jax.grad through it (backward).

Tolerances: against the plain versions the card's fp32 gates (relative L2
1e-5 and max abs 1e-4 of max |plain| for the products: the same fp32
products summed in another order; dW, da and db within 1e-5 of the sum of
|terms|, ops/kernels/sum_terms.py); against the Pallas block atol 1e-3 of
the output's scale (its GELU and GELU' are clamped polynomials, off by up
to 5e-4 and 1.5e-4; test_torch_conv_stack.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unispeech_tpu.ops.pallas.conv_stack import conv_gelu_block as jax_block
from unispeech_tpu_torch.ops.kernels import conv_stack
from unispeech_tpu_torch.ops.kernels.sum_terms import SUM_RTOL, conv_terms, sum_error
from unispeech_tpu_torch.scripts import exp_conv_f32_variants

B, T, C = 2, 300, 128
# (gelu_in, affine, gelu_out) of each form
FORMS = {"affine": (True, True, True), "plain": (False, False, True),
         "layer_norm": (True, False, False)}
CASES = [(f, k, v) for f in FORMS for k in (2, 3) for v in (T, 257)]
IDS = [f"{f}-k{k}-valid{v}" for f, k, v in CASES]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_f32(got, want):
    """The card's fp32 products' gate."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = got - want
    assert diff.norm().item() <= 1e-5 * want.norm().item()
    assert diff.abs().max().item() <= 1e-4 * want.abs().max().item()


def _close_pallas(got, want):
    """atol 1e-3 of the output's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-3 * max(1.0, float(np.abs(want).max())))


@functools.lru_cache(maxsize=None)
def _case(form, k, valid):
    """Inputs (numpy, from a seed), the plain forward and backward, and the
    Pallas block's y and jax.grad (dx, dW, da, db) through it."""
    gelu_in, use_affine, gelu_out = FORMS[form]
    rng = np.random.RandomState(k * 1000 + valid)
    x = rng.randn(B, T, C).astype(np.float32)
    w = (rng.randn(k, C, C) * (2.0 / (k * C)) ** 0.5).astype(np.float32)
    a = (rng.rand(B, C) + 0.5).astype(np.float32)
    b = (rng.randn(B, C) * 0.1).astype(np.float32)
    t_out = (valid - k) // 2 + 1
    dy = rng.randn(B, t_out, C).astype(np.float32)

    def jax_y(xx, ww, aa, bb):
        y, _ = jax_block(xx, ww, valid_len=valid, gelu_in=gelu_in, gelu_out=gelu_out, tile=128,
                         interpret=True, affine=(aa, bb) if use_affine else None)
        return y[:, :t_out]

    jargs = tuple(map(jnp.asarray, (x, w, a, b)))
    jy = np.asarray(jax_y(*jargs))
    jgrad = jax.grad(lambda *v: jnp.sum(jax_y(*v) * dy), argnums=(0, 1, 2, 3))(*jargs)
    tx, tw, tdy = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dy)
    aff = (torch.from_numpy(a), torch.from_numpy(b)) if use_affine else None
    y, _, pre = conv_stack.conv_gelu_block_plain(tx, tw, valid, gelu_in, gelu_out, aff,
                                                 return_pre=True)
    plain_bwd = conv_stack.conv_gelu_block_backward_plain(tx, tw, valid, gelu_in, gelu_out, aff,
                                                          tdy, pre)
    return dict(x=tx, w=tw, aff=aff, dy=tdy, t_out=t_out, y=y, pre=pre, bwd=plain_bwd, jy=jy,
                jgrad=[np.asarray(v) for v in jgrad], form=FORMS[form])


def forward_windows(h, t_out, k):
    """The forward GEMM's left operand without a copy: row (b, t) of the
    (B, t_out, k C) view is the k C contiguous values of H from row 2t (the
    kernel reads them through H's even/odd row views: tap 0 of row t is
    even row t, tap 1 odd row t, tap 2 even row t + 1)."""
    B, _, C = h.shape
    assert h.stride(2) == 1 and h.stride(1) == C
    return h.as_strided((B, t_out, k * C), (h.stride(0), 2 * C, 1), h.storage_offset())


# the dx kernel's contraction per input-row parity: row 2t' + par of dX^
# sums g[t' - shift] . W_tap^T over its (tap, shift)
DX_PARITY_TAPS = {2: {0: ((0, 0),), 1: ((1, 0),)}, 3: {0: ((0, 0), (2, 1)), 1: ((1, 0),)}}


def _g(c):
    """The backward's g as the g pass forms it (dy without the output GELU)."""
    return conv_stack.dgelu(c["pre"]) * c["dy"] if c["form"][2] else c["dy"]


@pytest.mark.parametrize("form,k,valid", CASES, ids=IDS)
def test_forward_windows_times_weight_t(form, k, valid):
    """pre = the (B, t_out, k C) windows of H in place . (C_out, k C_in)^T."""
    c = _case(form, k, valid)
    gelu_in, _, gelu_out = c["form"]
    _, h = conv_stack._block_input(c["x"], valid, gelu_in, c["aff"])
    pre = forward_windows(h, c["t_out"], k) @ conv_stack.gemm_weight(c["w"]).t()
    _close_f32(pre, c["pre"])
    y = torch.nn.functional.gelu(pre) if gelu_out else pre
    _close_f32(y, c["y"])
    _close_pallas(y, c["jy"])


@pytest.mark.parametrize("form,k,valid", CASES, ids=IDS)
def test_dx_parity_gather_times_w_as_stored(form, k, valid):
    """dX^ of input row 2t' + par = sum over the parity's (tap, shift) of
    g[t' - shift] . W_tap^T (W_tap as stored, [in][out]; g rows outside
    [0, t_out) zero), then the epilogue's gelu'(x^), da/db and the affine."""
    c = _case(form, k, valid)
    gelu_in, use_affine, _ = c["form"]
    x, w, t_out = c["x"], c["w"], c["t_out"]
    g = _g(c)
    tp = (T + 1) // 2
    dxh = torch.zeros(B, T, C)
    for par, taps in DX_PARITY_TAPS[k].items():
        tprime = torch.arange(tp)
        acc = torch.zeros(B, tp, C)
        for tap, shift in taps:
            src = tprime - shift
            ok = (src >= 0) & (src < t_out)
            rows = torch.zeros(B, tp, C)
            rows[:, ok] = g[:, src[ok]]
            acc += rows @ w[tap].t()
        r = 2 * tprime + par
        keep = r < T
        dxh[:, r[keep]] = acc[:, keep]
    dxh = dxh[:, :valid]
    xh, _ = conv_stack._block_input(x, valid, gelu_in, c["aff"])
    if gelu_in:
        dxh = dxh * conv_stack.dgelu(xh)
    dx = torch.zeros(B, T, C)
    want = c["bwd"]
    if use_affine:
        a = c["aff"][0]
        da, db = (dxh * x[:, :valid]).sum(1), dxh.sum(1)
        terms = conv_terms(x, w, valid, gelu_in, c["form"][2], c["aff"], c["dy"], c["pre"],
                           want[0])
        assert sum_error(da, want[2], terms[1]) <= SUM_RTOL
        assert sum_error(db, want[3], terms[2]) <= SUM_RTOL
        _close_pallas(da, c["jgrad"][2])
        _close_pallas(db, c["jgrad"][3])
        dxh = dxh * a[:, None, :]
    dx[:, :valid] = dxh
    _close_f32(dx, want[0])
    assert (dx[:, valid:] == 0).all()
    _close_pallas(dx, c["jgrad"][0])


@pytest.mark.parametrize("form,k,valid", CASES, ids=IDS)
def test_dw_split_ranges_sum(form, k, valid):
    """dW_p = the sum over the splits of dw_split_plan of H[rows 2t + p]^T .
    g[rows t] over each split's (utterance, 32-row) steps, rows past t_out
    zero; at the fewest SMs whose plan has a split across an utterance."""
    c = _case(form, k, valid)
    gelu_in, _, gelu_out = c["form"]
    t_out = c["t_out"]
    _, h = conv_stack._block_input(c["x"], valid, gelu_in, c["aff"])
    g = _g(c)
    step_rows = conv_stack.DW_STEP_ROWS
    nkb = -(-t_out // step_rows)

    def ranges(sms):
        per, splits = conv_stack.dw_split_plan(B, t_out, C, k, sms)
        assert per * (splits - 1) < B * nkb <= per * splits
        return [range(sp * per, min((sp + 1) * per, B * nkb)) for sp in range(splits)]

    crossing = lambda rs: any(len({s // nkb for s in r}) > 1 for r in rs)  # noqa: E731
    split_ranges = next(rs for rs in map(ranges, range(2, 64)) if crossing(rs))
    dw = torch.zeros(k, C, C)
    for p in range(k):
        for steps in split_ranges:
            part = torch.zeros(C, C)
            for step in steps:
                bq, t0 = divmod(step, nkb)
                t = torch.arange(t0 * step_rows, min((t0 + 1) * step_rows, t_out))
                part += h[bq, 2 * t + p].t() @ g[bq, t]
            dw[p] += part
    want = c["bwd"]
    terms = conv_terms(c["x"], c["w"], valid, gelu_in, gelu_out, c["aff"], c["dy"], c["pre"],
                       want[0])
    assert sum_error(dw, want[1], terms[0]) <= SUM_RTOL
    _close_pallas(dw, c["jgrad"][1])


@pytest.mark.parametrize("B_,t_out,C_,k,sms", [(6, 24583, 512, 3, 132), (3, 24583, 512, 3, 132),
                                               (6, 3072, 512, 2, 132), (2, 1, 128, 3, 132),
                                               (1, 20, 384, 2, 132), (4, 25599, 1024, 3, 114)])
def test_dw_split_plan(B_, t_out, C_, k, sms):
    """Every split gets steps, the splits cover them, and the blocks fill at
    least 70% of their last wave where the steps allow."""
    per, splits = conv_stack.dw_split_plan(B_, t_out, C_, k, sms)
    steps = B_ * -(-t_out // conv_stack.DW_STEP_ROWS)
    assert per >= 1 and 1 <= splits <= steps
    assert per * (splits - 1) < steps <= per * splits
    blocks = k * (C_ // conv_stack.TILE) ** 2 * splits
    assert blocks / (-(-blocks // sms) * sms) >= (0.7 if steps >= 4 * sms else 0.0)


@pytest.mark.parametrize("name", sorted(exp_conv_f32_variants.VARIANTS))
def test_exp_variants_match_the_source(name):
    """Each variant of ``scripts/exp_conv_f32_variants.py`` finds the text it
    replaces in ``csrc/conv_stack_f32.cu`` (it times the source as it is)."""
    source = (exp_conv_f32_variants.CSRC / "conv_stack_f32.cu").read_text()
    for old, new in exp_conv_f32_variants.VARIANTS[name]:
        assert source.count(old) == 1 and old != new
