"""The error rule for fp32 sums that the kernels take in a run-dependent order.

The fp32 kernels add some outputs by fp32 atomics, whose order changes from
run to run: the L1 and conv-block weight gradients over the rows, the conv
blocks' da/db over time, the attention's dbias over the batch and dgate
over the keys. Such an output is held to its plain version per element
within ``SUM_RTOL`` of the sum of its terms' magnitudes, which bounds what
adding the same terms in another order can move it. The ``*_terms``
functions give that sum of |terms| from the inputs the kernel and its plain
version take; they are plain PyTorch and run on any device. The card tests
and ``chip_smoke.py`` both hold the kernels to this rule.
"""

from __future__ import annotations

import torch

from unispeech_tpu_torch.ops.kernels import conv_stack, flash_attention, l1_frontend

SUM_RTOL = 1e-5


def sum_error(got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor) -> float:
    """The largest |got - want| per element over its sum of |terms|; the
    rule holds where this is at most ``SUM_RTOL``."""
    diff = (got.float() - want.float()).abs()
    return float((diff / terms.float().clamp_min(1e-30)).max())


def l1_terms(wav, w1, stride, dy, ds1, ds2):
    """The sum of |terms| of the fp32 L1 weight gradient, (k, 1, C)."""
    k = w1.shape[0]
    d = dy.float()
    if ds1 is not None:
        d = d + ds1[:, None, :]
    if ds2 is not None:
        y1 = l1_frontend.l1_conv_with_stats_plain(wav, w1, stride, torch.float32)[0]
        d = d + 2.0 * ds2[:, None, :] * y1
    windows = wav.unfold(1, k, stride)[:, :dy.shape[1]]
    return torch.einsum("btj,btc->jc", windows.abs(), d.abs())[:, None, :]


def conv_terms(x, w, valid, gelu_in, gelu_out, ab, dy, pre, dx):
    """The sums of |terms| of the fp32 conv block backward's sums: dW (k, C,
    C), and da, db (B, C) with the affine (None without); ``dx`` is the
    plain version's."""
    k, C = w.shape[0], x.shape[2]
    t_out = dy.shape[1]
    _, h = conv_stack._block_input(x, valid, gelu_in, ab)
    g = (conv_stack.dgelu(pre) * dy if gelu_out else dy).abs().reshape(-1, C)
    h = h.float().abs()
    dw = torch.stack([h[:, p:p + 2 * t_out:2].reshape(-1, C).t() @ g for p in range(k)])
    if ab is None:
        return dw, None, None
    dxh = (dx[:, :valid] / ab[0][:, None, :]).abs()
    return dw, (dxh * x[:, :valid].abs()).sum(1), dxh.sum(1)


def attn_terms(q, k, v, bias, gate, kpm, amask, rate, seed, out, lse, dout):
    """The sums of |terms| of the fp32 attention backward's dbias (H, T, S)
    over the batch and dgate (B, H, T) over the keys, dS's own terms
    expanded: dS = p (c dP - delta) with dP and delta sums over the head
    dim, whose products nearly cancel where c dP ~ delta."""
    s, _ = flash_attention._logits(q, k, bias, gate, kpm, amask)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dout.float().abs(), v.float().abs())
    delta = (dout.float() * out.float()).abs().sum(-1).permute(0, 2, 1)[..., None]
    c = flash_attention._keep_scale(q, k, rate, seed)
    ds = p * (dp + delta) if c is None else p * (c * dp + delta)
    g = gate.float().abs()[..., None] if gate is not None else 1.0
    return (g * ds).sum(0), (ds * bias.float()[None].abs()).sum(-1)
