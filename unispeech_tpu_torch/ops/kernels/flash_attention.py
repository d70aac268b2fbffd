"""Fused attention with WavLM's gated relative position bias (forward).

Counterpart of the JAX package's ``ops/pallas/flash_attention.py`` forward:
softmax(q*scale . k^T + gate * bias + attn_mask - 1e30 * keypad) . v without
a (B, H, T, S) tensor in device memory. One CUDA kernel
(``csrc/flash_attention.cu``) reads q/k/v by strides in the natural
(B, T, H*hd) layout, which covers both of the TPU's layouts. CPU tensors take
the plain version below, which follows the kernel's arithmetic: bf16 P,
fp32 P.V, normalization by the fp32 row sum at the end.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unispeech_tpu_torch.ops.attention import scale_in_dtype
from unispeech_tpu_torch.ops.kernels import _build

launches = 0  # kernel launches made by fused_attention

NEG_INF = -1e30
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P] + [_L] * 8 + [_P] * 5 + [_I] * 4 + [ctypes.c_float, _P]


def _no_dropout(dropout_rate: float) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout belongs to the training slice, not yet ported")


def fused_attention_plain(q, k, v, bias=None, gate=None, key_padding_mask=None,
                          attn_mask=None, dropout_rate: float = 0.0,
                          return_lse: bool = False):
    """Plain version of ``fused_attention`` on any device."""
    _no_dropout(dropout_rate)
    B, T, H, hd = q.shape
    qs = q * scale_in_dtype(hd, q.dtype)
    s = torch.einsum("bthd,bshd->bhts", qs.float(), k.float())
    if bias is not None:
        g = gate.float()[..., None] if gate is not None else 1.0
        s = s + g * bias.to(q.dtype).float()[None]
    if attn_mask is not None:
        s = s + attn_mask.float()
    if key_padding_mask is not None:
        s = s + torch.where(key_padding_mask, NEG_INF, 0.0)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # (B, H, T, 1)
    acc = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def fused_attention(
    q: torch.Tensor,  # (B, T, H, hd) unscaled
    k: torch.Tensor,  # (B, S, H, hd)
    v: torch.Tensor,  # (B, S, H, hd)
    bias: Optional[torch.Tensor] = None,  # (H, T, S) shared rel-pos bias
    gate: Optional[torch.Tensor] = None,  # (B, H, T) per-query gate
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    attn_mask: Optional[torch.Tensor] = None,  # (T, S) additive fp32
    dropout_rate: float = 0.0,
    return_lse: bool = False,
):
    """Attention with the factored gated bias; returns out (B, T, H, hd) and,
    with ``return_lse``, the fp32 log-sum-exp (B, H, T) as well. The bias is
    read in q's dtype and gated in fp32 (gate 1 when only a bias is given).
    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (bf16, hd 64) or raises. Dropout belongs to the training slice."""
    global launches
    if not q.is_cuda:
        return fused_attention_plain(q, k, v, bias, gate, key_padding_mask,
                                     attn_mask, dropout_rate, return_lse)
    _no_dropout(dropout_rate)
    B, T, H, hd = q.shape
    S = k.shape[1]
    req = _build.require
    req(hd == 64, f"attention kernel takes head dim 64, got {hd}")
    for name, t, rows in (("q", q, T), ("k", k, S), ("v", v, S)):
        req(t.dtype == torch.bfloat16 and t.device == q.device,
            f"{name} must be bf16 on q's device")
        req(t.shape == (B, rows, H, hd), f"{name} has shape {tuple(t.shape)}")
        req(t.stride(3) == 1 and t.stride(2) == hd and t.stride(1) % 8 == 0
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0,
            f"{name} must be a (B, T, H*hd) row layout with 16-byte aligned rows")
    ptrs = {}
    if bias is not None:
        bias = bias.to(torch.bfloat16)
        req(bias.shape == (H, T, S) and bias.is_contiguous() and bias.device == q.device,
            "bias must be a contiguous (H, T, S) tensor on q's device")
        ptrs["bias"] = bias.data_ptr()
    if gate is not None and bias is not None:  # a gate without a bias is unused
        gate = gate.to(torch.float32).contiguous()
        req(gate.shape == (B, H, T) and gate.device == q.device,
            "gate must be (B, H, T) on q's device")
        ptrs["gate"] = gate.data_ptr()
    if key_padding_mask is not None:
        req(key_padding_mask.dtype == torch.bool and key_padding_mask.shape == (B, S)
            and key_padding_mask.is_contiguous() and key_padding_mask.device == q.device,
            "key_padding_mask must be a contiguous (B, S) bool tensor on q's device")
        ptrs["kpm"] = key_padding_mask.data_ptr()
    if attn_mask is not None:
        attn_mask = attn_mask.to(torch.float32).contiguous()
        req(attn_mask.shape == (T, S) and attn_mask.device == q.device,
            "attn_mask must be (T, S) on q's device")
        ptrs["amask"] = attn_mask.data_ptr()
    out = torch.empty((B, T, H, hd), dtype=torch.bfloat16, device=q.device)
    lse = None
    if return_lse:
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        ptrs["lse"] = lse.data_ptr()
    fn = _build.function("usk_flash_attention_fwd", _SIGNATURE)
    _build.launch(
        fn, "fused_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        ptrs.get("bias"), ptrs.get("gate"), ptrs.get("kpm"), ptrs.get("amask"),
        ptrs.get("lse"), B, T, S, H, scale_in_dtype(hd, q.dtype), _build.stream(q))
    launches += 1
    return (out, lse) if return_lse else out
