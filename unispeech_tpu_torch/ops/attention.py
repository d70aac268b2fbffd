"""Multi-head self-attention with WavLM's gated relative position bias.

Plain functions on (B, T, ...) tensors; the modules in models/encoder.py own
the parameters. ``multihead_attention`` is the materialized reference path;
the fused kernel (ops/kernels/flash_attention.py) computes the same function
without a (B, H, T, S) tensor. The GRU gate is computed from the
pre-projection query activations reshaped into heads, as in the fast path
all published WavLM checkpoints were trained with.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from unispeech_tpu_torch.ops.kernels.philox import attention_keep


@functools.lru_cache(maxsize=None)
def scale_in_dtype(head_dim: int, dtype: torch.dtype) -> float:
    """``head_dim**-0.5`` rounded to ``dtype``: the JAX package multiplies q
    by a weakly typed scalar, which takes q's dtype first."""
    return float(torch.tensor(head_dim**-0.5, dtype=dtype))


def rel_pos_gate(
    x: torch.Tensor,  # (B, T, D) pre-projection attention input
    grep_w: torch.Tensor,  # (head_dim, 8)
    grep_b: torch.Tensor,  # (8,)
    grep_a: torch.Tensor,  # (1, H, 1, 1)
    num_heads: int,
) -> torch.Tensor:
    """Per-query gate multiplier (B, H, T) fp32 for the shared rel-pos bias:
    gate = gate_a * (gate_b * grep_a - 1) + 2, gates from a sigmoid of a
    per-head linear projection of the query activations."""
    B, T, D = x.shape
    hd = D // num_heads
    q = x.reshape(B, T, num_heads, hd).transpose(1, 2)  # (B, H, T, hd)
    # fp32 island: sigmoid saturation is precision-sensitive
    proj = q.float() @ grep_w.float() + grep_b.float()  # (B, H, T, 8)
    r = proj.reshape(B, num_heads, T, 2, 4).sum(-1)
    gates = torch.sigmoid(r)
    gate_a, gate_b = gates[..., 0], gates[..., 1]
    ga = grep_a.float().reshape(1, num_heads, 1)
    return gate_a * (gate_b * ga - 1.0) + 2.0


def multihead_attention(
    q: torch.Tensor,  # (B, T, H, hd) projected, unscaled
    k: torch.Tensor,  # (B, S, H, hd)
    v: torch.Tensor,  # (B, S, H, hd)
    bias: Optional[torch.Tensor] = None,  # (B, H, T, S) or (H, T, S) additive
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    dropout_rate: float = 0.0,
    dropout_seed: Optional[torch.Tensor] = None,  # 1-element int64
) -> torch.Tensor:
    """Scaled dot-product attention, softmax in fp32, output (B, T, H, hd):
    scale q, logits + bias, padded keys to the fp32 minimum, fp32 softmax,
    dropout on the probabilities (the fused kernel's Philox mask of
    ``dropout_seed``)."""
    scale = scale_in_dtype(q.shape[-1], q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
    if bias is not None:
        if bias.dim() == 3:
            bias = bias[None]
        logits = logits + bias.float()
    if key_padding_mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], neg)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        B, H, T, S = probs.shape
        keep = attention_keep(dropout_seed.to(probs.device), B, H, T, S, dropout_rate)
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
