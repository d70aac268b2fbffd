"""T5-style bucketed relative position bias (WavLM variant).

The bias is computed once per forward and shared by all layers; each layer
applies its own query-conditioned gate (ops/attention.py). bias[h, t, s]
depends only on the diagonal s - t, so the T+S-1 per-diagonal values are
looked up from the table, cast, and expanded by a direct (T, S) index.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def relative_position_bucket(
    relative_position: torch.Tensor,
    num_buckets: int,
    max_distance: int,
    bidirectional: bool = True,
) -> torch.Tensor:
    """Map signed relative positions to bucket ids (int32): half the buckets
    per sign, exact buckets up to ``num_buckets//4``, then log-spaced up to
    ``max_distance``."""
    n = relative_position.to(torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets = num_buckets // 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)

    max_exact = num_buckets // 2
    is_small = n < max_exact

    # log-bucketed for large distances, in fp32 like the reference; log(0)
    # is guarded with a floor of 1 (those lanes take the is_small branch)
    n_safe = torch.clamp(n, min=1).to(torch.float32)
    val_if_large = max_exact + (
        torch.log(n_safe / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)  # truncation toward zero
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class _ExpandDiagonals(torch.autograd.Function):
    """(H, T+S-1) per-diagonal values -> (H, T, W), W >= S, out[h, t, s] =
    rel[h, s - t + T - 1] for s < S (columns past S repeat the last
    diagonal). The backward sums each diagonal of the first S columns of the
    cotangent in fp32 (a skew by pad and reshape, then one sum over t) and
    rounds once to the values' dtype, as the JAX package's expansion does,
    instead of a scatter-add in the storage dtype."""

    @staticmethod
    def forward(ctx, rel, T: int, S: int, W: int):
        ctx.T, ctx.S = T, S
        return rel[:, _diagonal_index(T, S, W, rel.device)]

    @staticmethod
    def backward(ctx, g):
        T, S = ctx.T, ctx.S
        H, nd = g.shape[0], T + S - 1
        # flat index identity: t*(T+S-1) + s + (T-1) == t*(T+S) + (s - t + T - 1)
        flat = F.pad(F.pad(g[..., :S].float(), (0, nd - S)).reshape(H, T * nd), (T - 1, 1))
        return flat.reshape(H, T, T + S).sum(1)[:, :nd].to(g.dtype), None, None, None


def _diagonal_index(T: int, S: int, W: int, device) -> torch.Tensor:
    """(T, W) index of diagonal s - t + T - 1, columns past S clamped."""
    idx = (torch.arange(W, device=device)[None, :]
           - torch.arange(T, device=device)[:, None] + (T - 1))
    return idx.clamp_(max=T + S - 2)


def compute_rel_pos_bias(
    bias_table: torch.Tensor,  # (num_buckets, num_heads)
    query_length: int,
    key_length: int,
    num_buckets: int,
    max_distance: int,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Return the (num_heads, query_length, key_length) bias as a view of
    a buffer whose rows are padded to a multiple of 8 keys: whole 16-byte
    units of bf16, the layout the CUDA attention kernels read by TMA, so
    no per-call copy pads it. Made once per forward and shared by all
    layers."""
    T, S = query_length, key_length
    dev = bias_table.device
    rel_pos = torch.arange(T + S - 1, device=dev, dtype=torch.int32) - (T - 1)
    buckets = relative_position_bucket(rel_pos, num_buckets, max_distance)
    rel = bias_table[buckets.long()].t()  # (H, T+S-1), diagonal d = s - t
    if dtype is not None:
        rel = rel.to(dtype)  # cast the small diagonal vector, not (H, T, S)
    W = -(-S // 8) * 8
    if torch.is_grad_enabled() and rel.requires_grad:
        return _ExpandDiagonals.apply(rel, T, S, W)[..., :S]
    return rel[:, _diagonal_index(T, S, W, dev)][..., :S]
