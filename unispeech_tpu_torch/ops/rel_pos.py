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


def compute_rel_pos_bias(
    bias_table: torch.Tensor,  # (num_buckets, num_heads)
    query_length: int,
    key_length: int,
    num_buckets: int,
    max_distance: int,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Return the (num_heads, query_length, key_length) bias."""
    T, S = query_length, key_length
    dev = bias_table.device
    rel_pos = torch.arange(T + S - 1, device=dev, dtype=torch.int32) - (T - 1)
    buckets = relative_position_bucket(rel_pos, num_buckets, max_distance)
    rel = bias_table[buckets.long()].t()  # (H, T+S-1), diagonal d = s - t
    if dtype is not None:
        rel = rel.to(dtype)  # cast the small diagonal vector, not (H, T, S)
    diag = (
        torch.arange(S, device=dev)[None, :]
        - torch.arange(T, device=dev)[:, None]
        + (T - 1)
    )
    return rel[:, diag]
