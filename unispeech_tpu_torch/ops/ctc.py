"""CTC loss and greedy decoding.

Counterpart of the JAX package's ``ops/ctc.py``: log-softmax over the
vocabulary in fp32, blank index 0 (the dictionary's bos), a sum over the
batch, and zero-infinity per sequence, as fairseq's CTC criterion. The JAX
package runs optax's log-semiring scan; CTC is no TPU kernel there, so the
port calls ``F.ctc_loss``.

One reading differs on purpose: optax floors impossible paths at -1e5, not
-inf, so a row whose labels cannot fit its frames comes out near 1e5 and
finite, and the JAX package keeps it in the sum. Here such a row gives 0,
the zero-infinity its criterion means.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor,  # (B, T, V) raw logits
             logit_lengths: torch.Tensor,  # (B,) valid frames
             labels: torch.Tensor,  # (B, S) padded with any value
             label_lengths: torch.Tensor,  # (B,) valid labels
             blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum-reduced CTC loss with zero-infinity; returns (loss, ntokens).

    Label positions past ``label_lengths`` are ignored, as are rows of
    length 0 (the zero-length padding rows of fixed-shape batches), whose
    loss is 0."""
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    per_seq = F.ctc_loss(log_probs, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=blank_id, reduction="none",
                         zero_infinity=True)
    return per_seq.sum(), label_lengths.sum()


def greedy_decode(logits: torch.Tensor,  # (B, T, V)
                  logit_lengths: torch.Tensor,  # (B,)
                  blank_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC collapse: argmax, drop repeats, drop blanks. Returns
    (tokens (B, T) padded with -1, lengths (B,))."""
    B, T, _ = logits.shape
    pred = logits.argmax(-1)
    valid = torch.arange(T, device=logits.device)[None, :] < logit_lengths[:, None]
    prev = F.pad(pred[:, :-1], (1, 0), value=-1)
    keep = (pred != blank_id) & (pred != prev) & valid
    # kept tokens go to their output positions, the rest to a spare column
    pos = torch.where(keep, keep.long().cumsum(1) - 1, torch.full_like(pred, T))
    tokens = torch.full((B, T + 1), -1, dtype=pred.dtype, device=logits.device)
    tokens.scatter_(1, pos, torch.where(keep, pred, torch.full_like(pred, -1)))
    return tokens[:, :T], keep.sum(1)
