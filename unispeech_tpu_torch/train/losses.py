"""Criterion layer: pure loss functions over model outputs.

Counterpart of the JAX package's ``train/losses.py``: each returns (loss sum,
sample_size, metrics) as tensors, weighted sums over static shapes with no
boolean indexing and no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from unispeech_tpu_torch.models.hubert import HubertOutput


@dataclass(frozen=True)
class HubertCriterionConfig:
    """Mirrors the reference WavLM / HuBERT criterion config."""

    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    features_pen_weight: float = 10.0  # reference loss_weights=[10]
    spk_loss_weight: float = 0.0  # UniSpeech-SAT loss_spk_m weight
    prob_ppl_weight: float = 0.0  # diversity penalty when quantizing


def _weighted_ce(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum-reduced CE over weighted positions and the tie-aware accuracy
    count: argmax == target and not all logits equal (argmin != target)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = targets.long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    loss = (nll * weights).sum()
    pred = logits.argmax(-1)
    amin = logits.argmin(-1)
    correct = (((pred == tgt) & (amin != tgt)).float() * weights).sum()
    return loss, correct, weights.sum()


def hubert_loss(out: HubertOutput, cfg: HubertCriterionConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss = pred_masked_weight * sum_i CE_masked_i
            + pred_nomask_weight * sum_i CE_unmasked_i
            + features_pen_weight * features_pen * sample_size,
    sample_size = number of masked valid frames. The speaker-contrastive and
    codebook-diversity terms belong to branches not ported yet: their
    inputs must be absent."""
    if out.mask_indices is None:
        raise ValueError("the criterion needs a masked forward")
    if out.spk_logits is not None or out.vq_result is not None:
        raise NotImplementedError("the speaker-contrastive and quantizer terms are not "
                                  "ported to PyTorch yet")
    m = out.mask_indices.float()
    valid = torch.ones_like(m) if out.padding_mask is None else (~out.padding_mask).float()
    w_m, w_u = m * valid, (1.0 - m) * valid
    metrics: Dict[str, torch.Tensor] = {}
    sample_size = w_m.sum()
    loss_m = loss_u = torch.zeros((), device=m.device)
    for key_i, ((_, si), logits) in enumerate(sorted(out.logits.items())):
        tgt = out.targets[..., si]
        if cfg.pred_masked_weight > 0:
            lm, cm, nm = _weighted_ce(logits, tgt, w_m)
            loss_m = loss_m + lm
            metrics[f"loss_m_{key_i}"] = lm
            metrics[f"correct_m_{key_i}"] = cm
            metrics[f"count_m_{key_i}"] = nm
        if cfg.pred_nomask_weight > 0:
            lu, cu, nu = _weighted_ce(logits, tgt, w_u)
            loss_u = loss_u + lu
            metrics[f"loss_u_{key_i}"] = lu
            metrics[f"correct_u_{key_i}"] = cu
            metrics[f"count_u_{key_i}"] = nu
    loss = cfg.pred_masked_weight * loss_m + cfg.pred_nomask_weight * loss_u
    if cfg.features_pen_weight != 0.0:
        fp = cfg.features_pen_weight * out.features_pen * sample_size
        loss = loss + fp
        metrics["loss_features_pen"] = fp
    metrics["loss"] = loss
    metrics["sample_size"] = sample_size
    return loss, sample_size, metrics
