"""Criterion layer: pure loss functions over model outputs.

Counterpart of the JAX package's ``train/losses.py``: each returns (loss sum,
sample_size, metrics) as tensors, weighted sums over static shapes with no
boolean indexing and no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
            + features_pen_weight * features_pen * sample_size
            + spk_loss_weight * loss_spk_m * sample_size
            + prob_ppl_weight * (V - prob_ppl) / V * sample_size,
    sample_size = number of masked valid frames; loss_spk_m is the SAT
    branch's BCE averaged over the masked frames' logits."""
    if out.mask_indices is None:
        raise ValueError("the criterion needs a masked forward")
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
    if out.spk_logits is not None and cfg.spk_loss_weight != 0.0:
        w = w_m[..., None]  # the BCE at masked frames only
        logits, tgts = out.spk_logits, out.spk_targets
        bce = torch.clamp(logits, min=0) - logits * tgts + torch.log1p(torch.exp(-logits.abs()))
        denom = torch.clamp(w.sum() * logits.shape[-1], min=1.0)
        loss_spk = (bce * w).sum() / denom
        loss = loss + cfg.spk_loss_weight * loss_spk * sample_size
        metrics["loss_spk_m"] = loss_spk
        metrics["contrastive_acc"] = (((logits >= 0) == (tgts > 0.5)).float() * w).sum() / denom
    if out.vq_result is not None and cfg.prob_ppl_weight != 0.0:
        loss = loss + _diversity(out.vq_result, cfg.prob_ppl_weight, sample_size, metrics)
    metrics["loss"] = loss
    metrics["sample_size"] = sample_size
    return loss, sample_size, metrics


def _diversity(vq_result: dict, weight: float, sample_size: torch.Tensor,
               metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The codebook-diversity term weight * (V - prob_ppl) / V * sample_size,
    with its metrics."""
    V = vq_result["num_vars"]
    div = (V - vq_result["prob_perplexity"]) / V
    metrics["loss_prob_perplexity"] = div
    metrics["code_perplexity"] = vq_result["code_perplexity"]
    metrics["prob_perplexity"] = vq_result["prob_perplexity"]
    return weight * div * sample_size


def wav2vec2_contrastive_loss(logits: torch.Tensor,  # (B, T, 1+N) fp32, column 0 positive
                              mask_weights: torch.Tensor,  # (B, T) {0, 1}
                              features_pen: torch.Tensor,
                              vq_result: Optional[dict],
                              features_pen_weight: float = 10.0,
                              prob_ppl_weight: float = 0.1
                              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """InfoNCE over the masked frames (the positive is class 0) plus the
    codebook-diversity and feature penalties, each scaled by sample_size."""
    targets = torch.zeros(logits.shape[:-1], dtype=torch.long, device=logits.device)
    loss_c, correct, count = _weighted_ce(logits, targets, mask_weights)
    sample_size = mask_weights.sum()
    loss = loss_c
    metrics = {"loss_contrastive": loss_c, "correct": correct, "count": count,
               "sample_size": sample_size}
    if vq_result is not None and prob_ppl_weight != 0.0:
        loss = loss + _diversity(vq_result, prob_ppl_weight, sample_size, metrics)
    if features_pen_weight != 0.0:
        fp = features_pen_weight * features_pen * sample_size
        loss = loss + fp
        metrics["loss_features_pen"] = fp
    metrics["loss"] = loss
    return loss, sample_size, metrics
