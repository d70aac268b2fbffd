"""Task glue: a loss function binding model and criterion.

Counterpart of the JAX package's ``train/tasks.py`` (``make_hubert_loss_fn``
only): ``loss_fn(batch, generator, step)`` returns (loss sum, sample_size,
metrics) of the model it binds (JAX passes the params; here the model holds
them).
"""

from __future__ import annotations

from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.train.losses import HubertCriterionConfig, hubert_loss


def make_hubert_loss_fn(model: HubertPretrainModel, crit: HubertCriterionConfig):
    """Masked-prediction pretraining objective (HuBERT / WavLM / ILS).

    batch: {"source": (B, n), "targets": (B, T, num_sets), optional
    "lengths": (B,), optional "boundary_mask": (B, T) precomputed mask that
    replaces the span sampler}. ``metrics`` gains ``layers_dropped``, the
    layers layerdrop skipped (a host int)."""

    def loss_fn(batch, generator, step):
        out = model(batch["source"], batch["targets"], batch.get("lengths"), mask=True,
                    deterministic=False, generator=generator,
                    boundary_mask=batch.get("boundary_mask"))
        loss, sample_size, metrics = hubert_loss(out, crit)
        metrics["layers_dropped"] = out.layers_dropped
        return loss, sample_size, metrics

    return loss_fn
