"""CTC fine-tuning head on a pretrained WavLM backbone (the ASR path).

Counterpart of the JAX package's ``models/ctc.py``: the backbone under the
name ``wavlm`` (state-dict keys ``wavlm.*``), SpecAugment-style time and
channel masks while training, no gradient into the conv frontend
(``feature_grad_mult = 0``), ``final_dropout`` and the ``proj`` linear to
fp32 logits. For ``step < freeze_finetune_updates`` the backbone runs
under ``torch.no_grad()``: the PyTorch form of the JAX package's
``stop_gradient`` on the encoder output, which also keeps no activations
and launches no backward kernel. The train step gives the frozen
parameters zero gradients, so AdamW's decay moves them as optax does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Union

import torch
from torch import nn

from unispeech_tpu_torch.configs import EncoderConfig, MaskConfig, WavLMModelConfig
from unispeech_tpu_torch.models.encoder import linear, reset_parameters
from unispeech_tpu_torch.models.wavlm import WavLM
from unispeech_tpu_torch.ops.dropout import row_seed, seed_dropout


@dataclass(frozen=True)
class CtcFinetuneConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    vocab_size: int = 32  # the letter dictionary; blank = index 0
    apply_mask: bool = True  # masks on the features while training
    time_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.65, mask_length=10))
    channel_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.5, mask_length=64, min_masks=0))
    final_dropout: float = 0.0
    freeze_finetune_updates: int = 0
    feature_grad_mult: float = 0.0  # the conv frontend stays frozen


@dataclass
class CtcOutput:
    logits: torch.Tensor  # (B, T, V) fp32
    padding_mask: Optional[torch.Tensor]  # (B, T) True = pad
    frame_lengths: torch.Tensor  # (B,) valid frames
    layers_dropped: int = 0  # layers layerdrop skipped


class CtcFinetuneModel(nn.Module):
    """Parameters fp32, compute in ``dtype``; ``generator`` seeds the init."""

    def __init__(self, cfg: CtcFinetuneConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        enc = dataclasses.replace(cfg.encoder, feature_grad_mult=cfg.feature_grad_mult)
        self.wavlm = WavLM(WavLMModelConfig(encoder=enc, time_mask=cfg.time_mask,
                                            channel_mask=cfg.channel_mask),
                           dtype=dtype, generator=generator)
        self.proj = nn.Linear(enc.encoder_embed_dim, cfg.vocab_size)
        reset_parameters(self.proj, generator)

    def frozen(self, step: int) -> bool:
        return step < self.cfg.freeze_finetune_updates

    def forward(self, source: torch.Tensor,  # (B, n_samples)
                lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                step: int = 0,
                generator: Optional[torch.Generator] = None) -> CtcOutput:
        """``deterministic=False`` masks (with ``apply_mask``) and runs
        dropout, drawing from ``generator`` (a CPU torch.Generator)."""
        cfg = self.cfg
        gate = torch.no_grad() if self.frozen(step) else contextlib.nullcontext()
        with gate:
            out = self.wavlm(source, lengths=lengths,
                             mask=cfg.apply_mask and not deterministic,
                             deterministic=deterministic, generator=generator)
        h = out.x
        if cfg.final_dropout > 0.0 and not deterministic:
            h = seed_dropout(h, row_seed(generator), cfg.final_dropout)
        logits = linear(h, self.proj, self.dtype).float()
        if out.padding_mask is not None:
            frame_lengths = (~out.padding_mask).sum(-1)
        else:
            frame_lengths = torch.full((source.shape[0],), h.shape[1], dtype=torch.long,
                                       device=h.device)
        return CtcOutput(logits=logits, padding_mask=out.padding_mask,
                         frame_lengths=frame_lengths, layers_dropped=out.layers_dropped)


def load_pretrained_into(model: nn.Module,
                         pretrained: Union[str, Mapping[str, torch.Tensor]]) -> None:
    """Graft a pretrained backbone into the ``wavlm`` backbone of ``model``
    (a CtcFinetuneModel, a Seq2SeqModel: any model with one) in place and
    drop the pretraining heads (``final_proj``, ``label_embs_concat``, ...).

    ``pretrained`` is a state dict, with the backbone's keys at the top
    level (a HubertPretrainModel's) or under ``wavlm.`` (a fine-tune
    model's), or the path of a params ``.npz`` in the JAX package's layout
    (a ``--export-params`` file). Backbone parameters the source lacks keep
    their values."""
    from unispeech_tpu_torch.convert.from_jax import (
        load_params_npz,
        wavlm_state_dict_from_jax,
    )

    if isinstance(pretrained, str):
        src = wavlm_state_dict_from_jax(load_params_npz(pretrained),
                                        model.wavlm.cfg.encoder)
    elif any(k.startswith("wavlm.") for k in pretrained):
        src = {k[len("wavlm."):]: v for k, v in pretrained.items() if k.startswith("wavlm.")}
    else:
        src = pretrained
    own = model.wavlm.state_dict()
    with torch.no_grad():
        for k, v in own.items():
            if k in src:
                if src[k].shape != v.shape:
                    raise ValueError(f"{k}: pretrained shape {tuple(src[k].shape)}, "
                                     f"model shape {tuple(v.shape)}")
                v.copy_(src[k])
