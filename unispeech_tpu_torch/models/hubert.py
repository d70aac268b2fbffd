"""Masked pseudo-label prediction pretraining: HuBERT / WavLM / ILS.

Counterpart of the JAX package's ``models/hubert.py``: cosine-similarity
logits of the projected encoder output against learned label embeddings, as
dense (B, T, C) fp32 logits per (layer, label set), weighted by the mask in
the loss (train/losses.py) instead of gathering the masked frames. ILS
(several ``predict_layers``, ``separate_label_embeds``) and
``untie_final_proj`` / ``target_glu`` are supported; the UniSpeech-SAT
speaker branch and ``quantize_targets`` are not ported yet.

The backbone's parameters sit at the top level of the state dict, beside
``final_proj*``, ``label_embs_concat`` and ``target_glu.0``, as the JAX
package's fairseq exporter names them (convert/from_jax.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unispeech_tpu_torch.configs import HubertPretrainConfig, WavLMModelConfig
from unispeech_tpu_torch.models.encoder import linear, not_in_slice, reset_parameters
from unispeech_tpu_torch.models.wavlm import WavLM


def cosine_logits(x: torch.Tensor, embs: torch.Tensor, logit_temp: float) -> torch.Tensor:
    """Dense cosine-similarity logits in fp32: (..., D) x (C, D) -> (..., C)."""
    xf, ef = x.float(), embs.float()
    xn = xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-12)
    en = ef * torch.rsqrt((ef * ef).sum(-1, keepdim=True) + 1e-12)
    return (xn @ en.t()) / logit_temp


class GLUProj(nn.Sequential):
    """target_glu: Linear(d, 2d) then a * sigmoid(b), in the model's dtype;
    the Linear is child ``0`` (key ``target_glu.0.weight``)."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__(nn.Linear(features, 2 * features))
        self.features = features
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear(x, self[0], self.dtype)
        a, b = y[..., :self.features], y[..., self.features:]
        return a * torch.sigmoid(b)


@dataclasses.dataclass
class HubertOutput:
    logits: Dict[Tuple[int, int], torch.Tensor]  # (layer, label set) -> (B, T, C_set) fp32
    targets: Optional[torch.Tensor]  # (B, T, num_sets) as passed in
    mask_indices: Optional[torch.Tensor]  # (B, T)
    padding_mask: Optional[torch.Tensor]  # (B, T)
    features_pen: torch.Tensor
    x: torch.Tensor  # final encoder output
    layer_outputs: Optional[torch.Tensor]
    layers_dropped: int = 0
    # the UniSpeech-SAT branch and the quantizer are not ported: always None
    spk_logits: Optional[torch.Tensor] = None
    vq_result: Optional[dict] = None


class HubertPretrainModel(WavLM):
    """WavLM backbone + masked-prediction heads. Parameters fp32, compute in
    ``dtype``; ``generator`` seeds the random init."""

    def __init__(self, cfg: HubertPretrainConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        if cfg.utterance_contrastive_loss:
            raise not_in_slice("the UniSpeech-SAT speaker branch")
        if cfg.quantize_targets:
            raise not_in_slice("quantize_targets (the Gumbel quantizer)")
        super().__init__(WavLMModelConfig(encoder=cfg.encoder, time_mask=cfg.time_mask,
                                          channel_mask=cfg.channel_mask),
                         dtype=dtype, generator=generator)
        self.pcfg = cfg
        D, final_dim = cfg.encoder.encoder_embed_dim, cfg.final_dim
        self.predict_layers = tuple(cfg.predict_layers) or (cfg.encoder.encoder_layers,)
        n_pred = len(self.predict_layers)
        n_tables = n_pred if (cfg.separate_label_embeds or cfg.separate_layer_targets) else 1
        self.n_tables = n_tables
        # the n_tables tables stacked along the rows, as the reference keeps them
        self.label_embs_concat = nn.Parameter(torch.empty(n_tables * sum(cfg.num_classes),
                                                          final_dim))
        proj_out = final_dim * (len(cfg.num_classes) if cfg.untie_final_proj else 1)
        if cfg.separate_label_embeds:
            self.final_proj = nn.ModuleList(nn.Linear(D, proj_out) for _ in range(n_pred))
        else:
            self.final_proj = nn.Linear(D, proj_out)
        self.target_glu = GLUProj(final_dim, dtype) if cfg.target_glu else None
        heads = [self.final_proj] + ([self.target_glu] if cfg.target_glu else [])
        for m in heads:
            reset_parameters(m, generator)
        with torch.no_grad():
            self.label_embs_concat.uniform_(0.0, 1.0, generator=generator)

    def forward(
        self,
        source: torch.Tensor,  # (B, T_samples)
        targets: Optional[torch.Tensor] = None,  # (B, T_frames, num_sets) int
        lengths: Optional[torch.Tensor] = None,
        mask: bool = True,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        boundary_mask: Optional[torch.Tensor] = None,
        features_only: bool = False,
        output_layer: Optional[int] = None,
    ) -> HubertOutput:
        cfg = self.pcfg
        L = cfg.encoder.encoder_layers
        need_taps = len(self.predict_layers) > 1 or self.predict_layers[0] != L
        out = super().forward(source, lengths=lengths, mask=mask, deterministic=deterministic,
                              collect_layer_outputs=need_taps, output_layer=output_layer,
                              boundary_mask=boundary_mask, generator=generator)
        res = dict(targets=targets, mask_indices=out.mask_indices,
                   padding_mask=out.padding_mask, features_pen=out.features_pen, x=out.x,
                   layers_dropped=out.layers_dropped)
        if features_only:
            return HubertOutput(logits={}, layer_outputs=out.layer_outputs, **res)

        final_dim = cfg.final_dim
        offsets = [0]
        for c in cfg.num_classes:
            offsets.append(offsets[-1] + c)
        logits: Dict[Tuple[int, int], torch.Tensor] = {}
        for li, p in enumerate(self.predict_layers):
            h = out.layer_outputs[p] if out.layer_outputs is not None else out.x
            proj = self.final_proj[li] if cfg.separate_label_embeds else self.final_proj
            px = linear(h, proj, self.dtype)
            total = offsets[-1]
            table = self.label_embs_concat[li * total:(li + 1) * total] if self.n_tables > 1 \
                else self.label_embs_concat
            for si in range(len(cfg.num_classes)):
                if cfg.separate_layer_targets:
                    embs = table[:cfg.num_classes[si]]
                else:
                    embs = table[offsets[si]:offsets[si + 1]]
                px_s = px[..., si * final_dim:(si + 1) * final_dim] if cfg.untie_final_proj \
                    else px
                if self.target_glu is not None:
                    embs = self.target_glu(embs)
                logits[(p, si)] = cosine_logits(px_s, embs, cfg.logit_temp)
        return HubertOutput(logits=logits,
                            layer_outputs=out.layer_outputs if need_taps else None, **res)
