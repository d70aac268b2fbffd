"""WavLM model: conv frontend + transformer encoder + masking.

Counterpart of the JAX package's ``models/wavlm.py``. Training
(``deterministic=False``) and masking (``mask=True``) draw their randomness
from an explicit host-side ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from unispeech_tpu_torch.configs import WavLMModelConfig
from unispeech_tpu_torch.models.encoder import (
    ConvFeatureExtractor,
    Fp32LayerNorm,
    TransformerEncoder,
    grad_multiply,
    linear,
    reset_parameters,
)
from unispeech_tpu_torch.ops.dropout import row_generator, row_seed, seed_dropout
from unispeech_tpu_torch.ops.masking import (
    apply_channel_mask,
    apply_time_mask,
    frame_padding_mask,
    sample_span_mask,
)


@dataclasses.dataclass
class WavLMOutput:
    x: torch.Tensor  # (B, T, D) encoder output
    features: torch.Tensor  # (B, T, D) post-projection features
    conv_features: torch.Tensor  # (B, T, C) post-LN conv features
    padding_mask: Optional[torch.Tensor]  # (B, T) True = pad
    layer_outputs: Optional[torch.Tensor]  # (n+1, B, T, D)
    mask_indices: Optional[torch.Tensor] = None  # (B, T) True = masked
    features_pen: Optional[torch.Tensor] = None  # mean square of the raw conv features
    layers_dropped: int = 0  # layers layerdrop skipped


class WavLM(nn.Module):
    """WavLM backbone. Parameters fp32, computation in ``dtype``; build on
    the CPU and move with ``.to(device)``. ``generator`` seeds the random
    init (the global generator when None)."""

    def __init__(self, cfg: WavLMModelConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        enc = cfg.encoder
        embed = enc.conv_layers[-1][0]
        D = enc.encoder_embed_dim
        self.feature_extractor = ConvFeatureExtractor(enc, dtype)
        self.layer_norm = Fp32LayerNorm(embed, enc.layer_norm_eps)
        self.post_extract_proj = nn.Linear(embed, D) if embed != D else None
        self.mask_emb = nn.Parameter(torch.empty(D))
        self.encoder = TransformerEncoder(enc, dtype)
        reset_parameters(self, generator)
        with torch.no_grad():
            self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def forward(
        self,
        source: torch.Tensor,  # (B, T_samples) waveform
        lengths: Optional[torch.Tensor] = None,  # (B,) valid sample counts
        mask: bool = False,
        deterministic: bool = True,
        collect_layer_outputs: bool = False,
        output_layer: Optional[int] = None,
        attn_mask: Optional[torch.Tensor] = None,  # (T, S) additive
        boundary_mask: Optional[torch.Tensor] = None,  # (B, T_frames) precomputed mask
        generator: Optional[torch.Generator] = None,  # host-side, for mask / dropout
    ) -> WavLMOutput:
        """``mask=True`` replaces span-sampled frames (or ``boundary_mask``,
        which overrides the sampler) by the mask embedding;
        ``deterministic=False`` runs dropout and layerdrop. Both draw from
        ``generator`` (a CPU torch.Generator)."""
        enc = self.cfg.encoder
        draws = (not deterministic) or (mask and (
            (boundary_mask is None and self.cfg.time_mask.mask_prob > 0)
            or self.cfg.channel_mask.mask_prob > 0))
        if draws and generator is None:
            raise ValueError("masking and dropout draw from an explicit generator")
        if enc.normalize:
            # per-utterance zero-mean unit-variance over the valid samples
            if lengths is None:
                mean = source.mean(-1, keepdim=True)
                var = source.var(-1, keepdim=True, unbiased=False)
            else:
                valid = (torch.arange(source.shape[1], device=source.device)[None, :]
                         < lengths[:, None])
                n = torch.clamp(lengths.to(source.dtype), min=1.0)[:, None]
                mean = (source * valid).sum(-1, keepdim=True) / n
                var = (((source - mean) * valid) ** 2).sum(-1, keepdim=True) / n
            source = (source - mean) * torch.rsqrt(var + 1e-5)
            if lengths is not None:
                source = source.masked_fill(~valid, 0.0)

        if enc.feature_grad_mult > 0:
            feats = self.feature_extractor(source)
            if enc.feature_grad_mult != 1.0:
                feats = grad_multiply(feats, enc.feature_grad_mult)
        else:
            # a frozen frontend (CTC fine-tuning) runs forward only
            with torch.no_grad():
                feats = self.feature_extractor(source)
        padding_mask = None
        if lengths is not None:
            padding_mask = frame_padding_mask(lengths, source.shape[1], feats.shape[1])

        # L2 penalty on the raw conv features, fp32, over the valid frames
        sq = feats.float() ** 2
        if padding_mask is None:
            features_pen = sq.mean()
        else:
            valid_f = (~padding_mask).float()[..., None]
            features_pen = (sq * valid_f).sum() / torch.clamp(
                valid_f.sum() * feats.shape[-1], min=1.0)

        conv_features = self.layer_norm(feats)
        features = conv_features
        if self.post_extract_proj is not None:
            features = linear(conv_features, self.post_extract_proj, self.dtype)
        if enc.dropout_input > 0.0 and not deterministic:
            features = seed_dropout(features, row_seed(generator), enc.dropout_input)

        mask_indices = None
        x = features
        B, T, C = features.shape
        if mask and boundary_mask is not None:
            mask_indices = boundary_mask.to(device=features.device, dtype=torch.bool)
            if padding_mask is not None:
                mask_indices = mask_indices & ~padding_mask
            x = apply_time_mask(features, mask_indices, self.mask_emb)
        elif mask and self.cfg.time_mask.mask_prob > 0:
            frame_lengths = None if padding_mask is None else (~padding_mask).sum(-1)
            mask_indices = sample_span_mask(row_generator(generator), B, T, self.cfg.time_mask,
                                            frame_lengths, device=features.device)
            x = apply_time_mask(features, mask_indices, self.mask_emb)
        if mask and self.cfg.channel_mask.mask_prob > 0:
            ch_mask = sample_span_mask(row_generator(generator), B, C, self.cfg.channel_mask, None,
                                       device=features.device)
            x = apply_channel_mask(x, ch_mask)

        out = self.encoder(x, padding_mask=padding_mask,
                           collect_layer_outputs=collect_layer_outputs,
                           output_layer=output_layer, attn_mask=attn_mask,
                           generator=None if deterministic else generator)
        return WavLMOutput(x=out.x, features=features, conv_features=conv_features,
                           padding_mask=padding_mask, layer_outputs=out.layer_outputs,
                           mask_indices=mask_indices, features_pen=features_pen,
                           layers_dropped=out.layers_dropped)

    @torch.no_grad()
    def extract_features(self, source: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None,
                         output_layer: Optional[int] = None,
                         collect_layer_outputs: bool = False) -> WavLMOutput:
        """Inference-mode feature extraction."""
        return self(source, lengths=lengths, collect_layer_outputs=collect_layer_outputs,
                    output_layer=output_layer)
