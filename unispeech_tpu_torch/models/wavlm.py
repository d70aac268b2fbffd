"""WavLM model for feature extraction: conv frontend + transformer encoder.

Counterpart of the JAX package's ``models/wavlm.py`` for ``mask=False,
deterministic=True``. Masking and dropout come with the training slice.
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
    linear,
    not_in_slice,
    reset_parameters,
)
from unispeech_tpu_torch.ops.masking import frame_padding_mask


@dataclasses.dataclass
class WavLMOutput:
    x: torch.Tensor  # (B, T, D) encoder output
    features: torch.Tensor  # (B, T, D) post-projection features
    conv_features: torch.Tensor  # (B, T, C) post-LN conv features
    padding_mask: Optional[torch.Tensor]  # (B, T) True = pad
    layer_outputs: Optional[torch.Tensor]  # (n+1, B, T, D)


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
    ) -> WavLMOutput:
        if mask:
            raise not_in_slice("span masking (mask=True)")
        if not deterministic:
            raise not_in_slice("dropout (deterministic=False)")
        enc = self.cfg.encoder
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

        feats = self.feature_extractor(source)
        padding_mask = None
        if lengths is not None:
            padding_mask = frame_padding_mask(lengths, source.shape[1], feats.shape[1])
        conv_features = self.layer_norm(feats)
        features = conv_features
        if self.post_extract_proj is not None:
            features = linear(conv_features, self.post_extract_proj, self.dtype)
        out = self.encoder(features, padding_mask=padding_mask,
                           collect_layer_outputs=collect_layer_outputs,
                           output_layer=output_layer, attn_mask=attn_mask)
        return WavLMOutput(x=out.x, features=features, conv_features=conv_features,
                           padding_mask=padding_mask, layer_outputs=out.layer_outputs)

    @torch.no_grad()
    def extract_features(self, source: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None,
                         output_layer: Optional[int] = None,
                         collect_layer_outputs: bool = False) -> WavLMOutput:
        """Inference-mode feature extraction."""
        return self(source, lengths=lengths, collect_layer_outputs=collect_layer_outputs,
                    output_layer=output_layer)
