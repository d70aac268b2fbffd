"""Typed configuration dataclasses, field for field the JAX package's.

The port keeps its own copy (it imports nothing of the JAX package): the
same dataclasses, field names and defaults, so a config built on either side
compares equal under ``dataclasses.asdict``. Some fields name TPU-only
choices (Pallas tiles, scan/remat); the port ignores those, since they do
not change its math.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# Conv frontend spec: list of (dim, kernel, stride). Reference default
# "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2" -> 320x downsample.
DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


@dataclass(frozen=True)
class MaskConfig:
    """Span-mask sampling config (time or channel axis)."""

    mask_prob: float = 0.65
    mask_length: int = 10
    mask_selection: str = "static"  # static|uniform|normal|poisson
    mask_other: float = 0.0
    min_masks: int = 2


@dataclass(frozen=True)
class EncoderConfig:
    """Shared conv-frontend + transformer encoder configuration."""

    # conv feature extractor
    conv_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    extractor_mode: str = "default"  # default (groupnorm 1st block) | layer_norm
    conv_bias: bool = False
    feature_grad_mult: float = 1.0

    # transformer
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"  # gelu | gelu_accurate | relu | glu (GLU FFN)
    layer_norm_first: bool = False
    layer_norm_eps: float = 1e-5

    # dropouts
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    dropout_input: float = 0.0
    dropout_features: float = 0.0

    # conv positional embedding
    conv_pos: int = 128
    conv_pos_groups: int = 16

    # WavLM bucketed relative position bias (+ GRU gate)
    relative_position_embedding: bool = False
    num_buckets: int = 320
    max_distance: int = 1280
    gru_rel_pos: bool = False
    # q/k head-dim expansion (q/k project to H*expand, v keeps embed_dim/H)
    expand_attention_head_size: int = -1

    # per-utterance input normalization
    normalize: bool = False

    # iPQ quantization noise on encoder linears (training only)
    quant_noise_pq: float = 0.0
    quant_noise_pq_block_size: int = 8

    # fused attention kernel (the port: a CUDA kernel for CUDA tensors)
    use_flash_attention: bool = True
    attention_q_tile: int = 256  # TPU tile; the port's kernel fixes its own
    # fused conv-frontend blocks and the fused L1 + GroupNorm-stats pass
    use_fused_conv: bool = True
    use_fused_l1: bool = True

    # TPU layer stacking / rematerialization (JAX param-tree layout; the
    # port reads both the scanned and the unrolled trees)
    scan_layers: bool = True
    scan_unroll: bool = False
    remat_layers: bool = True
    remat_ffn: bool = True

    @property
    def frame_hop(self) -> int:
        hop = 1
        for _, _, s in self.conv_layers:
            hop *= s
        return hop

    @property
    def frame_receptive_field(self) -> int:
        rf = 1
        for _, k, s in reversed(self.conv_layers):
            rf = (rf - 1) * s + k
        return rf

    def num_frames(self, num_samples: int) -> int:
        t = num_samples
        for _, k, s in self.conv_layers:
            t = (t - k) // s + 1
        return t


def base_encoder_config(**over: Any) -> EncoderConfig:
    """WavLM/HuBERT Base shape: 12L/768d/12h/3072ffn."""
    return dataclasses.replace(EncoderConfig(), **over)


def override_encoder(enc: EncoderConfig, encoder_json: Optional[str]) -> EncoderConfig:
    """``enc`` with the fields an ``--encoder-json`` object names replaced
    (``conv_layers`` given as nested lists); ``enc`` itself without one."""
    if not encoder_json:
        return enc
    over = json.loads(encoder_json)
    if "conv_layers" in over:
        over["conv_layers"] = tuple(tuple(c) for c in over["conv_layers"])
    return dataclasses.replace(enc, **over)


def large_encoder_config(**over: Any) -> EncoderConfig:
    """Large shape: 24L/1024d/16h/4096ffn, layer_norm extractor, pre-LN."""
    cfg = EncoderConfig(
        encoder_layers=24,
        encoder_embed_dim=1024,
        encoder_ffn_embed_dim=4096,
        encoder_attention_heads=16,
        layer_norm_first=True,
        extractor_mode="layer_norm",
        normalize=True,
    )
    return dataclasses.replace(cfg, **over)


@dataclass(frozen=True)
class WavLMModelConfig:
    """Full WavLM(-style) model config wrapping the shared encoder."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    time_mask: MaskConfig = field(default_factory=MaskConfig)
    channel_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.0, mask_length=10, min_masks=0)
    )

    @staticmethod
    def from_reference_dict(d: dict) -> "WavLMModelConfig":
        """Build from a reference WavLM ``ckpt['cfg']`` dict."""
        enc_fields = {f.name for f in dataclasses.fields(EncoderConfig)}
        enc_kwargs = {k: v for k, v in d.items() if k in enc_fields}
        if "conv_feature_layers" in d:
            layers = d["conv_feature_layers"]
            if isinstance(layers, str):
                layers = eval_conv_spec(layers)
            enc_kwargs["conv_layers"] = tuple(tuple(l) for l in layers)
        enc = EncoderConfig(**enc_kwargs)
        tm = MaskConfig(
            mask_prob=d.get("mask_prob", 0.65),
            mask_length=d.get("mask_length", 10),
            mask_selection=d.get("mask_selection", "static"),
            mask_other=d.get("mask_other", 0.0),
            min_masks=2,
        )
        cm = MaskConfig(
            mask_prob=d.get("mask_channel_prob", 0.0),
            mask_length=d.get("mask_channel_length", 10),
            mask_selection=d.get("mask_channel_selection", "static"),
            mask_other=d.get("mask_channel_other", 0.0),
            min_masks=0,
        )
        return WavLMModelConfig(encoder=enc, time_mask=tm, channel_mask=cm)


@dataclass(frozen=True)
class GumbelVQConfig:
    """Gumbel-softmax vector quantizer config."""

    num_vars: int = 320  # V codewords per group
    groups: int = 2  # G groups
    vq_dim: int = 256  # output dim (split across groups)
    temp_start: float = 2.0
    temp_min: float = 0.5
    temp_decay: float = 0.999995
    weight_proj_depth: int = 1
    weight_proj_factor: int = 1

    def temp_at(self, num_updates):
        """max(temp_start * temp_decay ** num_updates, temp_min), as the JAX
        package computes it: in double precision for an int step, in fp32
        (an fp32 tensor) for a tensor step."""
        if hasattr(num_updates, "dtype"):
            import torch

            decay = torch.tensor(self.temp_decay, dtype=torch.float32,
                                 device=num_updates.device)
            return torch.clamp(self.temp_start * decay ** num_updates.float(),
                               min=self.temp_min)
        return max(self.temp_start * self.temp_decay**num_updates, self.temp_min)


@dataclass(frozen=True)
class HubertPretrainConfig:
    """Masked pseudo-label prediction pretraining (HuBERT / WavLM / ILS / SAT)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    time_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.8, mask_length=10)
    )
    channel_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.0, min_masks=0)
    )

    label_rate: float = 50.0
    sample_rate: int = 16000
    num_classes: Tuple[int, ...] = (504,)
    final_dim: int = 256
    logit_temp: float = 0.1
    untie_final_proj: bool = False
    target_glu: bool = False
    skip_masked: bool = False
    skip_nomask: bool = False

    predict_layers: Tuple[int, ...] = ()
    separate_label_embeds: bool = False
    separate_layer_targets: bool = False

    utterance_contrastive_loss: bool = False
    utterance_contrastive_layer: int = 6
    num_instances: int = 0
    cross_sample_instances: int = 100
    quantize_targets: bool = False
    quantizer: GumbelVQConfig = field(default_factory=GumbelVQConfig)

    @property
    def feat2tar_ratio(self) -> float:
        return self.label_rate * self.encoder.frame_hop / self.sample_rate


@dataclass(frozen=True)
class Wav2Vec2PretrainConfig:
    """wav2vec 2.0 contrastive pretraining, with the UniSpeech multitask
    extensions."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    time_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.65, mask_length=10)
    )
    channel_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.0, min_masks=0)
    )

    final_dim: int = 256
    logit_temp: float = 0.1
    quantize_targets: bool = True
    quantizer: GumbelVQConfig = field(default_factory=GumbelVQConfig)
    num_negatives: int = 100
    cross_sample_negatives: int = 0
    codebook_negatives: int = 0
    negatives_from_everywhere: bool = False
    target_glu: bool = False

    transpose: bool = False
    replace_prob: float = 0.5
    final_dropout: float = 0.1
    ctc_vocab_size: int = 0


def eval_conv_spec(spec: str) -> Tuple[Tuple[int, int, int], ...]:
    """Safely evaluate a conv layer spec string like
    "[(512,10,5)] + [(512,3,2)] * 4 + [(512,2,2)] * 2".
    Only list/tuple/int literals with + and * are allowed.
    """
    node = ast.parse(spec, mode="eval").body

    def ev(n):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            return ev(n.left) + ev(n.right)
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            left, right = ev(n.left), ev(n.right)
            if isinstance(left, list):
                return left * right
            return right * left
        if isinstance(n, ast.List):
            return [ev(e) for e in n.elts]
        if isinstance(n, ast.Tuple):
            return tuple(ev(e) for e in n.elts)
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        raise ValueError(f"disallowed node in conv spec: {ast.dump(n)}")

    out = ev(node)
    return tuple(tuple(l) for l in out)
