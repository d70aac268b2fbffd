"""ECAPA-TDNN speaker verification head on frozen SSL features.

Counterpart of the JAX package's ``downstream/ecapa_tdnn.py`` (the
reference's ECAPA_TDNN_SMALL over a learnable weighted sum of every
encoder layer's output, scored by cosine similarity). The head runs in fp32
on the backbone's bf16 layer outputs. Modules and parameters carry the
flax tree's names (``layer2.Res2NetBlock_0.conv_1.weight`` is
``params/layer2/Res2NetBlock_0/conv_1/kernel``), so
``convert/from_jax.py`` maps a JAX head by renaming and transposing.

Two flax conventions are kept: ``BatchNorm``'s running variance moves
toward the *biased* batch variance (E[x^2] - E[x]^2 over batch and time,
padded frames included, momentum 0.1), where ``torch.nn.BatchNorm1d`` takes
the unbiased one; and ``pool_norm`` is a LayerNorm with eps 1e-6.
Random init draws from an explicit ``torch.Generator``: convs and dense
layers N(0, 1/fan_in) (flax's lecun-normal scale, untruncated), biases 0,
norms 1 and 0, running stats 0 and 1, layer weights 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unispeech_tpu_torch.ops import fp32_conv

FLAX_LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, in fp32: var = E[x^2] -
    E[x]^2 clipped at 0, eps 1e-6."""

    def __init__(self, dim: int, eps: float = FLAX_LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def lecun_init(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """N(0, 1/fan_in) weights, zero biases for every Conv1d and Linear in
    ``module``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                m.bias.zero_()


class WeightedLayerSum(nn.Module):
    """Softmax-weighted sum over (L, B, T, D) layer features, in fp32."""

    def __init__(self, num_layers: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(num_layers))

    def forward(self, layer_feats: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.weights, 0)
        return torch.einsum("l,lbtd->btd", w, layer_feats.float())


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over (B, C, T):
    statistics per channel over batch and time. In training mode it
    normalises by the batch's mean and biased variance and moves the
    running averages 0.1 of the way toward them; in eval mode it uses the
    running averages."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2))
            var = ((x * x).mean((0, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


def _conv(cin: int, cout: int, kernel: int = 1, dilation: int = 1) -> nn.Conv1d:
    # flax "SAME": (k - 1) * dilation padding split low-first, as torch's "same"
    return fp32_conv.Conv1d(cin, cout, kernel, dilation=dilation, padding="same")


class TdnnBn(nn.Module):
    """Conv1d + ReLU + BatchNorm."""

    def __init__(self, cin: int, features: int, kernel: int = 1, dilation: int = 1):
        super().__init__()
        self.Conv_0 = _conv(cin, features, kernel, dilation)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.BatchNorm_0(F.relu(self.Conv_0(x)))


class SEBlock(nn.Module):
    """Squeeze-excitation over channels: the time mean (padded frames
    included, as in JAX) gates each channel."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, bottleneck)
        self.Dense_1 = nn.Linear(bottleneck, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T)
        s = F.relu(self.Dense_0(x.mean(2)))
        return x * torch.sigmoid(self.Dense_1(s))[..., None]


class Res2NetBlock(nn.Module):
    """Res2Net multi-scale conv: the channels split into ``scale`` groups;
    group i is convolved after adding group i-1's output."""

    def __init__(self, channels: int, kernel: int = 3, dilation: int = 1, scale: int = 8):
        super().__init__()
        if channels % scale:
            raise ValueError(f"channels {channels} not divisible by scale {scale}")
        self.scale = scale
        w = channels // scale
        for i in range(1, scale):
            self.add_module(f"conv_{i}", _conv(w, w, kernel, dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.chunk(self.scale, 1)
        outs, y = [parts[0]], None
        for i in range(1, self.scale):
            y = F.relu(getattr(self, f"conv_{i}")(parts[i] if y is None else parts[i] + y))
            outs.append(y)
        return torch.cat(outs, 1)


class SERes2NetBlock(nn.Module):
    """TDNN -> Res2Net -> TDNN -> SE, with a residual (a 1x1 conv when the
    width changes)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, dilation: int = 1,
                 scale: int = 8):
        super().__init__()
        self.TdnnBn_0 = TdnnBn(cin, features)
        self.Res2NetBlock_0 = Res2NetBlock(features, kernel, dilation, scale)
        self.TdnnBn_1 = TdnnBn(features, features)
        self.SEBlock_0 = SEBlock(features)
        self.Conv_0 = _conv(cin, features) if cin != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.TdnnBn_1(self.Res2NetBlock_0(self.TdnnBn_0(x)))
        h = self.SEBlock_0(h)
        return h + (x if self.Conv_0 is None else self.Conv_0(x))


class AttentiveStatsPool(nn.Module):
    """Attention-weighted mean and standard deviation over time: padded
    frames get -1e9 before the fp32 softmax; the variance is clamped at
    1e-9 before the square root."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.Conv_0 = _conv(channels, bottleneck)
        self.Conv_1 = _conv(bottleneck, channels)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None):
        a = self.Conv_1(torch.tanh(self.Conv_0(x)))  # (B, C, T)
        if padding_mask is not None:
            a = a.masked_fill(padding_mask[:, None, :], -1e9)
        w = torch.softmax(a.float(), dim=2)
        mean = (w * x).sum(2)
        var = (w * x * x).sum(2) - mean * mean
        return torch.cat([mean, torch.sqrt(var.clamp_min(1e-9))], -1)


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    channels: int = 512
    emb_dim: int = 192
    scale: int = 8
    num_layer_feats: int = 13  # L+1 encoder taps for the weighted sum


class EcapaTdnn(nn.Module):
    """ECAPA-TDNN-small over (L, B, T, feat_dim) SSL layer features; fp32.
    ``forward`` returns (B, emb_dim) embeddings. ``train()`` mode runs the
    BatchNorms on batch statistics and updates their running averages."""

    def __init__(self, cfg: EcapaConfig, feat_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        C = cfg.channels
        self.featurizer = WeightedLayerSum(cfg.num_layer_feats)
        self.layer1 = TdnnBn(feat_dim, C, kernel=5)
        self.layer2 = SERes2NetBlock(C, C, 3, 2, cfg.scale)
        self.layer3 = SERes2NetBlock(C, C, 3, 3, cfg.scale)
        self.layer4 = SERes2NetBlock(C, C, 3, 4, cfg.scale)
        self.mfa = _conv(3 * C, 3 * C)
        self.pool = AttentiveStatsPool(3 * C)
        self.pool_norm = LayerNorm(6 * C)
        self.embedding = nn.Linear(6 * C, cfg.emb_dim)
        lecun_init(self, generator)

    def forward(self, layer_feats: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.featurizer(layer_feats)  # (B, T, D) fp32
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[..., None], 0.0)
        x = x.transpose(1, 2)  # (B, D, T): the convs run over time
        h1 = self.layer1(x)
        h2 = self.layer2(h1)
        h3 = self.layer3(h2)
        h4 = self.layer4(h3)
        h = F.relu(self.mfa(torch.cat([h2, h3, h4], 1)))
        pooled = self.pool_norm(self.pool(h, padding_mask))
        return self.embedding(pooled)


def cosine_score(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """Trial score: the cosine of two embeddings (along the last axis)."""
    a = emb1 / torch.linalg.vector_norm(emb1, dim=-1, keepdim=True)
    b = emb2 / torch.linalg.vector_norm(emb2, dim=-1, keepdim=True)
    return (a * b).sum(-1)


def compute_eer(scores, labels) -> float:
    """Equal error rate over trial scores (labels 1 = same speaker)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores)
    labels = labels[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    fnr = 1.0 - tp / max(tp[-1], 1)
    fpr = fp / max(fp[-1], 1)
    i = np.nanargmin(np.abs(fnr - fpr))
    return float((fnr[i] + fpr[i]) / 2)
