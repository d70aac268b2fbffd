"""Conv frontend + transformer encoder (WavLM / HuBERT skeleton).

Counterpart of the JAX package's ``models/encoder.py``. Parameters are fp32
and named in the fairseq/standalone-WavLM key layout, so a state dict carried
from the JAX params (convert/from_jax.py) loads with ``strict=True``;
computation runs in the model's ``dtype`` with the same explicit casts as the
JAX code (fp32 islands for the norms, GELU and the rel-pos gate). (B, T, C)
layout throughout.

The frontend keeps the fused structure of the JAX TPU path wherever the
config allows it: the first conv and its GroupNorm statistics in one op, the
GroupNorm folded into the next block as a (B, C) affine, and each
(k in {2,3}, s=2) layer as one conv+GELU block. In ``layer_norm`` mode
(WavLM-Large) the first conv runs without the sums and the blocks without
their output GELU; each layer's fp32 LayerNorm follows in plain code and its
GELU moves into the next block's input pass. Those three ops launch their
CUDA kernels for CUDA tensors and take their plain versions for CPU tensors,
in both directions.

Training (an encoder called with a ``generator``): dropout at the encoder
input, on both residual branches, after the FFN activation and on the
attention probabilities (in the fused kernel); with ``quant_noise_pq > 0``
iPQ noise on the attention projections and the FFN linears (a GLU ``fc1``
excepted, as in the JAX package); layerdrop skips a layer's
compute (its parameters then get no gradient, which the train step turns
into zeros); ``remat_ffn`` / ``remat_layers`` recompute the FFN / the whole
layer in the backward via ``torch.utils.checkpoint``. Every random draw
comes from the host-side generator before the layers run: the seeds are
arguments of the checkpointed functions, so a recompute draws the masks it
drew the first time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unispeech_tpu_torch.configs import EncoderConfig
from unispeech_tpu_torch.ops.attention import multihead_attention, rel_pos_gate
from unispeech_tpu_torch.ops.dropout import draw_seeds, seed_dropout
from unispeech_tpu_torch.ops.kernels.conv_stack import conv_gelu_block
from unispeech_tpu_torch.ops.kernels.flash_attention import fused_attention
from unispeech_tpu_torch.ops.kernels.l1_frontend import l1_conv_with_stats
from unispeech_tpu_torch.ops.rel_pos import compute_rel_pos_bias


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, gradient scaled by ``scale`` (feature_grad_mult)."""
    return _GradMultiply.apply(x, scale)


def gelu_fp32(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in fp32, returned in x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def gelu_accurate(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU in fp32."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def get_activation(name: str):
    acts = {
        "gelu": gelu_fp32,
        "gelu_accurate": gelu_accurate,
        "gelu_fast": gelu_accurate,
        "relu": F.relu,
        "swish": F.silu,
        "tanh": torch.tanh,
        "linear": lambda x: x,
        "glu": lambda x: x,  # the GLU feed-forward gates inside GLULinear
    }
    if name not in acts:
        raise ValueError(f"unknown activation {name}")
    return acts[name]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
           noise: Optional["QuantNoise"] = None) -> torch.Tensor:
    """Dense layer computed in ``dtype`` from fp32 parameters; with
    ``noise`` the weight carries iPQ quantization noise."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    weight = layer.weight if noise is None else noise.apply(layer.weight)
    return F.linear(x.to(dtype), weight.to(dtype), bias)


def quant_noise_blocks(seed: int, n_blocks: int, out_features: int, p: float,
                       device) -> torch.Tensor:
    """(n_blocks, out_features) bool, True where the block of input
    features of an output unit is dropped (probability ``p``): a pure
    function of its arguments, so a recompute draws the mask it drew the
    first time. The layout is the JAX package's draw (inputs first)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((n_blocks, out_features), generator=gen, device=device) < p


@dataclasses.dataclass(frozen=True)
class QuantNoise:
    """iPQ quantization noise of one linear in one training step: each
    output unit drops ``block_size``-wide blocks of its inputs with
    probability ``p``, and the whole weight is scaled by 1 / (1 - p)."""

    seed: int
    p: float
    block_size: int

    def apply(self, weight: torch.Tensor) -> torch.Tensor:  # (out, in)
        out_f, in_f = weight.shape
        if in_f % self.block_size:
            raise ValueError(f"{in_f} input features are not a multiple of the "
                             f"quant-noise block {self.block_size}")
        drop = quant_noise_blocks(self.seed, in_f // self.block_size, out_f, self.p,
                                  weight.device)
        mask = drop.repeat_interleave(self.block_size, dim=0).t()
        return torch.where(mask, torch.zeros((), dtype=weight.dtype, device=weight.device),
                           weight) / (1.0 - self.p)


class GLULinear(nn.Module):
    """GLU feed-forward ``a * silu(b)`` of the two halves of one
    Linear(d, 2 * features) (child ``linear``: key ``fc1.linear.weight``)."""

    def __init__(self, d: int, features: int):
        super().__init__()
        self.features = features
        self.linear = nn.Linear(d, 2 * features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = linear(x, self.linear, dtype)
        a, b = y[..., :self.features], y[..., self.features:]
        return a * F.silu(b)


class Fp32LayerNorm(nn.Module):
    """LayerNorm over the last dim computed in fp32, output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Fp32GroupNorm(nn.Module):
    """GroupNorm in fp32 on (B, T, C) tensors; with num_groups == C each
    channel is normalized over time alone (the frontend's first layer)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        G = self.num_groups
        xg = x.float().reshape(B, T, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(B, T, C)
        return (y * self.weight + self.bias).to(x.dtype)


class Fp32GroupNormAffine(Fp32GroupNorm):
    """The per-channel GroupNorm as (a, b) of shape (B, C) with
    GroupNorm(x) == x*a + b: same parameters as Fp32GroupNorm, the
    normalize itself left to the fused conv block that follows. The stats
    come from x or, precomputed, as (mean, var)."""

    def forward(self, x: Optional[torch.Tensor] = None, stats=None):
        if stats is None:
            xf = x.float()
            mean = xf.mean(dim=1)
            var = xf.var(dim=1, unbiased=False)
        else:
            mean, var = stats
        if mean.shape[-1] != self.num_groups:
            raise ValueError("the affine form needs one group per channel")
        a = torch.rsqrt(var + self.eps) * self.weight
        b = self.bias - mean * a
        return a, b


class Conv1dMM(nn.Module):
    """Valid-padding strided conv1d; ``weight`` in the torch (out, in, k)
    layout. ``forward`` is the plain conv in ``dtype``; ``kernel()`` hands
    the (k, in, out) layout to the fused ops."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 use_bias: bool, dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        return self.weight.permute(2, 1, 0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:  # (B, T, Cin)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv1d(h.to(self.dtype).transpose(1, 2), self.weight.to(self.dtype),
                     bias, stride=self.stride)
        return y.transpose(1, 2)


class ConvBlock(nn.Module):
    """One frontend layer; children named as the reference's
    Sequential(conv, dropout, norm, gelu) so the keys read
    ``conv_layers.{i}.0.weight`` and ``conv_layers.0.2.weight``."""

    def __init__(self, conv: Conv1dMM, norm: Optional[nn.Module] = None):
        super().__init__()
        self.add_module("0", conv)
        if norm is not None:
            self.add_module("2", norm)

    @property
    def conv(self) -> Conv1dMM:
        return self._modules["0"]

    @property
    def norm(self) -> Optional[nn.Module]:
        return self._modules.get("2")


class LayerNormSlot(nn.Module):
    """The reference's Sequential(TransposeLast, Fp32LayerNorm, TransposeLast)
    of a ``layer_norm``-mode frontend layer: the norm is child "1", so its
    keys read ``conv_layers.{i}.2.1.weight``. (B, T, C) needs no transposes."""

    def __init__(self, dim: int):
        super().__init__()
        self.add_module("1", Fp32LayerNorm(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._modules["1"](x)


class ConvFeatureExtractor(nn.Module):
    """Strided conv1d stack turning a waveform (B, NS) into frames (B, T, C).
    "default" mode: GroupNorm after the first conv, GELU after each;
    "layer_norm" mode (WavLM-Large): conv, fp32 LayerNorm, GELU in each."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        if cfg.extractor_mode not in ("default", "layer_norm"):
            raise ValueError(f"unknown extractor_mode {cfg.extractor_mode!r}")
        self.layer_norm = cfg.extractor_mode == "layer_norm"
        self.dtype = dtype
        layers = cfg.conv_layers
        # the fusion conditions of the JAX TPU path; the L1 guard is
        # tightened to stride <= k <= 2*stride (the JAX guard admits k <
        # stride and then fails while tracing)
        can_fuse = cfg.use_fused_conv and not cfg.conv_bias
        self.fuse = [
            bool(can_fuse and i > 0 and k in (2, 3) and s == 2
                 and layers[i - 1][0] == dim)
            for i, (dim, k, s) in enumerate(layers)
        ]
        _, k0, s0 = layers[0]
        self.fuse_l1 = bool(
            can_fuse and cfg.use_fused_l1 and len(layers) > 1 and self.fuse[1]
            and s0 <= k0 <= 2 * s0 and s0 <= 8)
        self.conv_layers = nn.ModuleList()
        cin = 1
        for i, (dim, k, s) in enumerate(layers):
            conv = Conv1dMM(cin, dim, k, s, cfg.conv_bias, dtype)
            norm = None
            if self.layer_norm:
                norm = LayerNormSlot(dim)
            elif i == 0:
                folded = len(layers) > 1 and self.fuse[1]
                norm = (Fp32GroupNormAffine if folded else Fp32GroupNorm)(dim, dim)
            self.conv_layers.append(ConvBlock(conv, norm))
            cin = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError("expect a raw waveform (B, T_samples)")
        n = len(self.conv_layers)
        h = x[:, :, None].to(self.dtype)
        ln = self.layer_norm
        pending_gelu = False  # the previous layer's GELU, applied in-block
        pending_affine = None  # the first layer's GroupNorm, applied in-block
        for i, block in enumerate(self.conv_layers):
            conv = block.conv
            nxt_fused = i + 1 < n and self.fuse[i + 1]
            if i == 0 and self.fuse_l1:
                h, s1, s2, t = l1_conv_with_stats(
                    x.float().contiguous(), conv.kernel(), conv.stride, dtype=self.dtype,
                    with_stats=not ln)
                if ln:  # per-layer LayerNorm: the GroupNorm sums are not needed
                    h = block.norm(h)
                else:
                    mean = s1 / t
                    var = torch.clamp(s2 / t - mean * mean, min=0.0)
                    pending_affine = block.norm(stats=(mean, var))
                pending_gelu = True
                continue
            if self.fuse[i]:
                h, _ = conv_gelu_block(  # a plain conv's output is a transposed view
                    h.contiguous(), conv.kernel(), valid_len=h.shape[1],
                    gelu_in=pending_gelu, gelu_out=not ln, affine=pending_affine)
                pending_gelu = False
                pending_affine = None
                if ln:
                    # the block returns exactly t_out rows (the JAX chain keeps
                    # padded storage rows and normalises them too), so the
                    # LayerNorm sees valid rows only; its GELU goes into the
                    # next block's input pass where there is one
                    h = block.norm(h)
                    if nxt_fused:
                        pending_gelu = True
                    else:
                        h = gelu_fp32(h)
                continue
            h = conv(h)
            if ln:
                h = block.norm(h)
            elif i == 0:
                if nxt_fused:
                    pending_affine = block.norm(h)
                else:
                    h = block.norm(h)
            if nxt_fused:
                pending_gelu = True
            else:
                h = gelu_fp32(h)
        return h


class _WeightNormConv(nn.Module):
    """Parameters of the weight-normed positional conv (norm over dims 0, 1
    per kernel position, torch ``weight_norm(dim=2)``)."""

    def __init__(self, C: int, groups: int, K: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, K))
        self.weight_v = nn.Parameter(torch.empty(C, C // groups, K))
        self.bias = nn.Parameter(torch.zeros(C))


class PosConv(nn.Sequential):
    """Grouped conv positional embedding with weight normalization, SamePad
    trim (an even kernel drops the last frame) and exact GELU."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__(_WeightNormConv(cfg.encoder_embed_dim, cfg.conv_pos_groups,
                                         cfg.conv_pos))
        self.groups = cfg.conv_pos_groups
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        p = self[0]
        K = p.weight_v.shape[-1]
        v = p.weight_v.float()
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        w = (p.weight_g / torch.clamp(norm, min=1e-12)) * v
        y = F.conv1d(x.to(self.dtype).transpose(1, 2), w.to(self.dtype),
                     p.bias.to(self.dtype), padding=K // 2, groups=self.groups)
        y = y.transpose(1, 2)
        if K % 2 == 0:
            y = y[:, :-1]
        return gelu_fp32(y)


class SelfAttention(nn.Module):
    """Multi-head self-attention with the optional gated rel-pos bias. Layer
    0 owns the bucket table (``relative_attention_bias``) as in the
    reference layout; the encoder computes the bias from it once."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, has_rel_table: bool):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.encoder_embed_dim
        H = cfg.encoder_attention_heads
        self.num_heads = H
        self.head_dim = D // H
        self.qk_head_dim = (cfg.expand_attention_head_size
                            if cfg.expand_attention_head_size > 0 else self.head_dim)
        self.q_proj = nn.Linear(D, H * self.qk_head_dim)
        self.k_proj = nn.Linear(D, H * self.qk_head_dim)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        if cfg.relative_position_embedding and cfg.gru_rel_pos:
            self.grep_linear = nn.Linear(self.head_dim, 8)
            self.grep_a = nn.Parameter(torch.ones(1, H, 1, 1))
        if has_rel_table:
            self.relative_attention_bias = nn.Embedding(cfg.num_buckets, H)

    def forward(self, x, position_bias, key_padding_mask, attn_mask=None, dropout_seed=None,
                noise=None):
        """``dropout_seed`` (1-element int64 on x's device) turns on the
        attention dropout of the config; ``noise`` maps the projections'
        names to their ``QuantNoise``."""
        B, T, D = x.shape
        H, hd, hq = self.num_heads, self.head_dim, self.qk_head_dim
        rate = self.cfg.attention_dropout if dropout_seed is not None else 0.0
        noise = noise or {}
        q = linear(x, self.q_proj, self.dtype, noise.get("q_proj")).view(B, T, H, hq)
        k = linear(x, self.k_proj, self.dtype, noise.get("k_proj")).view(B, T, H, hq)
        v = linear(x, self.v_proj, self.dtype, noise.get("v_proj")).view(B, T, H, hd)
        gate = None
        if position_bias is not None and self.cfg.gru_rel_pos:
            gate = rel_pos_gate(x, self.grep_linear.weight.t(), self.grep_linear.bias,
                                self.grep_a, H)
        if self.cfg.use_flash_attention and hq == hd:
            out = fused_attention(q, k, v, position_bias, gate, key_padding_mask,
                                  attn_mask=attn_mask, dropout_rate=rate,
                                  dropout_seed=dropout_seed)
        else:
            bias = None
            if position_bias is not None:
                bias = position_bias.float()[None]
                if gate is not None:
                    bias = gate[..., None] * bias
            if attn_mask is not None:
                am = attn_mask.float()[None, None]
                bias = am if bias is None else bias + am
            out = multihead_attention(q, k, v, bias=bias,
                                      key_padding_mask=key_padding_mask,
                                      dropout_rate=rate, dropout_seed=dropout_seed)
        return linear(out.reshape(B, T, D), self.out_proj, self.dtype, noise.get("out_proj"))


# the linears iPQ noise acts on, in the order a layer draws their seeds
QUANT_NOISE_LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


@dataclasses.dataclass
class LayerSeeds:
    """A layer's random draws in training: the attention dropout seed
    (1-element int64 on the device, or None), the seeds of the two residual
    dropouts and of the activation dropout (ints, or None), and the iPQ
    noise of each noisy linear by name."""

    attention: Optional[torch.Tensor]
    residual: Tuple[Optional[int], Optional[int]]
    activation: Optional[int]
    noise: Optional[dict] = None


class TransformerEncoderLayer(nn.Module):
    """Pre- or post-LN transformer layer; with ``seeds`` its dropouts run."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype, has_rel_table: bool):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D, F_ = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
        self.act = get_activation(cfg.activation_fn)
        self.self_attn = SelfAttention(cfg, dtype, has_rel_table)
        self.self_attn_layer_norm = Fp32LayerNorm(D, cfg.layer_norm_eps)
        self.glu = cfg.activation_fn == "glu"
        self.fc1 = GLULinear(D, F_) if self.glu else nn.Linear(D, F_)
        self.fc2 = nn.Linear(F_, D)
        self.final_layer_norm = Fp32LayerNorm(D, cfg.layer_norm_eps)

    def _ffn(self, h, act_seed=None, noise=None):
        noise = noise or {}
        if self.glu:
            h = self.fc1(h, self.dtype)
        else:
            h = self.act(linear(h, self.fc1, self.dtype, noise.get("fc1")))
        if act_seed is not None:
            h = seed_dropout(h, act_seed, self.cfg.activation_dropout)
        return linear(h, self.fc2, self.dtype, noise.get("fc2"))

    def forward(self, x, position_bias, key_padding_mask, attn_mask=None,
                seeds: Optional[LayerSeeds] = None):
        cfg = self.cfg
        if seeds is None:
            seeds = LayerSeeds(None, (None, None), None)

        def drop(h, seed):
            return h if seed is None else seed_dropout(h, seed, cfg.dropout)

        attn = lambda h: self.self_attn(h, position_bias, key_padding_mask, attn_mask,
                                        seeds.attention, seeds.noise)
        if cfg.remat_ffn and not cfg.remat_layers and torch.is_grad_enabled():
            # recompute fc1 + activation in the backward instead of keeping the
            # (B, T, F) activation; the seeds make the recompute draw the same masks
            ffn = lambda h: checkpoint(self._ffn, h, seeds.activation, seeds.noise,
                                       use_reentrant=False)
        else:
            ffn = lambda h: self._ffn(h, seeds.activation, seeds.noise)
        r1, r2 = seeds.residual
        if cfg.layer_norm_first:
            x = x + drop(attn(self.self_attn_layer_norm(x)), r1)
            x = x + drop(ffn(self.final_layer_norm(x)), r2)
        else:
            x = self.self_attn_layer_norm(x + drop(attn(x), r1))
            x = self.final_layer_norm(x + drop(ffn(x), r2))
        return x


@dataclasses.dataclass
class EncoderOutput:
    x: torch.Tensor  # (B, T, D) final output
    layer_outputs: Optional[torch.Tensor]  # (n+1, B, T, D): inputs to each layer + final
    layers_dropped: int = 0  # layers layerdrop skipped in this call


class TransformerEncoder(nn.Module):
    """Transformer over frame features with conv positional embedding.
    ``layer_outputs[i]`` is the hidden state entering layer i and the last
    entry the output of the last layer run."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.pos_conv = PosConv(cfg, dtype)
        self.layer_norm = Fp32LayerNorm(cfg.encoder_embed_dim, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(cfg, dtype, cfg.relative_position_embedding and i == 0)
            for i in range(cfg.encoder_layers))

    def forward(self, x, padding_mask=None, collect_layer_outputs: bool = False,
                output_layer: Optional[int] = None, attn_mask=None,
                generator: Optional[torch.Generator] = None) -> EncoderOutput:
        """With ``generator`` (a CPU torch.Generator) the encoder trains:
        dropout and layerdrop draw from it; without, it is deterministic."""
        cfg = self.cfg
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[..., None], 0.0)
        x = x + self.pos_conv(x)
        if not cfg.layer_norm_first:
            x = self.layer_norm(x)

        # output_layer (1-based) stops after that layer: the rest never run
        n_layers = len(self.layers) if output_layer is None else min(
            output_layer, len(self.layers))
        layer_seeds: List[Optional[LayerSeeds]] = [None] * n_layers
        keep = [True] * n_layers
        if generator is not None:
            seeds = draw_seeds(generator, 4 * n_layers + 1)
            u_drop = torch.rand(n_layers, generator=generator).tolist()
            attn_seeds = seeds[1:1 + n_layers].to(x.device, non_blocking=True)
            host = seeds.tolist()
            if cfg.dropout > 0.0:
                x = seed_dropout(x, host[0], cfg.dropout)
            opt = lambda rate, seed: seed if rate > 0.0 else None
            for i in range(n_layers):
                j = 1 + n_layers + 3 * i
                layer_seeds[i] = LayerSeeds(
                    attn_seeds[i:i + 1] if cfg.attention_dropout > 0.0 else None,
                    (opt(cfg.dropout, host[j]), opt(cfg.dropout, host[j + 1])),
                    opt(cfg.activation_dropout, host[j + 2]))
                keep[i] = not (cfg.encoder_layerdrop > 0.0 and u_drop[i] <= cfg.encoder_layerdrop)
            if cfg.quant_noise_pq > 0.0:
                # drawn after the other seeds, so a model without the noise
                # draws what it drew before the noise was ported
                names = [n for n in QUANT_NOISE_LINEARS
                         if not (n == "fc1" and cfg.activation_fn == "glu")]
                qn = draw_seeds(generator, len(names) * n_layers).tolist()
                for i in range(n_layers):
                    layer_seeds[i].noise = {
                        n: QuantNoise(qn[i * len(names) + j], cfg.quant_noise_pq,
                                      cfg.quant_noise_pq_block_size)
                        for j, n in enumerate(names)}

        position_bias = None
        if cfg.relative_position_embedding:
            table = self.layers[0].self_attn.relative_attention_bias.weight
            T = x.shape[1]
            position_bias = compute_rel_pos_bias(
                table, T, T, cfg.num_buckets, cfg.max_distance, dtype=self.dtype)

        outputs = []
        remat = cfg.remat_layers and torch.is_grad_enabled()
        for layer, seeds, kept in zip(self.layers[:n_layers], layer_seeds, keep):
            if collect_layer_outputs:
                outputs.append(x)
            if not kept:
                continue
            if remat:
                x = checkpoint(layer, x, position_bias, padding_mask, attn_mask, seeds,
                               use_reentrant=False)
            else:
                x = layer(x, position_bias, padding_mask, attn_mask, seeds)
        layer_outputs = None
        if collect_layer_outputs:
            outputs.append(x)
            layer_outputs = torch.stack(outputs)

        if cfg.layer_norm_first and output_layer is None:
            x = self.layer_norm(x)
        return EncoderOutput(x=x, layer_outputs=layer_outputs,
                             layers_dropped=n_layers - sum(keep))


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Random init with the JAX package's distributions, drawn from
    ``generator``: he-normal convs, N(0, 0.02) dense layers and tables,
    unit norms, positional-conv v ~ N(0, 4/(K*C)) with g = |v|."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv1dMM):
                fan_in = m.weight.shape[1] * m.weight.shape[2]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, (Fp32LayerNorm, Fp32GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _WeightNormConv):
                C, _, K = m.weight_v.shape
                m.weight_v.normal_(0.0, math.sqrt(4.0 / (K * C)), generator=generator)
                m.weight_g.copy_(m.weight_v.norm(dim=(0, 1), keepdim=True))
                m.bias.zero_()
            elif isinstance(m, SelfAttention) and hasattr(m, "grep_a"):
                m.grep_a.fill_(1.0)
