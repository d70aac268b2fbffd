"""Decoder-only Transformer language model, for shallow-fusion decoding.

Counterpart of the JAX package's ``models/lm.py`` (the reference's
TransformerLanguageModel, which its ``W2lFairseqLMDecoder`` fuses into the
CTC beam search): a causal Transformer, pre-LN by default, with a tied
output embedding by default, over whole token windows. Keys in fairseq's
layout without the ``decoder.`` prefix: ``embed_tokens.weight``,
``layers.{i}.self_attn.q_proj.weight``, ``layers.{i}.fc1.weight``,
``layer_norm.weight``, ``embed_out`` when untied. The attention logits are
an fp32 product of the model-dtype q and k, as the JAX package's
``preferred_element_type=jnp.float32`` gives them; plain ``torch.matmul``
(there is no Pallas kernel behind it). Dropout draws from a host-side
``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from unispeech_tpu_torch.models.encoder import Fp32LayerNorm, gelu_fp32, linear, reset_parameters
from unispeech_tpu_torch.models.seq2seq import (
    NEG_INF,
    embed_lookup,
    make_positions,
    sinusoidal_positions,
)
from unispeech_tpu_torch.ops.dropout import draw_seeds, fold_ranks, seed_dropout
from unispeech_tpu_torch.parallel.sharding import data_rank


@dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 0
    embed_dim: int = 512
    ffn_dim: int = 2048
    layers: int = 6
    heads: int = 8
    dropout: float = 0.1
    padding_idx: int = 1
    max_positions: int = 2048
    learned_pos: bool = False
    normalize_before: bool = True  # pre-LN
    share_input_output_embed: bool = True


class LMSelfAttention(nn.Module):
    """The q/k/v/out projections of a layer (keys ``self_attn.*``)."""

    def __init__(self, D: int):
        super().__init__()
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)


class LMLayer(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.embed_dim
        self.self_attn = LMSelfAttention(D)
        self.self_attn_layer_norm = Fp32LayerNorm(D)
        self.fc1 = nn.Linear(D, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, D)
        self.final_layer_norm = Fp32LayerNorm(D)

    def attn(self, h: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        c, a, dt = self.cfg, self.self_attn, self.dtype
        B, S, _ = h.shape
        H = c.heads
        hd = c.embed_dim // H
        q = linear(h, a.q_proj, dt).reshape(B, S, H, hd).transpose(1, 2)
        k = linear(h, a.k_proj, dt).reshape(B, S, H, hd).transpose(1, 2)
        v = linear(h, a.v_proj, dt).reshape(B, S, H, hd).transpose(1, 2)
        # model-dtype operands, fp32 products and sums
        logits = torch.matmul((q * (hd ** -0.5)).float(), k.float().transpose(-1, -2)) + causal
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(B, S, -1)
        return linear(o, a.out_proj, dt)

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return linear(gelu_fp32(linear(h, self.fc1, self.dtype)), self.fc2, self.dtype)

    def forward(self, x, causal, seeds=None):
        """``seeds`` (two ints) runs the residual dropouts."""
        rate = self.cfg.dropout

        def drop(h, i):
            return h if seeds is None or rate == 0.0 else seed_dropout(h, seeds[i], rate)

        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.cfg.normalize_before:
            x = x + drop(self.attn(ln1(x), causal), 0)
            return x + drop(self.ffn(ln2(x)), 1)
        x = ln1(x + drop(self.attn(x, causal), 0))
        return ln2(x + drop(self.ffn(x), 1))


class TransformerLM(nn.Module):
    """(B, S) token ids, pad = padding_idx -> (B, S, V) fp32 logits of the
    next token at each position. Parameters fp32, compute in ``dtype``."""

    def __init__(self, cfg: TransformerLMConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.embed_positions = (nn.Embedding(cfg.max_positions + cfg.padding_idx + 1, D)
                                if cfg.learned_pos else None)
        self.layers = nn.ModuleList(LMLayer(cfg, dtype) for _ in range(cfg.layers))
        self.layer_norm = Fp32LayerNorm(D) if cfg.normalize_before else None
        self.embed_out = (None if cfg.share_input_output_embed
                          else nn.Parameter(torch.empty(cfg.vocab_size, D)))
        if not cfg.learned_pos:
            self.register_buffer("sin_table", sinusoidal_positions(
                cfg.max_positions, D, cfg.padding_idx), persistent=False)
        reset_parameters(self, generator)
        with torch.no_grad():
            self.embed_tokens.weight.normal_(0.0, D ** -0.5, generator=generator)
            if self.embed_out is not None:
                self.embed_out.normal_(0.0, D ** -0.5, generator=generator)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``deterministic=False`` runs dropout, drawing from ``generator``
        (a CPU torch.Generator)."""
        c = self.cfg
        S = tokens.shape[1]
        train = not deterministic and c.dropout > 0.0
        if train and generator is None:
            raise ValueError("dropout draws from an explicit generator")
        x = embed_lookup(tokens, self.embed_tokens, self.dtype) * math.sqrt(c.embed_dim)
        pos = make_positions(tokens, c.padding_idx)
        if self.embed_positions is not None:
            x = x + embed_lookup(pos, self.embed_positions, self.dtype)
        else:
            x = x + self.sin_table[pos].to(self.dtype)
        seeds = ([fold_ranks(s, data_rank()) for s in
                  draw_seeds(generator, 1 + 2 * len(self.layers)).tolist()] if train else None)
        if train:
            x = seed_dropout(x, seeds[0], c.dropout)
        causal = torch.triu(torch.full((S, S), NEG_INF, device=x.device), 1)[None, None]
        for i, layer in enumerate(self.layers):
            x = layer(x, causal, None if seeds is None else seeds[1 + 2 * i:3 + 2 * i])
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        w = self.embed_tokens.weight if self.embed_out is None else self.embed_out
        return torch.matmul(x.float(), w.float().t())


def lm_loss(logits: torch.Tensor,  # (B, S, V) next-token logits
            targets: torch.Tensor,  # (B, S) the tokens shifted left
            padding_idx: int):
    """(summed cross-entropy over the non-pad targets, their count)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(lp, -1, targets.long()[..., None])[..., 0]
    valid = (targets != padding_idx).float()
    return (ce * valid).sum(), valid.sum()
