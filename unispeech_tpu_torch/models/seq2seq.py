"""Seq2seq ASR fine-tuning: a WavLM backbone and an autoregressive
Transformer decoder.

Counterpart of the JAX package's ``models/seq2seq.py`` (the reference's
``Wav2Vec2Seq2SeqModel``): scaled token embedding and sinusoidal (or
learned) positions, post-LN (or pre-LN) decoder layers of causal
self-attention, cross-attention over the encoder frames and a GELU FFN, and
an fp32 output projection, tied to the input embedding or not. The backbone
is ``wavlm`` (state-dict keys ``wavlm.*``), the decoder ``decoder`` in
fairseq's key layout (``decoder.layers.{i}.self_attn.q_proj.weight``,
``decoder.embed_out``), the projection to the decoder's width ``enc_proj``
where the widths differ. The freeze gate runs the backbone under
``torch.no_grad()``, as ``models/ctc.py`` does; ``enc_proj`` trains
throughout, as in the JAX package.

The decoder's attention is plain ``torch.matmul`` and softmax in the JAX
package's order (the logits product in the model dtype, then fp32): the
JAX package has no Pallas kernel behind it, and the encoder's fused kernel
does not take its head dim (768 / 4 = 192). ``greedy_decode`` and
``beam_decode`` re-run the whole decoder over the (rows, max_len) token
buffer at every position, as the JAX package's static-shape scans do.
Training draws every random number from a host-side ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unispeech_tpu_torch.configs import EncoderConfig, MaskConfig, WavLMModelConfig
from unispeech_tpu_torch.models.encoder import Fp32LayerNorm, gelu_fp32, linear, reset_parameters
from unispeech_tpu_torch.models.wavlm import WavLM
from unispeech_tpu_torch.ops.dropout import draw_seeds, seed_dropout

NEG_INF = -1e30


@dataclass(frozen=True)
class Seq2SeqDecoderConfig:
    """The reference's Wav2Vec2Seq2SeqConfig decoder fields."""

    vocab_size: int = 32
    embed_dim: int = 768
    ffn_embed_dim: int = 3072
    layers: int = 6
    heads: int = 4
    learned_pos: bool = False
    normalize_before: bool = False
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layerdrop: float = 0.0
    max_target_positions: int = 2048
    share_input_output_embed: bool = False
    padding_idx: int = 1  # Dictionary.pad()


def sinusoidal_positions(num_positions: int, dim: int, padding_idx: int) -> torch.Tensor:
    """fairseq's SinusoidalPositionalEmbedding table (fp32): [sin | cos]
    halves, positions offset by padding_idx + 1, row padding_idx zero."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * -emb)
    n = num_positions + padding_idx + 1
    pos = torch.arange(n, dtype=torch.float32)[:, None] * freqs[None, :]
    table = torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(n, 1)], dim=1)
    table[padding_idx] = 0.0
    return table


def make_positions(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """fairseq make_positions: the cumulative count of non-pad tokens,
    offset by padding_idx; pad tokens get padding_idx."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def embed_lookup(tokens: torch.Tensor, table: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    """The table cast to ``dtype``, then the lookup (flax ``nn.Embed``)."""
    return F.embedding(tokens.long(), table.weight.to(dtype))


class DecoderMHA(nn.Module):
    """Decoder attention, self or cross: q/k/v/out projections, no bias
    table."""

    def __init__(self, embed_dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.embed_dim, self.heads, self.dtype = embed_dim, heads, dtype
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, self.heads, self.embed_dim // self.heads)

    def kv(self, kv_src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._heads(linear(kv_src, self.k_proj, self.dtype)),
                self._heads(linear(kv_src, self.v_proj, self.dtype)))

    def attend(self, q_src: torch.Tensor,  # (B, Tq, D)
               k: torch.Tensor, v: torch.Tensor,  # (B, S, H, hd)
               mask: Optional[torch.Tensor],  # additive (B|1, 1, Tq, S) fp32
               dropout_seed: Optional[int] = None, rate: float = 0.0) -> torch.Tensor:
        hd = self.embed_dim // self.heads
        q = self._heads(linear(q_src, self.q_proj, self.dtype)) * (hd ** -0.5)
        # the logits product in the model dtype, then fp32, as the JAX package
        logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)).float()
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1)
        if dropout_seed is not None:
            probs = seed_dropout(probs, dropout_seed, rate)
        out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))  # (B, H, Tq, hd)
        out = out.transpose(1, 2).reshape(*q_src.shape[:2], self.embed_dim)
        return linear(out, self.out_proj, self.dtype)


# the dropout sites of a decoder layer, in the order it draws their seeds
DROP_SITES = ("attn_self", "attn_cross", "res_self", "res_cross", "act", "res_ffn")


class TransformerDecoderLayer(nn.Module):
    """fairseq TransformerDecoderLayer wiring: self-attention, then
    cross-attention, then the FFN, a residual around each, the LayerNorm
    after (post-LN) or before (pre-LN) each block."""

    def __init__(self, cfg: Seq2SeqDecoderConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.embed_dim
        self.self_attn = DecoderMHA(D, cfg.heads, dtype)
        self.encoder_attn = DecoderMHA(D, cfg.heads, dtype)
        self.self_attn_layer_norm = Fp32LayerNorm(D)
        self.encoder_attn_layer_norm = Fp32LayerNorm(D)
        self.final_layer_norm = Fp32LayerNorm(D)
        self.fc1 = nn.Linear(D, cfg.ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.ffn_embed_dim, D)

    @staticmethod
    def _block(x, ln, fn, pre: bool):
        return x + fn(ln(x)) if pre else ln(x + fn(x))

    def forward(self, x, self_k, self_v, self_mask, enc_k, enc_v, enc_mask,
                seeds: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """``seeds`` (one per ``DROP_SITES`` name) turns dropout on."""
        c = self.cfg
        seeds = seeds or {}

        def drop(h, rate, site):
            return h if site not in seeds or rate <= 0.0 else seed_dropout(h, seeds[site], rate)

        def attn_seed(site):
            return seeds.get(site) if c.attention_dropout > 0.0 else None

        x = self._block(x, self.self_attn_layer_norm, lambda h: drop(
            self.self_attn.attend(h, self_k, self_v, self_mask, attn_seed("attn_self"),
                                  c.attention_dropout), c.dropout, "res_self"),
            c.normalize_before)
        x = self._block(x, self.encoder_attn_layer_norm, lambda h: drop(
            self.encoder_attn.attend(h, enc_k, enc_v, enc_mask, attn_seed("attn_cross"),
                                     c.attention_dropout), c.dropout, "res_cross"),
            c.normalize_before)

        def ffn(h):
            h = drop(gelu_fp32(linear(h, self.fc1, self.dtype)), c.activation_dropout, "act")
            return drop(linear(h, self.fc2, self.dtype), c.dropout, "res_ffn")

        return self._block(x, self.final_layer_norm, ffn, c.normalize_before)


class TransformerDecoder(nn.Module):
    """Teacher-forcing decoder over (B, S) token ids; fp32 (B, S, V) logits
    of the next token at each position."""

    def __init__(self, cfg: Seq2SeqDecoderConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        D = cfg.embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        self.embed_positions = (
            nn.Embedding(cfg.max_target_positions + cfg.padding_idx + 1, D)
            if cfg.learned_pos else None)
        self.layers = nn.ModuleList(TransformerDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.layers))
        self.layer_norm = Fp32LayerNorm(D) if cfg.normalize_before else None
        self.embed_out = (None if cfg.share_input_output_embed
                          else nn.Parameter(torch.empty(cfg.vocab_size, D)))
        if not cfg.learned_pos:
            self.register_buffer("sin_table", sinusoidal_positions(
                cfg.max_target_positions, D, cfg.padding_idx), persistent=False)
        reset_parameters(self, generator)
        with torch.no_grad():
            self.embed_tokens.weight.normal_(0.0, D ** -0.5, generator=generator)
            if self.embed_out is not None:
                self.embed_out.normal_(0.0, D ** -0.5, generator=generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = embed_lookup(tokens, self.embed_tokens, self.dtype) * math.sqrt(c.embed_dim)
        pos = make_positions(tokens, c.padding_idx)
        if self.embed_positions is not None:
            return x + embed_lookup(pos, self.embed_positions, self.dtype)
        return x + self.sin_table[pos].to(self.dtype)

    def output_layer(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed_tokens.weight if self.embed_out is None else self.embed_out
        return torch.matmul(x.float(), w.float().t())

    def forward(self, prev_tokens: torch.Tensor,  # (B, S) teacher-forcing inputs
                enc_out: torch.Tensor,  # (B, T, D)
                enc_padding_mask: Optional[torch.Tensor],  # (B, T) True = pad
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``generator`` (a CPU torch.Generator) dropout and layerdrop
        run; without, the decoder is deterministic."""
        c = self.cfg
        S = prev_tokens.shape[1]
        dev = enc_out.device
        x = self.embed(prev_tokens)
        train = generator is not None
        if train and c.dropout > 0.0:
            x = seed_dropout(x, int(draw_seeds(generator, 1)), c.dropout)
        causal = torch.triu(torch.full((S, S), NEG_INF, device=dev), 1)[None, None]
        enc_mask = None
        if enc_padding_mask is not None:
            enc_mask = torch.where(enc_padding_mask, NEG_INF, 0.0).float()[:, None, None, :]
        for layer in self.layers:
            self_k, self_v = layer.self_attn.kv(x)
            enc_k, enc_v = layer.encoder_attn.kv(enc_out)
            seeds = None
            if train:
                seeds = dict(zip(DROP_SITES, draw_seeds(generator, len(DROP_SITES)).tolist()))
            y = layer(x, self_k, self_v, causal, enc_k, enc_v, enc_mask, seeds)
            if train and c.layerdrop > 0.0:
                if not float(torch.rand((), generator=generator)) > c.layerdrop:
                    y = x
            x = y
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return self.output_layer(x)


@dataclass(frozen=True)
class Seq2SeqConfig:
    """Wav2Vec2Seq2SeqModel: a masked encoder backbone and the decoder."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: Seq2SeqDecoderConfig = field(default_factory=Seq2SeqDecoderConfig)
    apply_mask: bool = True
    time_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.5, mask_length=10))
    channel_mask: MaskConfig = field(
        default_factory=lambda: MaskConfig(mask_prob=0.5, mask_length=64, min_masks=0))
    freeze_finetune_updates: int = 0
    feature_grad_mult: float = 0.0


@dataclass
class Seq2SeqOutput:
    logits: torch.Tensor  # (B, S, V) fp32
    enc_padding_mask: Optional[torch.Tensor]  # (B, T) True = pad
    layers_dropped: int = 0  # encoder layers layerdrop skipped


class Seq2SeqModel(nn.Module):
    """Parameters fp32, compute in ``dtype``; ``generator`` seeds the init."""

    def __init__(self, cfg: Seq2SeqConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        enc = dataclasses.replace(cfg.encoder, feature_grad_mult=cfg.feature_grad_mult)
        self.wavlm = WavLM(WavLMModelConfig(encoder=enc, time_mask=cfg.time_mask,
                                            channel_mask=cfg.channel_mask),
                           dtype=dtype, generator=generator)
        self.decoder = TransformerDecoder(cfg.decoder, dtype, generator)
        self.enc_proj = None
        if cfg.decoder.embed_dim != enc.encoder_embed_dim:
            self.enc_proj = nn.Linear(enc.encoder_embed_dim, cfg.decoder.embed_dim)
            reset_parameters(self.enc_proj, generator)

    def frozen(self, step: int) -> bool:
        return step < self.cfg.freeze_finetune_updates

    def encode(self, source: torch.Tensor, lengths: Optional[torch.Tensor],
               deterministic: bool = True, step: int = 0,
               generator: Optional[torch.Generator] = None,
               boundary_mask: Optional[torch.Tensor] = None):
        """(encoder output (B, T, D_dec), padding mask, layers dropped);
        ``boundary_mask`` replaces the time-mask sampler while training."""
        cfg = self.cfg
        gate = torch.no_grad() if self.frozen(step) else contextlib.nullcontext()
        with gate:
            out = self.wavlm(source, lengths=lengths, mask=cfg.apply_mask and not deterministic,
                             deterministic=deterministic, boundary_mask=boundary_mask,
                             generator=generator)
        h = out.x
        if self.enc_proj is not None:
            h = linear(h, self.enc_proj, self.dtype)
        return h, out.padding_mask, out.layers_dropped

    def forward(self, source: torch.Tensor,  # (B, n_samples)
                prev_tokens: torch.Tensor,  # (B, S) eos-shifted targets
                lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True, step: int = 0,
                generator: Optional[torch.Generator] = None,
                boundary_mask: Optional[torch.Tensor] = None) -> Seq2SeqOutput:
        h, pad, dropped = self.encode(source, lengths, deterministic, step, generator,
                                      boundary_mask)
        logits = self.decoder(prev_tokens, h, pad,
                              generator=None if deterministic else generator)
        return Seq2SeqOutput(logits=logits, enc_padding_mask=pad, layers_dropped=dropped)


def cross_entropy_loss(logits: torch.Tensor,  # (B, S, V) fp32
                       targets: torch.Tensor,  # (B, S)
                       target_mask: torch.Tensor,  # (B, S) {0, 1}
                       label_smoothing: float = 0.1):
    """Label-smoothed NLL summed over the valid targets, in the JAX
    package's form (the smoothing term ``-lp.mean(-1)``). Returns (loss,
    ntokens, metrics)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, targets.long()[..., None])[..., 0]
    smooth = -lp.mean(dim=-1)
    loss_tok = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    w = target_mask.float()
    loss = (loss_tok * w).sum()
    ntokens = w.sum()
    correct = ((lp.argmax(-1) == targets) * w).sum()
    metrics = {"loss": loss, "nll_loss": (nll * w).sum(), "ntokens": ntokens,
               "correct": correct, "sample_size": ntokens}
    return loss, ntokens, metrics


@torch.no_grad()
def greedy_decode(model: Seq2SeqModel, source: torch.Tensor, lengths: Optional[torch.Tensor],
                  bos: int, eos: int, max_len: int = 200) -> torch.Tensor:
    """Greedy decoding: the whole decoder re-run over the (B, max_len)
    token buffer at each of max_len positions. (B, max_len) ids,
    eos-padded after each row's first eos."""
    h, pad, _ = model.encode(source, lengths)
    B = source.shape[0]
    tokens = torch.full((B, max_len + 1), eos, dtype=torch.long, device=h.device)
    tokens[:, 0] = bos
    finished = torch.zeros(B, dtype=torch.bool, device=h.device)
    for t in range(max_len):
        logits = model.decoder(tokens[:, :-1], h, pad)
        nxt = logits[:, t].argmax(-1)
        nxt = torch.where(finished, eos, nxt)
        tokens[:, t + 1] = nxt
        finished = finished | (nxt == eos)
    return tokens[:, 1:]


def _ngram_ban_mask(tokens: torch.Tensor,  # (B, K, L) positions 0..t filled
                    t: int, n: int, vocab: int) -> torch.Tensor:
    """(B, K, V) {0, 1}: the tokens that would complete an n-gram already in
    the prefix (fairseq's no-repeat-ngram block)."""
    B, K, L = tokens.shape
    m = n - 1
    Lw = L - m  # window starts
    wins = torch.stack([tokens[:, :, j:j + Lw] for j in range(m)], dim=-1)  # (B, K, Lw, m)
    start = min(max(t - m + 1, 0), L - m)
    last = tokens[:, :, start:start + m]  # the (n-1)-gram ending at t
    match = (wins == last[:, :, None, :]).all(-1)  # (B, K, Lw)
    pos = torch.arange(Lw, device=tokens.device)[None, None, :]
    match = match & (pos + n - 1 <= t) & (t >= m)
    banned = tokens[:, :, m:m + Lw]  # the token after each window
    onehot = F.one_hot(banned, vocab).float()  # (B, K, Lw, V)
    return (onehot * match[..., None].float()).amax(dim=2)


@torch.no_grad()
def beam_decode(model: Seq2SeqModel, source: torch.Tensor, lengths: Optional[torch.Tensor],
                bos: int, eos: int, beam_size: int = 5, max_len: int = 200,
                len_penalty: float = 1.0, no_repeat_ngram: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the seq2seq decoder (fairseq SequenceGenerator's
    expansion: the best K of the K * V continuations, eos-finalized beams
    frozen at zero cost, score / len^len_penalty, no-repeat-ngram). Beams
    live in the batch axis: one (B * K, max_len) decoder forward per
    position; only beam 0 is live at first. Ties go to the lower flat index
    (a stable sort), as ``lax.top_k`` and ``jnp.argsort`` break them.

    Returns (tokens (B, K, max_len), scores (B, K)), best first."""
    h, pad, _ = model.encode(source, lengths)
    B, K, V = source.shape[0], beam_size, model.cfg.decoder.vocab_size
    dev = h.device
    hK = h.repeat_interleave(K, dim=0)
    padK = None if pad is None else pad.repeat_interleave(K, dim=0)
    tokens = torch.full((B, K, max_len + 1), eos, dtype=torch.long, device=dev)
    tokens[:, :, 0] = bos
    scores = torch.where(torch.arange(K, device=dev)[None, :] == 0, 0.0,
                         NEG_INF).float().expand(B, K)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    out_len = torch.full((B, K), max_len, dtype=torch.long, device=dev)
    eos_only = torch.full((V,), NEG_INF, device=dev)
    eos_only[eos] = 0.0
    for t in range(max_len):
        logits = model.decoder(tokens.reshape(B * K, -1)[:, :-1], hK, padK)
        lp = torch.log_softmax(logits.reshape(B, K, max_len, V)[:, :, t, :], dim=-1)
        if no_repeat_ngram > 1:
            lp = lp + _ngram_ban_mask(tokens, t, no_repeat_ngram, V) * NEG_INF
        lp = torch.where(finished[..., None], eos_only, lp)
        flat = (scores[..., None] + lp).reshape(B, K * V)
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
        src_beam = top_idx // V
        tok = top_idx % V
        tokens = torch.gather(tokens, 1, src_beam[:, :, None].expand(-1, -1, max_len + 1))
        tokens[:, :, t + 1] = tok
        finished = torch.gather(finished, 1, src_beam)
        out_len = torch.gather(out_len, 1, src_beam)
        newly = ~finished & (tok == eos)
        out_len = torch.where(newly, t + 1, out_len)
        finished = finished | newly
        scores = top_scores
    norm = scores / torch.clamp(out_len, min=1).float() ** len_penalty
    order = torch.sort(-norm, dim=1, stable=True).indices
    tokens = torch.gather(tokens[:, :, 1:], 1, order[:, :, None].expand(-1, -1, max_len))
    return tokens, torch.gather(norm, 1, order)


def strip_eos(ids: List[int], eos: int) -> List[int]:
    """The tokens before the first eos."""
    out = []
    for t in ids:
        if t == eos:
            break
        out.append(t)
    return out
