"""wav2vec 2.0 contrastive pretraining and the UniSpeech multitask head.

Counterpart of the JAX package's ``models/wav2vec2.py``: (B, T, 1+N) cosine
logits at every frame (column 0 the positive), the InfoNCE loss weighted by
the mask (train/losses.py). The targets are the quantized (Gumbel,
``quantize_targets``) or projected unmasked conv features, after
``dropout_features``; the quantizer's perplexities read the valid frames
only (ops/quantizer.py). Negatives are drawn uniformly from a pool (the valid
masked frames, or every valid frame with ``negatives_from_everywhere``):
``num_negatives`` from the query's own utterance and
``cross_sample_negatives`` from the whole batch; a negative whose codeword
ids (or, without the quantizer, whose vector) equal the positive's gets
-2^30. ``codebook_negatives`` appends uniform draws from the codebooks.
UniSpeech (``transpose``): the targets are projected up to the encoder's
width and the encoder output is compared unprojected; the phonetic CTC
head (``ctc_vocab_size > 0``) swaps each frame for the quantized stream
with probability ``replace_prob`` before ``final_dropout`` and ``proj``.

Every draw comes from the step's host-side generator through a small
named function (``sample_negative_indices``, ``codebook_ids``,
``replace_mask``, and the quantizer's ``gumbel_noise``), each drawing on
the tensor's device from a generator it seeds; tests replace them with the
JAX package's recorded draws. The heads add no kernel: the JAX package
computes them outside any Pallas kernel too.

The backbone's parameters sit at the top level of the state dict, beside
``quantizer.*``, ``project_q``, ``final_proj``, ``target_glu.0`` and
``proj`` (the CTC head), as the JAX package's fairseq exporter names them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from unispeech_tpu_torch.configs import Wav2Vec2PretrainConfig, WavLMModelConfig
from unispeech_tpu_torch.models.encoder import linear, reset_parameters
from unispeech_tpu_torch.models.hubert import GLUProj, gathered_cosine_logits, unit_norm
from unispeech_tpu_torch.models.wavlm import WavLM
from unispeech_tpu_torch.ops.dropout import device_generator, row_seed, seed_dropout
from unispeech_tpu_torch.ops.quantizer import GumbelVectorQuantizer

NEG_IS_POS = -(2.0 ** 30)  # the logit of a negative equal to its positive


def _uniform_ranks(pool: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """(R, L*n) positions drawn uniformly among the True entries of each row
    of ``pool`` (R, L) bool: a uniform rank, then the position of that rank
    in the row's cumulative count (the last position for an empty row)."""
    R, L = pool.shape
    cum = pool.long().cumsum(-1)
    count = cum[:, -1:]
    u = torch.rand((R, L * n), generator=g, device=pool.device)
    rank = torch.minimum((u * count).long(), torch.clamp(count - 1, min=0))
    return torch.searchsorted(cum, rank + 1).clamp(max=L - 1)


def sample_negative_indices(generator: torch.Generator, pool: torch.Tensor, n_same: int,
                            n_cross: int) -> torch.Tensor:
    """(B, T, n_same+n_cross) flat (B*T) indices of negatives, each uniform
    over the True frames of ``pool`` (B, T): the first ``n_same`` in the
    query's row, the rest over the whole batch."""
    B, T = pool.shape
    g = device_generator(generator, pool.device)
    parts = []
    if n_same > 0:
        base = (torch.arange(B, device=pool.device) * T)[:, None]
        parts.append((_uniform_ranks(pool, n_same, g) + base).reshape(B, T, n_same))
    if n_cross > 0:
        parts.append(_uniform_ranks(pool.reshape(1, B * T), n_cross, g).reshape(B, T, n_cross))
    return torch.cat(parts, -1)


def codebook_ids(generator: torch.Generator, shape, num_vars: int,
                 device=None) -> torch.Tensor:
    """Codeword ids uniform in [0, num_vars) (the codebook negatives)."""
    g = device_generator(generator, device)
    return torch.randint(0, num_vars, shape, generator=g, device=device)


def replace_mask(generator: torch.Generator, prob: float, shape, device=None) -> torch.Tensor:
    """Bernoulli(prob) bool mask (the CTC head's swap with the quantized stream)."""
    g = device_generator(generator, device)
    return torch.rand(shape, generator=g, device=device) < prob


@dataclasses.dataclass
class Wav2Vec2Output:
    contrastive_logits: Optional[torch.Tensor]  # (B, T, 1+N) fp32, column 0 positive
    mask_indices: Optional[torch.Tensor]  # (B, T)
    padding_mask: Optional[torch.Tensor]  # (B, T)
    features_pen: torch.Tensor
    vq_result: Optional[dict]
    x: torch.Tensor  # encoder output (B, T, D)
    ctc_logits: Optional[torch.Tensor] = None  # (B, T, vocab) fp32, the UniSpeech head
    q_stream: Optional[torch.Tensor] = None  # (B, T, D) projected quantized stream
    layers_dropped: int = 0


class Wav2Vec2PretrainModel(WavLM):
    """WavLM backbone + the contrastive heads. Parameters fp32, compute in
    ``dtype``; ``generator`` seeds the random init."""

    def __init__(self, cfg: Wav2Vec2PretrainConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(WavLMModelConfig(encoder=cfg.encoder, time_mask=cfg.time_mask,
                                          channel_mask=cfg.channel_mask),
                         dtype=dtype, generator=generator)
        self.wcfg = cfg
        C = cfg.encoder.conv_layers[-1][0]
        D, final_dim = cfg.encoder.encoder_embed_dim, cfg.final_dim
        heads = []
        if cfg.quantize_targets:
            self.quantizer = GumbelVectorQuantizer(cfg.quantizer, C, dtype, generator)
        self.project_q = nn.Linear(cfg.quantizer.vq_dim if cfg.quantize_targets else C,
                                   final_dim)
        self.final_proj = nn.Linear(final_dim, D) if cfg.transpose else nn.Linear(D, final_dim)
        heads += [self.project_q, self.final_proj]
        self.target_glu = None
        if cfg.target_glu:
            self.target_glu = GLUProj(D if cfg.transpose else final_dim, dtype)
            heads.append(self.target_glu)
        if cfg.ctc_vocab_size > 0:
            self.proj = nn.Linear(D, cfg.ctc_vocab_size)
            heads.append(self.proj)
        for m in heads:
            reset_parameters(m, generator)

    def forward(self, source: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                mask: bool = True, deterministic: bool = True, num_updates=0,
                features_only: bool = False, generator: Optional[torch.Generator] = None,
                boundary_mask: Optional[torch.Tensor] = None) -> Wav2Vec2Output:
        """``deterministic=False`` runs dropout, the Gumbel noise and the
        replace mask; the negatives are drawn in any case; every draw comes
        from ``generator`` (a CPU torch.Generator). ``num_updates`` sets the
        quantizer's temperature; ``boundary_mask`` replaces the span
        sampler's mask."""
        cfg = self.wcfg
        out = super().forward(source, lengths=lengths, mask=mask, deterministic=deterministic,
                              boundary_mask=boundary_mask, generator=generator)
        res = dict(mask_indices=out.mask_indices, padding_mask=out.padding_mask,
                   features_pen=out.features_pen, x=out.x, layers_dropped=out.layers_dropped)
        if features_only:
            return Wav2Vec2Output(contrastive_logits=None, vq_result=None, **res)
        if generator is None:
            raise ValueError("the contrastive heads draw from an explicit generator")

        # the target stream: the unmasked conv features (post-LN, before the
        # projection), with dropout_features
        unmasked = out.conv_features
        if cfg.encoder.dropout_features > 0.0 and not deterministic:
            unmasked = seed_dropout(unmasked, row_seed(generator),
                                    cfg.encoder.dropout_features)
        B, T, _ = unmasked.shape
        vq_result = vq_ids = cb_negs = cb_ids = None
        if cfg.quantize_targets:
            vq_result = self.quantizer(unmasked, num_updates=num_updates,
                                       deterministic=deterministic, produce_targets=True,
                                       generator=generator, padding_mask=out.padding_mask)
            vq_ids = vq_result["targets"]  # (B, T, G)
            y = linear(vq_result["x"], self.project_q, self.dtype)
            if cfg.codebook_negatives > 0:
                cw = vq_result["codebook"]  # (G, V, var_dim) fp32
                G, V, _ = cw.shape
                cb_ids = codebook_ids(generator, (B, T, cfg.codebook_negatives, G), V,
                                      unmasked.device)
                cb = cw[torch.arange(G, device=cw.device), cb_ids]
                cb_negs = linear(cb.reshape(B, T, cfg.codebook_negatives, -1).to(self.dtype),
                                 self.project_q, self.dtype)
        else:
            y = linear(unmasked, self.project_q, self.dtype)

        x = out.x
        q_stream = None
        if cfg.transpose:
            # UniSpeech: targets up to the encoder's width, x unprojected; the
            # projected targets are the quantized stream of the CTC head
            y = linear(y, self.final_proj, self.dtype)
            if cb_negs is not None:
                cb_negs = linear(cb_negs, self.final_proj, self.dtype)
            cx = x
            q_stream = y
        else:
            cx = linear(x, self.final_proj, self.dtype)
        if self.target_glu is not None:
            y = self.target_glu(y)
            if cb_negs is not None:
                cb_negs = self.target_glu(cb_negs)
        logits = self._contrastive_logits(cx, y, vq_ids, out.mask_indices, out.padding_mask,
                                          generator, cb_negs, cb_ids)

        ctc_logits = None
        if cfg.ctc_vocab_size > 0:
            h = x
            if q_stream is not None and cfg.replace_prob > 0 and not deterministic:
                rep = replace_mask(generator, cfg.replace_prob, (B, T), h.device)
                h = torch.where(rep[..., None], q_stream.to(h.dtype), h)
            if cfg.final_dropout > 0.0 and not deterministic:
                h = seed_dropout(h, row_seed(generator), cfg.final_dropout)
            ctc_logits = linear(h, self.proj, self.dtype).float()
        return Wav2Vec2Output(contrastive_logits=logits, vq_result=vq_result,
                              ctc_logits=ctc_logits, q_stream=q_stream, **res)

    def _contrastive_logits(self, x, y, vq_ids, mask_indices, padding_mask, generator,
                            cb_negs=None, cb_ids=None) -> torch.Tensor:
        """(B, T, 1+N) cosine logits: column 0 the positive, then the
        sampled negatives, then the codebook negatives."""
        cfg = self.wcfg
        B, T, _ = y.shape
        pool = (torch.ones((B, T), dtype=torch.bool, device=y.device) if padding_mask is None
                else ~padding_mask)
        if not cfg.negatives_from_everywhere and mask_indices is not None:
            pool = pool & mask_indices
        idx = sample_negative_indices(generator, pool, cfg.num_negatives,
                                      cfg.cross_sample_negatives)
        N = idx.shape[-1]
        logits = gathered_cosine_logits(x, y, idx, cfg.logit_temp)
        # a negative equal to its positive: the same codeword ids, or without
        # the quantizer the same vector (in the targets' dtype)
        flat_idx = idx.reshape(-1)
        if vq_ids is not None:
            neg_ids = vq_ids.reshape(B * T, -1)[flat_idx].reshape(B, T, N, -1)
            neg_is_pos = (neg_ids == vq_ids[:, :, None, :]).all(-1)
        else:
            y_flat = y.reshape(B * T, -1)
            # a few negatives at a time: (B, T, n, D) compares, not (B, T, N, D)
            step = max(1, (1 << 24) // max(1, B * T * y.shape[-1]))
            neg_is_pos = torch.cat([
                (y_flat[idx[..., i:i + step].reshape(-1)].reshape(B, T, -1, y.shape[-1])
                 == y[:, :, None, :]).all(-1) for i in range(0, N, step)], -1)
        if cb_negs is not None:
            cb = torch.einsum("btd,btnd->btn", unit_norm(x), unit_norm(cb_negs)) / cfg.logit_temp
            logits = torch.cat([logits, cb], -1)
            neg_is_pos = torch.cat([neg_is_pos,
                                    (cb_ids == vq_ids[:, :, None, :]).all(-1)], -1)
        return torch.cat([logits[..., :1], logits[..., 1:].masked_fill(neg_is_pos, NEG_IS_POS)],
                         -1)
