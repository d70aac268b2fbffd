"""Masked pseudo-label prediction pretraining: HuBERT / WavLM / ILS /
UniSpeech-SAT.

Counterpart of the JAX package's ``models/hubert.py``: cosine-similarity
logits of the projected encoder output against learned label embeddings, as
dense (B, T, C) fp32 logits per (layer, label set), weighted by the mask in
the loss (train/losses.py) instead of gathering the masked frames. ILS
(several ``predict_layers``, ``separate_label_embeds``) and
``untie_final_proj`` / ``target_glu`` are supported, and the UniSpeech-SAT
speaker-contrastive branch (``utterance_contrastive_loss``, with the
optional Gumbel quantizer on the tapped features, ``quantize_targets``).

The SAT branch draws its instances as the JAX code does: uniforms (from
``instance_uniforms``, fed by the step's generator) turned into flat
indices of valid frames by rank arithmetic (``sample_instance_indices``),
never into padding nor the query frame itself for a valid query. Its cosine logits are
gathered from one product of all frames against all frames
(``gathered_cosine_logits``) instead of a (B, T, 1+N, D) tensor of gathered
targets.

The backbone's parameters sit at the top level of the state dict, beside
``final_proj*``, ``label_embs_concat``, ``target_glu.0``, ``spk_proj``,
``layer_norm_for_extract``, ``project_q`` and ``quantizer.*``, as the JAX
package's fairseq exporter names them (convert/from_jax.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unispeech_tpu_torch.configs import HubertPretrainConfig, WavLMModelConfig
from unispeech_tpu_torch.models.encoder import Fp32LayerNorm, linear, reset_parameters
from unispeech_tpu_torch.models.wavlm import WavLM
from unispeech_tpu_torch.ops.dropout import device_generator
from unispeech_tpu_torch.ops.quantizer import GumbelVectorQuantizer


def unit_norm(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 scaled to unit L2 norm over its last dim."""
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-12)


def cosine_logits(x: torch.Tensor, embs: torch.Tensor, logit_temp: float) -> torch.Tensor:
    """Dense cosine-similarity logits in fp32: (..., D) x (C, D) -> (..., C)."""
    return (unit_norm(x) @ unit_norm(embs).t()) / logit_temp


def gathered_cosine_logits(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                           logit_temp: float) -> torch.Tensor:
    """(B, T, 1+N) fp32 cosine logits / ``logit_temp`` of each frame's x
    against its own y (column 0) and against the y of the N frames that
    ``idx`` (B, T, N) names by flat (B*T) index.

    The JAX code gathers the (B, T, N, D) targets and normalises each; here
    every row is normalised once and the logits are gathered from the
    (B*T, B*T) product of all frames against all frames, which holds the
    same values in B*T*B*T floats instead of B*T*N*D."""
    B, T, _ = x.shape
    xn = unit_norm(x).reshape(B * T, -1)
    yn = unit_norm(y).reshape(B * T, -1)
    pos = (xn * yn).sum(-1, keepdim=True)
    neg = torch.gather(xn @ yn.t(), 1, idx.reshape(B * T, -1))
    return torch.cat([pos, neg], 1).reshape(B, T, -1) / logit_temp


def instance_uniforms(generator: torch.Generator, n_same: int, n_cross: int,
                      shape, device=None):
    """The SAT sampler's uniforms: (B, T, n_same) and (B, T, n_cross) fp32
    in [0, 1), drawn on ``device`` from a generator seeded by ``generator``."""
    g = device_generator(generator, device)
    return (torch.rand((*shape, n_same), generator=g, device=device),
            torch.rand((*shape, n_cross), generator=g, device=device))


def sample_instance_indices(u_same: torch.Tensor, u_cross: torch.Tensor,
                            lengths: torch.Tensor, T: int) -> torch.Tensor:
    """Flat (B*T) indices of contrastive instances, (B, T, n_same+n_cross),
    from uniforms (``instance_uniforms``), by the JAX code's rank arithmetic:
    per query frame (b, t), ``n_same`` draws uniform over row b's valid
    frames other than t, and ``n_cross`` uniform over the batch's valid
    frames other than (b, t), by rank on the exclusive cumulative lengths.
    A valid query frame never gets an index into padding (a zero-length
    row's same-row draws point at its frame 0, as in the JAX code)."""
    lengths = lengths.to(torch.int32)
    B = lengths.shape[0]
    dev = lengths.device
    t_pos = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    parts = []
    if u_same.shape[-1] > 0:
        hi = torch.clamp(lengths - 1, min=1)[:, None, None]
        r = (u_same * hi).to(torch.int32)
        r = r + (r >= t_pos[..., None]).to(torch.int32)
        r = torch.minimum(r, torch.clamp(lengths[:, None, None] - 1, min=0))
        base = (torch.arange(B, dtype=torch.int32, device=dev) * T)[:, None, None]
        parts.append(base + r)
    if u_cross.shape[-1] > 0:
        cum = torch.cumsum(lengths, 0).to(torch.int32)
        cum_ex = cum - lengths
        total = cum[-1]
        self_rank = cum_ex[:, None] + t_pos
        j = (u_cross * torch.clamp(total - 1, min=1)).to(torch.int32)
        j = j + (j >= self_rank[..., None]).to(torch.int32)
        j = torch.minimum(j, torch.clamp(total - 1, min=0))
        row = torch.searchsorted(cum, j.reshape(-1), right=True).to(torch.int32).reshape(j.shape)
        parts.append(row * T + (j - cum_ex[row.long()]))
    return torch.cat(parts, -1).long()


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
    # the UniSpeech-SAT speaker-contrastive branch
    spk_logits: Optional[torch.Tensor] = None  # (B, T, 1+N) fp32
    spk_targets: Optional[torch.Tensor] = None  # (B, T, 1+N) {0, 1}
    vq_result: Optional[dict] = None


class HubertPretrainModel(WavLM):
    """WavLM backbone + masked-prediction heads. Parameters fp32, compute in
    ``dtype``; ``generator`` seeds the random init."""

    def __init__(self, cfg: HubertPretrainConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        L = cfg.encoder.encoder_layers
        if cfg.utterance_contrastive_loss and not 0 <= cfg.utterance_contrastive_layer <= L:
            # the JAX code's static index clamps to the last layer instead
            raise ValueError(f"utterance_contrastive_layer {cfg.utterance_contrastive_layer} "
                             f"outside the encoder's {L} layers")
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
        if cfg.utterance_contrastive_loss:
            if cfg.encoder.layer_norm_first:
                self.layer_norm_for_extract = Fp32LayerNorm(D, cfg.encoder.layer_norm_eps)
            self.spk_proj = nn.Linear(D, final_dim)
            heads.append(self.spk_proj)
            if cfg.quantize_targets:
                self.quantizer = GumbelVectorQuantizer(cfg.quantizer, D, dtype, generator)
                self.project_q = nn.Linear(cfg.quantizer.vq_dim, final_dim)
                heads.append(self.project_q)
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
        num_updates=0,
    ) -> HubertOutput:
        """``num_updates`` sets the SAT quantizer's temperature."""
        cfg = self.pcfg
        L = cfg.encoder.encoder_layers
        need_taps = (len(self.predict_layers) > 1 or self.predict_layers[0] != L
                     or cfg.utterance_contrastive_loss)
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
        if cfg.utterance_contrastive_loss:
            res["spk_logits"], res["spk_targets"], res["vq_result"] = self._speaker_contrastive(
                out.layer_outputs[cfg.utterance_contrastive_layer], out.padding_mask,
                num_updates, deterministic, generator)
        return HubertOutput(logits=logits,
                            layer_outputs=out.layer_outputs if need_taps else None, **res)

    def _speaker_contrastive(self, spk_x, padding_mask, num_updates, deterministic, generator):
        """The UniSpeech-SAT utterance-contrastive branch: for each frame,
        its own projected (or quantized) representation is the positive and
        N instances are drawn from the batch's valid frames, each labelled 1
        when it comes from the same utterance; (B, T, 1+N) fp32 cosine
        logits and {0, 1} targets. The loss reads them at masked frames."""
        cfg = self.pcfg
        B, T, _ = spk_x.shape
        if padding_mask is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=spk_x.device)
        else:
            lengths = (~padding_mask).sum(-1).to(torch.int32)
        if cfg.encoder.layer_norm_first:
            spk_x = self.layer_norm_for_extract(spk_x)
        proj_x = linear(spk_x, self.spk_proj, self.dtype)
        vq_result = None
        if cfg.quantize_targets:
            vq_result = self.quantizer(spk_x, num_updates=num_updates,
                                       deterministic=deterministic, generator=generator,
                                       padding_mask=padding_mask)
            y = linear(vq_result["x"], self.project_q, self.dtype)
        else:
            y = proj_x
        if self.target_glu is not None:
            y = self.target_glu(y)
        if generator is None:
            raise ValueError("the speaker branch draws its instances from an explicit "
                             "generator")
        u_same, u_cross = instance_uniforms(generator, cfg.num_instances,
                                            cfg.cross_sample_instances, (B, T), spk_x.device)
        idx = sample_instance_indices(u_same, u_cross, lengths, T)
        spk_logits = gathered_cosine_logits(proj_x, y, idx, cfg.logit_temp)
        same_utt = (torch.div(idx, T, rounding_mode="floor")
                    == torch.arange(B, device=idx.device)[:, None, None]).float()
        spk_targets = torch.cat([torch.ones_like(same_utt[..., :1]), same_utt], -1)
        return spk_logits, spk_targets, vq_result
