"""Vector quantizers: the Gumbel-softmax codebooks of wav2vec 2.0 /
UniSpeech / UniSpeech-SAT, and the k-means quantizer of vq-wav2vec.

Counterpart of the JAX package's ``ops/quantizer.py``. The temperature is a
function of the update count passed in by the caller (``temp_at``). The
Gumbel noise comes from ``gumbel_noise``, drawn on the tensor's device by a
generator seeded from the caller's host-side ``torch.Generator``; it is a
module-level function so that a test can replace it with recorded draws.
The codebook combine is the one-hot contraction of the JAX code, a batched
product over the groups. No Pallas kernel computes any of this in the JAX
package, so it stays PyTorch.

One reading differs on purpose: with a ``padding_mask`` the code and prob
perplexities (and so the diversity loss) average over the valid frames
only. The JAX package averages over every frame of a padded batch, which
sends the diversity term's gradient into the padded frames; in the
``layer_norm`` extractor a fully padded frame's LayerNorms have zero
variance, and their backward multiplies that gradient by rsqrt(eps) at
each of the seven layers.

State-dict keys: ``vars`` (1, G*V, var_dim) and ``weight_proj`` (a Linear
at depth 1, else ``weight_proj.{0,2,...}`` Linears with GELUs between), as
the JAX package's fairseq exporter names them. ``KmeansVectorQuantizer``
keeps the JAX package's parameter names (``embedding``, ``proj_kernel``,
``gn_scale``, ``gn_bias``): no exporter maps it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unispeech_tpu_torch.configs import GumbelVQConfig
from unispeech_tpu_torch.models.encoder import linear
from unispeech_tpu_torch.ops.dropout import device_generator


def gumbel_noise(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise (fp32) of ``shape`` on ``device``, drawn by a
    generator seeded from ``generator`` (a CPU torch.Generator)."""
    g = device_generator(generator, device)
    u = torch.rand(shape, generator=g, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_softmax(logits: torch.Tensor, tau, noise: torch.Tensor,
                   hard: bool = True) -> torch.Tensor:
    """Gumbel-softmax over the last dim with the given noise; ``hard``: the
    straight-through one-hot (forward the argmax, gradient the soft)."""
    y_soft = torch.softmax((logits.float() + noise) / tau, dim=-1)
    if not hard:
        return y_soft
    y_hard = F.one_hot(y_soft.argmax(-1), logits.shape[-1]).to(y_soft.dtype)
    return y_hard + y_soft - y_soft.detach()


def _perplexity(probs: torch.Tensor) -> torch.Tensor:
    """sum over groups of exp(entropy) of (G, V) probabilities."""
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-7), dim=-1)).sum()


def _frame_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of (N, ...) over its N frames, or over the valid ones."""
    if valid is None:
        return x.mean(0)
    w = valid.reshape(-1, *([1] * (x.dim() - 1))).to(x.dtype)
    return (x * w).sum(0) / torch.clamp(w.sum(), min=1.0)


class GumbelVectorQuantizer(nn.Module):
    """G groups of V codewords of ``vq_dim // G`` each. Parameters fp32,
    the projection computed in ``dtype``; ``generator`` seeds the init."""

    def __init__(self, cfg: GumbelVQConfig, input_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        G, V = cfg.groups, cfg.num_vars
        if cfg.vq_dim % G:
            raise ValueError(f"vq_dim {cfg.vq_dim} is not a multiple of {G} groups")
        self.vars = nn.Parameter(torch.empty(1, G * V, cfg.vq_dim // G))
        if cfg.weight_proj_depth > 1:
            inner = input_dim * cfg.weight_proj_factor
            layers = []
            for i in range(cfg.weight_proj_depth - 1):
                layers += [nn.Linear(input_dim if i == 0 else inner, inner), nn.GELU()]
            self.weight_proj = nn.Sequential(*layers, nn.Linear(inner, G * V))
        else:
            self.weight_proj = nn.Linear(input_dim, G * V)
        with torch.no_grad():
            self.vars.uniform_(0.0, 1.0, generator=generator)
            if cfg.weight_proj_depth > 1:
                # lecun-normal kernels, zero biases (flax's Dense default)
                for m in self.weight_proj:
                    if isinstance(m, nn.Linear):
                        m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                                         generator=generator)
                        m.bias.zero_()
            else:
                # the reference init: weight ~ N(0, 1), bias 0
                self.weight_proj.weight.normal_(0.0, 1.0, generator=generator)
                self.weight_proj.bias.zero_()

    def codebook(self) -> torch.Tensor:
        """(G, V, var_dim) fp32 codewords."""
        G, V = self.cfg.groups, self.cfg.num_vars
        return self.vars.reshape(G, V, -1).float()

    def forward(self, x: torch.Tensor,  # (B, T, input_dim)
                num_updates=0, deterministic: bool = True, produce_targets: bool = False,
                generator: Optional[torch.Generator] = None,
                padding_mask: Optional[torch.Tensor] = None) -> dict:
        """``deterministic`` takes the argmax codeword; otherwise the
        straight-through Gumbel-softmax at temperature ``temp_at(num_updates)``,
        its noise drawn from ``generator``. ``padding_mask`` (B, T), True at
        padding, keeps the padded frames out of the perplexities."""
        cfg = self.cfg
        G, V = cfg.groups, cfg.num_vars
        B, T, _ = x.shape
        h = x
        if cfg.weight_proj_depth > 1:
            for m in self.weight_proj:
                h = linear(h, m, self.dtype) if isinstance(m, nn.Linear) else F.gelu(h)
        else:
            h = linear(h, self.weight_proj, self.dtype)
        logits = h.reshape(B * T * G, V).float()

        k = logits.argmax(-1)
        hard_x = F.one_hot(k, V).float().reshape(B * T, G, V)
        valid = None if padding_mask is None else ~padding_mask.reshape(-1)
        code_perplexity = _perplexity(_frame_mean(hard_x, valid))
        avg_probs = _frame_mean(torch.softmax(logits.reshape(B * T, G, V), dim=-1), valid)
        prob_perplexity = _perplexity(avg_probs)

        temp = cfg.temp_at(num_updates)
        if deterministic:
            onehot = hard_x
        else:
            if generator is None:
                raise ValueError("the Gumbel noise draws from an explicit generator")
            noise = gumbel_noise(logits.shape, generator, logits.device)
            onehot = gumbel_softmax(logits, temp, noise).reshape(B * T, G, V)
        cw = self.codebook()
        # (G, B*T, V) @ (G, V, var_dim): the one-hot combine per group
        q = torch.bmm(onehot.transpose(0, 1), cw).transpose(0, 1)
        result = {
            "x": q.reshape(B, T, -1).to(x.dtype),
            "num_vars": V * G,
            "code_perplexity": code_perplexity,
            "prob_perplexity": prob_perplexity,
            "temp": temp,
            "codebook": cw,  # for codebook negatives
        }
        if produce_targets:
            result["targets"] = k.reshape(B, T, G)
        return result


class KmeansVectorQuantizer(nn.Module):
    """Hard VQ with straight-through gradients (vq-wav2vec): a grouped 1x1
    projection and a GroupNorm in fp32, the nearest codeword per group by L2
    distance, the code perplexity and the k-means loss (latent + gamma *
    commitment). Parameters fp32, the projection computed in ``dtype``."""

    def __init__(self, dim: int, num_vars: int, groups: int, combine_groups: bool,
                 vq_dim: int, gamma: float = 0.25, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if vq_dim % groups or dim % groups:
            raise ValueError(f"dim {dim} and vq_dim {vq_dim} must split into {groups} groups")
        self.num_vars, self.groups, self.combine_groups = num_vars, groups, combine_groups
        self.gamma, self.dtype = gamma, dtype
        var_dim = vq_dim // groups
        self.embedding = nn.Parameter(torch.empty(num_vars, 1 if combine_groups else groups,
                                                  var_dim))
        self.proj_kernel = nn.Parameter(torch.empty(groups, dim // groups, dim // groups))
        self.gn_scale = nn.Parameter(torch.ones(dim))
        self.gn_bias = nn.Parameter(torch.zeros(dim))
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.01, generator=generator)
            self.proj_kernel.normal_(0.0, 1.0 / math.sqrt(dim // groups), generator=generator)

    def forward(self, x: torch.Tensor, produce_targets: bool = False) -> dict:
        B, T, C = x.shape
        G, V = self.groups, self.num_vars
        xg = x.reshape(B, T, G, C // G)
        ze = torch.einsum("btgi,gio->btgo", xg.to(self.dtype),
                          self.proj_kernel.to(self.dtype)).reshape(B, T, C)
        # GroupNorm(G) over (B, C, T): statistics per (row, group) over the
        # group's channels and time
        zf = ze.float().reshape(B, T, G, C // G)
        mean = zf.mean(dim=(1, 3), keepdim=True)
        var = zf.var(dim=(1, 3), keepdim=True, unbiased=False)
        zf = ((zf - mean) * torch.rsqrt(var + 1e-5)).reshape(B, T, C)
        ze = zf * self.gn_scale + self.gn_bias  # (B, T, C) fp32

        emb = self.embedding.float().expand(V, G, -1)
        zeg = ze.reshape(B, T, G, -1)
        # squared distances up to the per-frame ||ze||^2, which the argmin ignores
        dots = torch.einsum("btgd,vgd->btgv", zeg, emb)
        d2 = (emb ** 2).sum(-1).t()[None, None] - 2.0 * dots
        idx = d2.argmin(-1)  # (B, T, G)
        onehot = F.one_hot(idx, V).float()
        zq = torch.einsum("btgv,vgd->btgd", onehot, emb).reshape(B, T, C)

        out = zq.detach() + ze - ze.detach()
        latent = torch.mean((zq - ze.detach()) ** 2)
        commitment = torch.mean((ze - zq.detach()) ** 2)
        result = {
            "x": out.to(x.dtype),
            "num_vars": V,
            "code_perplexity": _perplexity(onehot.mean(dim=(0, 1))),
            "kmeans_loss": latent + self.gamma * commitment,
        }
        if produce_targets:
            result["targets"] = idx
        return result
