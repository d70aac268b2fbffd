"""EEND-style speaker diarization on SSL features.

Counterpart of the JAX package's ``downstream/diarization.py``: the
transformer head (a projection, pre-LN self-attention layers, per-speaker
sigmoid logits and activity-weighted speaker vectors), the
permutation-invariant BCE loss, and the numpy inference (chunking, AHC with
cannot-link constraints, median filtering, RTTM) and DER scoring, copied.

Modules carry the flax tree's names (``layer_0.MultiHeadDotProductAttention_0
.query``, ``out_norm``, ...). Two flax conventions are kept: LayerNorm eps
1e-6, and the padding mask ``ok[q] & ok[k]`` filled with the fp32 minimum
before the softmax, so a padded query row, which has no key, comes out
uniform and finite (a boolean-masked SDPA gives NaN there). The head's
attention (head dim 32) is plain matmul and softmax, as the JAX package
runs it through XLA, not through a kernel.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unispeech_tpu_torch.downstream.ecapa_tdnn import LayerNorm, lecun_init


@dataclasses.dataclass(frozen=True)
class DiarizationConfig:
    num_speakers: int = 3  # local speakers per chunk
    hidden_dim: int = 256
    num_layers: int = 4
    num_heads: int = 8
    ffn_dim: int = 1024
    emb_dim: int = 256  # speaker-vector dim
    dropout: float = 0.1


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention): q, k, v
    projections to (heads, head_dim), q scaled by 1/sqrt(head_dim), masked
    logits set to the fp32 minimum, softmax, dropout broadcast over batch
    and heads, the out projection."""

    def __init__(self, dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (p(x).view(B, T, H, hd) for p in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(hd), dtype=q.dtype)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, -1)
        if generator is not None and self.dropout > 0.0:
            keep_prob = 1.0 - self.dropout
            keep = torch.rand((1, 1, T, T), generator=generator) < keep_prob
            w = w * (keep.to(w.device, w.dtype) / keep_prob)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D)
        return self.out(o)


class DiarizationLayer(nn.Module):
    """Pre-LN transformer layer: LN, self-attention, residual; LN, ReLU
    feed-forward, residual."""

    def __init__(self, cfg: DiarizationConfig):
        super().__init__()
        D = cfg.hidden_dim
        self.LayerNorm_0 = LayerNorm(D)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            D, cfg.num_heads, cfg.dropout)
        self.LayerNorm_1 = LayerNorm(D)
        self.Dense_0 = nn.Linear(D, cfg.ffn_dim)
        self.Dense_1 = nn.Linear(cfg.ffn_dim, D)

    def forward(self, x, padding_mask=None, generator=None):
        mask = None
        if padding_mask is not None:
            ok = ~padding_mask
            mask = ok[:, None, None, :] & ok[:, None, :, None]
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x), mask, generator)
        return x + self.Dense_1(F.relu(self.Dense_0(self.LayerNorm_1(x))))


@dataclasses.dataclass
class DiarizationOutput:
    logits: torch.Tensor  # (B, T, S) per-speaker activity logits, fp32
    spk_vectors: torch.Tensor  # (B, S, E) chunk-level speaker vectors


class TransformerDiarization(nn.Module):
    """The EEND head over (B, T, feat_dim) SSL features; fp32. With a
    ``generator`` (a CPU torch.Generator) the attention dropout runs;
    without, it is deterministic."""

    def __init__(self, cfg: DiarizationConfig, feat_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Linear(feat_dim, cfg.hidden_dim)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DiarizationLayer(cfg))
        self.out_norm = LayerNorm(cfg.hidden_dim)
        self.out_proj = nn.Linear(cfg.hidden_dim, cfg.num_speakers)
        self.spk_proj = nn.Linear(cfg.hidden_dim, cfg.emb_dim * cfg.num_speakers)
        lecun_init(self, generator)

    def forward(self, feats: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> DiarizationOutput:
        cfg = self.cfg
        x = self.in_proj(feats.float())
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, padding_mask, generator)
        x = self.out_norm(x)
        logits = self.out_proj(x)
        # speaker vectors: activity-weighted averages of per-speaker frame
        # embeddings
        B, T, _ = x.shape
        emb = self.spk_proj(x).view(B, T, cfg.num_speakers, cfg.emb_dim)
        act = torch.sigmoid(logits)
        if padding_mask is not None:
            act = act.masked_fill(padding_mask[..., None], 0.0)
        denom = act.sum(1).clamp_min(1e-4)[..., None]  # (B, S, 1)
        spk = torch.einsum("bts,btse->bse", act, emb) / denom
        return DiarizationOutput(logits=logits, spk_vectors=spk)


def pit_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 padding_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-invariant BCE (the EEND objective): the minimum over
    speaker permutations of the summed per-frame BCE. Returns (the mean
    over the batch of each row's loss per valid frame and speaker, the
    index of each row's best permutation in ``itertools.permutations``
    order)."""
    S = logits.shape[-1]
    logits, labels = logits.float(), labels.float()
    valid = (torch.ones(logits.shape[:2], device=logits.device) if padding_mask is None
             else (~padding_mask).float())
    losses = []
    for perm in itertools.permutations(range(S)):
        lp = logits[..., list(perm)]
        bce = lp.clamp_min(0) - lp * labels + torch.log1p(torch.exp(-lp.abs()))
        losses.append((bce.sum(-1) * valid).sum(-1))  # (B,)
    all_losses = torch.stack(losses, -1)  # (B, P)
    best = all_losses.argmin(-1)
    denom = (valid.sum(-1) * S).clamp_min(1.0)
    return (all_losses.min(-1).values / denom).mean(), best


# ---------------------------------------------------------------- inference
def ahc_cluster(vectors: np.ndarray, threshold: float = 0.6,
                cannot_link: Optional[List[Tuple[int, int]]] = None) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance with
    cannot-link constraints (speakers of one chunk must differ). Returns
    cluster ids (N,)."""
    N = len(vectors)
    v = vectors / np.maximum(np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-9)
    dist = 1.0 - v @ v.T
    forbidden = set()
    for a, b in cannot_link or []:
        forbidden.add((a, b))
        forbidden.add((b, a))
    clusters: List[List[int]] = [[i] for i in range(N)]

    def cluster_dist(ci, cj):
        return float(np.mean([dist[a, b] for a in ci for b in cj]))

    def linked(ci, cj):
        return any((a, b) in forbidden for a in ci for b in cj)

    while len(clusters) > 1:
        best, bi, bj = None, -1, -1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                if linked(clusters[i], clusters[j]):
                    continue
                d = cluster_dist(clusters[i], clusters[j])
                if best is None or d < best:
                    best, bi, bj = d, i, j
        if best is None or best > threshold:
            break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
    ids = np.zeros(N, np.int32)
    for cid, members in enumerate(clusters):
        for m in members:
            ids[m] = cid
    return ids


def median_filter(activity: np.ndarray, width: int = 11) -> np.ndarray:
    """Per-speaker median smoothing of binary activity over time."""
    if width <= 1:
        return activity
    pad = width // 2
    padded = np.pad(activity, ((pad, pad), (0, 0)), mode="edge")
    out = np.empty_like(activity)
    for t in range(activity.shape[0]):
        out[t] = np.median(padded[t:t + width], axis=0)
    return out


def to_rttm(activity: np.ndarray, frame_shift_s: float, uri: str = "utt") -> str:
    """RTTM segment lines from (T, S) binary frame activity."""
    lines = []
    T, S = activity.shape
    for s in range(S):
        on = None
        for t in range(T + 1):
            a = activity[t, s] if t < T else 0
            if a and on is None:
                on = t
            elif not a and on is not None:
                start = on * frame_shift_s
                dur = (t - on) * frame_shift_s
                lines.append(f"SPEAKER {uri} 1 {start:.3f} {dur:.3f} "
                             f"<NA> <NA> spk{s} <NA> <NA>")
                on = None
    return "\n".join(lines)


def chunked_diarization(infer_fn, feats: np.ndarray, chunk_size: int = 2000,
                        threshold: float = 0.6, activity_floor: float = 0.05,
                        median_width: int = 11) -> np.ndarray:
    """Whole-recording diarization by chunks. ``infer_fn`` maps (T_c, D)
    features to (logits (T_c, S), speaker vectors (S, E)). Each chunk's
    local speakers active on more than ``activity_floor`` of its frames
    contribute a vector; AHC over all of them, with same-chunk cannot-links,
    assigns global ids; the local activities are stitched into a (T,
    n_global) matrix and median-filtered. Returns the binary global
    activity."""
    T = len(feats)
    chunks = [feats[i:i + chunk_size] for i in range(0, T, chunk_size)]
    vecs: List[np.ndarray] = []
    cannot: List[Tuple[int, int]] = []
    chunk_acts: List[np.ndarray] = []
    chunk_active: List[List[int]] = []
    for ch in chunks:
        logits, sv = infer_fn(ch)
        logits = np.asarray(logits, np.float32)
        sv = np.asarray(sv, np.float32)
        act = (1.0 / (1.0 + np.exp(-logits))) > 0.5  # (Tc, S)
        active = [s for s in range(act.shape[1]) if act[:, s].mean() > activity_floor]
        ids_here = []
        for s in active:
            ids_here.append(len(vecs))
            vecs.append(sv[s])
        for a in range(len(ids_here)):
            for b in range(a + 1, len(ids_here)):
                cannot.append((ids_here[a], ids_here[b]))
        chunk_acts.append(act)
        chunk_active.append(active)

    if not vecs:
        return np.zeros((T, 1), np.float32)
    ids = ahc_cluster(np.stack(vecs), threshold, cannot)
    n_global = int(ids.max()) + 1
    out = np.zeros((T, n_global), np.float32)
    pos, k = 0, 0
    for act, active in zip(chunk_acts, chunk_active):
        for s in active:
            out[pos:pos + len(act), ids[k]] = np.maximum(out[pos:pos + len(act), ids[k]],
                                                         act[:, s])
            k += 1
        pos += len(act)
    return (median_filter(out, median_width) > 0.5).astype(np.float32)


# ---------------------------------------------------------------- DER
def parse_rttm(text: str) -> List[Tuple[str, float, float, str]]:
    """[(uri, start, dur, speaker)] from RTTM lines."""
    out = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 8 or parts[0] != "SPEAKER":
            continue
        out.append((parts[1], float(parts[3]), float(parts[4]), parts[7]))
    return out


def _segments_to_activity(segs: List[Tuple[str, float, float, str]], frame_shift: float,
                          T: int) -> Tuple[np.ndarray, List[str]]:
    spks = sorted({s for _, _, _, s in segs})
    act = np.zeros((T, len(spks)), bool)
    for _, start, dur, spk in segs:
        a = int(round(start / frame_shift))
        b = int(round((start + dur) / frame_shift))
        act[a:min(b, T), spks.index(spk)] = True
    return act, spks


def compute_der(ref_rttm: str, hyp_rttm: str, frame_shift: float = 0.02) -> dict:
    """Frame-based diarization error rate with the optimal speaker mapping
    (md-eval's decomposition without a collar: DER = (miss + false alarm +
    confusion) / reference speech time)."""
    ref_segs = parse_rttm(ref_rttm)
    hyp_segs = parse_rttm(hyp_rttm)
    end = 0.0
    for _, s, d, _ in ref_segs + hyp_segs:
        end = max(end, s + d)
    T = int(np.ceil(end / frame_shift)) + 1
    ref, _ = _segments_to_activity(ref_segs, frame_shift, T)
    hyp, _ = _segments_to_activity(hyp_segs, frame_shift, T)

    # optimal ref -> hyp mapping by overlap: every assignment for casts of
    # up to 8, greedy beyond
    overlap = ref.astype(np.int64).T @ hyp.astype(np.int64)  # (R, H)
    R, H = overlap.shape
    if 0 < R <= 8 and 0 < H <= 8:
        best_map, best_score = {}, -1
        for perm in itertools.permutations(range(H), min(R, H)):
            m = dict(zip(range(min(R, H)), perm))
            score = sum(overlap[r, h] for r, h in m.items())
            if score > best_score:
                best_score, best_map = score, m
    else:
        best_map = {}
        used = set()
        for r in np.argsort(-overlap.max(axis=1) if H else []):
            for h in np.argsort(-overlap[r]):
                if h not in used:
                    best_map[int(r)] = int(h)
                    used.add(int(h))
                    break

    mapped_match = np.zeros(T)
    for r, h in best_map.items():
        mapped_match += ref[:, r] & hyp[:, h]
    n_ref = ref.sum(axis=1)
    n_hyp = hyp.sum(axis=1)
    miss = np.maximum(n_ref - n_hyp, 0).sum()
    fa = np.maximum(n_hyp - n_ref, 0).sum()
    conf = (np.minimum(n_ref, n_hyp) - mapped_match).sum()
    speech = max(n_ref.sum(), 1)
    return {
        "der": float((miss + fa + conf) / speech),
        "miss": float(miss / speech),
        "false_alarm": float(fa / speech),
        "confusion": float(conf / speech),
    }
