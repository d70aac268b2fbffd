"""Shape-static span masking for masked-prediction pretraining.

Counterpart of the JAX package's ``ops/masking.py``, with the same scheme:
K = floor(mask_prob * T / mask_length) + 1 span starts are always drawn
(static shape), each row keeps the first int(mask_prob * len / mask_length +
u) of them (probabilistic rounding), starts are uniform in [0, len -
min_span], spans merge where they overlap, and padding is never masked.

Every sampler draws its random numbers from a ``torch.Generator`` on the
generator's device and moves them, in one non-blocking copy, to the device
of the result, where the mask itself is computed; lengths that live on the
card are never read back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from unispeech_tpu_torch.configs import MaskConfig


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.to(device, non_blocking=True)


def sample_span_mask(
    generator: torch.Generator,
    batch: int,
    seq_len: int,
    cfg: MaskConfig,
    lengths: Optional[torch.Tensor] = None,  # (B,) valid lengths; None = all valid
    device=None,
) -> torch.Tensor:
    """(B, T) bool mask, True = masked, on ``device`` (that of ``lengths``
    when given, else the CPU)."""
    if device is None:
        device = lengths.device if lengths is not None else torch.device("cpu")
    if cfg.mask_prob <= 0.0:
        return torch.zeros((batch, seq_len), dtype=torch.bool, device=device)

    base_k = int(cfg.mask_prob * seq_len / float(cfg.mask_length))
    k = max(base_k + 1, cfg.min_masks)  # +1 slot for probabilistic rounding

    gdev = generator.device
    if cfg.mask_selection == "static":
        span_len = torch.full((batch, k), cfg.mask_length, dtype=torch.int64, device=gdev)
    elif cfg.mask_selection == "uniform":
        span_len = torch.randint(int(cfg.mask_other), cfg.mask_length * 2 + 1, (batch, k),
                                 generator=generator, device=gdev)
    elif cfg.mask_selection == "normal":
        s = torch.randn((batch, k), generator=generator, device=gdev) * cfg.mask_other
        span_len = torch.clamp(torch.round(s + cfg.mask_length), min=1).to(torch.int64)
    elif cfg.mask_selection == "poisson":
        rate = torch.full((batch, k), float(cfg.mask_length), device=gdev)
        span_len = torch.poisson(rate, generator=generator).to(torch.int64)
    else:
        raise ValueError(f"unknown mask_selection {cfg.mask_selection}")
    span_len = span_len.to(device, non_blocking=True)
    u_start = _uniform(generator, (batch, k), device)
    u_round = _uniform(generator, (batch,), device)

    if lengths is None:
        sz = torch.full((batch,), seq_len, dtype=torch.int64, device=device)
    else:
        sz = lengths.to(device=device, dtype=torch.int64)

    min_len = span_len.min(dim=1).values  # (B,)
    hi = torch.clamp(sz - min_len, min=1)
    start = (u_start * hi[:, None].float()).to(torch.int64)  # (B, K)

    n_eff = cfg.mask_prob * sz.float() / float(cfg.mask_length)
    n_active = torch.clamp((n_eff + u_round).to(torch.int64), cfg.min_masks, k)
    span_active = torch.arange(k, device=device)[None, :] < n_active[:, None]

    pos = torch.arange(seq_len, device=device)[None, None, :]
    in_span = (pos >= start[..., None]) & (pos < (start + span_len)[..., None])
    mask = (in_span & span_active[..., None]).any(dim=1)
    return mask & (torch.arange(seq_len, device=device)[None, :] < sz[:, None])


def frame_padding_mask(
    sample_lengths: torch.Tensor,  # (B,) valid waveform lengths
    num_samples: int,
    num_frames: int,
) -> torch.Tensor:
    """(B, T_frames) bool mask, True = padded frame: frame i is padding iff
    all samples of its block of num_samples // num_frames are padding."""
    block = num_samples // num_frames
    frame_idx = torch.arange(
        num_frames, dtype=torch.int32, device=sample_lengths.device)[None, :]
    return frame_idx * block >= sample_lengths.to(torch.int32)[:, None]


def apply_time_mask(x: torch.Tensor, mask: torch.Tensor, mask_emb: torch.Tensor) -> torch.Tensor:
    """Replace masked positions (B, T) of x (B, T, D) with the mask embedding."""
    return torch.where(mask[..., None], mask_emb.to(x.dtype)[None, None, :], x)


def apply_channel_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero masked channels (B, D) across all time steps."""
    return torch.where(mask[:, None, :], torch.zeros((), dtype=x.dtype, device=x.device), x)


def sample_boundary_mask(
    generator: torch.Generator,
    seg_ids: torch.Tensor,  # (B, T) int segment id per frame, -1 = none
    p: float = 0.5,
    max_segments: int = 512,
) -> torch.Tensor:
    """Boundary-aligned masking: each segment is masked with probability p,
    whole segments together; frames with seg_id -1 never are."""
    B, _ = seg_ids.shape
    bern = _uniform(generator, (B, max_segments), seg_ids.device) < p
    safe = torch.clamp(seg_ids, 0, max_segments - 1).to(torch.int64)
    return torch.gather(bern, 1, safe) & (seg_ids >= 0)


def make_streaming_mask(T: int, chunk_size: int, left_chunks: int = -1,
                        neg: float = -1e30, device=None) -> torch.Tensor:
    """(T, T) additive fp32 mask for chunked streaming attention: query t
    attends within its chunk and up to ``left_chunks`` previous chunks
    (-1 = unlimited left context)."""
    chunk = torch.arange(T, device=device) // chunk_size
    q, s = chunk[:, None], chunk[None, :]
    allowed = s <= q
    if left_chunks >= 0:
        allowed = allowed & (s >= q - left_chunks)
    return torch.where(allowed, 0.0, neg).to(torch.float32)


def frames_to_segments(boundaries_s, num_frames: int, frame_rate: float) -> np.ndarray:
    """Host helper: boundary timestamps (seconds) -> (num_frames,) int32
    segment ids (-1 past the last boundary)."""
    ids = np.full((num_frames,), -1, np.int32)
    frames = [int(round(b * frame_rate)) for b in boundaries_s]
    for si, (a, b) in enumerate(zip(frames[:-1], frames[1:])):
        ids[max(a, 0): min(b, num_frames)] = si
    return ids
