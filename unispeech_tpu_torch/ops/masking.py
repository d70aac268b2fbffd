"""Frame padding mask. The span-mask samplers come with the training slice."""

from __future__ import annotations

import torch


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
