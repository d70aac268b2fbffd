"""Frame-label loading and label-rate alignment (host numpy).

Counterpart of the JAX package's ``data/labels.py``: offset-indexed label
files (the ``.km`` files of the k-means pipeline), the audio/label duration
check, the crop of a label stream in step with an audio crop, and the
resampling of labels onto encoder frames by index arithmetic.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class LabelFile:
    """One label stream: a text file with one space-separated frame-label
    line per utterance. Lines are offset-indexed once, so random access
    never reads the file through."""

    def __init__(self, path: str, label_rate: float):
        self.path = path
        self.label_rate = label_rate
        self.offsets: List[Tuple[int, int]] = []
        with open(path, "r", encoding="utf-8") as f:
            off = 0
            for line in f:
                n = len(line)
                self.offsets.append((off, off + n))
                off += n

    def __len__(self) -> int:
        return len(self.offsets)

    def get(self, i: int) -> np.ndarray:
        s, e = self.offsets[i]
        with open(self.path, "r", encoding="utf-8") as f:
            f.seek(s)
            line = f.read(e - s)
        return np.asarray(line.split(), dtype=np.int32)


def verify_label_lengths(
    audio_sizes: Sequence[int],
    label_lengths: Sequence[int],
    sample_rate: float,
    label_rate: float,
    tol: float = 0.1,
) -> None:
    """Warn about utterances whose audio and label durations differ by more
    than ``tol`` seconds (the first five by index, then the count)."""
    bad = 0
    for i, (asz, lsz) in enumerate(zip(audio_sizes, label_lengths)):
        dur_a = asz / sample_rate
        dur_l = lsz / label_rate
        if abs(dur_a - dur_l) > tol:
            bad += 1
            if bad <= 5:
                logger.warning("audio/label duration mismatch at %d: %.3fs vs %.3fs",
                               i, dur_a, dur_l)
    if bad:
        logger.warning("%d utterances had audio/label length mismatches", bad)


def align_labels_to_frames(
    labels: np.ndarray,  # (L,) frame labels at label_rate
    num_frames: int,  # encoder frames of the (cropped) audio
    feat2tar_ratio: float,  # label_rate * frame_hop / sample_rate
    start_frame: int = 0,  # frame offset of the audio crop
    pad_id: int = -1,
) -> Tuple[np.ndarray, int]:
    """target[t] = labels[int((start_frame + t) * feat2tar_ratio)] over the
    frames the label stream covers. Returns (targets padded with pad_id to
    num_frames, the number of covered frames)."""
    idx = ((start_frame + np.arange(num_frames)) * feat2tar_ratio).astype(np.int64)
    valid = int(np.searchsorted(idx, len(labels), side="left"))
    out = np.full((num_frames,), pad_id, dtype=np.int32)
    out[:valid] = labels[idx[:valid]]
    return out, valid


def crop_labels(
    labels: np.ndarray,
    audio_start: int,
    audio_frames: int,
    sample_rate: float,
    label_rate: float,
) -> np.ndarray:
    """The labels of an audio crop of ``audio_frames`` samples from
    ``audio_start``."""
    s2f = label_rate / sample_rate
    start = int(round(audio_start * s2f))
    length = int(round(audio_frames * s2f))
    return labels[start : start + length]
