"""Model feature dumping for the HuBERT/WavLM label pipeline. MFCC features
and k-means are not ported yet."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np


def dump_model_features(
    apply_fn: Callable[[np.ndarray], np.ndarray],  # (1, n) wav -> (T, D) feats
    wavs: Iterable[np.ndarray],
    max_chunk: int = 1_600_000,
) -> Iterator[np.ndarray]:
    """Chunked feature extraction: long audio is split at max_chunk samples
    and the per-chunk features concatenated."""
    for wav in wavs:
        chunks = []
        for s in range(0, len(wav), max_chunk):
            x = wav[s : s + max_chunk][None, :]
            chunks.append(np.asarray(apply_fn(x)))
        yield np.concatenate(chunks, axis=0)
