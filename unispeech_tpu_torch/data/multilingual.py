"""Multilingual temperature resampling (UniSpeech on CommonVoice).

Counterpart of the JAX package's ``data/multilingual.py`` (host numpy,
copied): per-language sampling probability p_l proportional to
(n_l / N)^alpha, size ratio r_l = p_l * N / n_l, and per epoch ceil(n_l *
r_l) uniform draws of each language's rows, with replacement when r_l >= 1.
alpha < 1 upsamples the low-resource languages. The row multiset of an
epoch is a pure function of (seed, epoch, language), so an iterator's
(epoch, batch_offset) stays its whole resumable state.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from unispeech_tpu_torch.data.manifest import Manifest


def multilang_sample_probs(lengths: np.ndarray, alpha: float) -> np.ndarray:
    """p_l proportional to (n_l / N)^alpha, normalised."""
    lengths = np.asarray(lengths, dtype=np.float64)
    prob = lengths / lengths.sum()
    smoothed = prob**alpha
    return smoothed / smoothed.sum()


def multilang_size_ratios(lengths: np.ndarray, alpha: float) -> np.ndarray:
    """r_l = p_l * N / n_l."""
    lengths = np.asarray(lengths, dtype=np.float64)
    return multilang_sample_probs(lengths, alpha) * lengths.sum() / lengths


def concat_manifests(manifests: Sequence[Manifest]) -> Tuple[Manifest, List[np.ndarray]]:
    """One manifest of the per-language ones (paths made root-absolute, so
    differing roots coexist) and each language's row indices into it."""
    paths: List[str] = []
    sizes: List[np.ndarray] = []
    groups: List[np.ndarray] = []
    off = 0
    for m in manifests:
        paths.extend(os.path.join(m.root, p) for p in m.paths)
        sizes.append(np.asarray(m.sizes))
        groups.append(np.arange(off, off + len(m)))
        off += len(m)
    return (Manifest(root="", paths=paths,
                     sizes=np.concatenate(sizes) if sizes else np.zeros(0, np.int64)),
            groups)


def resampled_rows(rows: np.ndarray, size_ratio: float, seed: int, epoch: int,
                   lang_id: int) -> np.ndarray:
    """One language's row multiset for an epoch: ceil(n * r) uniform draws,
    with replacement iff r >= 1."""
    n = len(rows)
    if n == 0:
        return rows
    m = int(np.ceil(n * size_ratio))
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, lang_id, 6007]))
    if size_ratio >= 1.0:
        picks = rng.integers(0, n, m)
    else:
        picks = rng.choice(n, size=m, replace=False)
    return rows[picks]
