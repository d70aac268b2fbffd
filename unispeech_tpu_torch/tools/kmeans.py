"""HuBERT/WavLM label pipeline: feature dump -> k-means -> frame labels.

Counterpart of the JAX package's ``tools/kmeans.py``:

  * ``mfcc_39``: MFCC-39 (13 MFCC + delta + delta-delta at 100 Hz) in
    numpy, the first iteration's features;
  * ``dump_model_features``: model features chunked at ``max_chunk``
    samples;
  * ``learn_kmeans``: mini-batch k-means (a count-weighted running mean per
    centre, as sklearn's MiniBatchKMeans) from a k-means++ seeding, the
    updates in torch on the given device;
  * ``apply_kmeans``: nearest-centroid labels, one matmul and an argmax.

The seeding and the batch order draw from one ``np.random.Generator`` in the
JAX package's call order, so both give the same centroids from the same
seed. The torch functions run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unispeech_tpu_torch.utils.device import device_or_raise


# --------------------------------------------------------------------- MFCC
def mfcc_39(
    wav: np.ndarray,  # (n,) fp32 16 kHz
    sample_rate: int = 16_000,
    n_mfcc: int = 13,
    frame_ms: float = 25.0,
    hop_ms: float = 10.0,
    n_mels: int = 23,
    n_fft: int = 512,
) -> np.ndarray:
    """(T, 39) MFCC + delta + delta-delta at 100 Hz, HTK style: Hann window,
    power spectrum, triangular mel filterbank, log, orthonormal DCT-II."""
    frame = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * hop_ms / 1000)
    if len(wav) < frame:
        wav = np.pad(wav, (0, frame - len(wav)))
    n_frames = 1 + (len(wav) - frame) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(frame)[None, :]
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=-1)) ** 2  # (T, F)

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = mel2hz(np.linspace(hz2mel(20.0), hz2mel(sample_rate / 2), n_mels + 2))
    bins = np.floor((n_fft + 1) * mel_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        if c > l:
            fb[m - 1, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[m - 1, c:r] = (r - np.arange(c, r)) / (r - c)
    logmel = np.log(np.maximum(spec @ fb.T, 1e-10))  # (T, n_mels)

    # orthonormal DCT-II, the first n_mfcc coefficients
    k = np.arange(n_mels)
    dct = np.cos(np.pi * np.outer(np.arange(n_mfcc), 2 * k + 1) / (2 * n_mels))
    dct *= np.sqrt(2.0 / n_mels)
    dct[0] /= np.sqrt(2.0)
    mfcc = logmel @ dct.T  # (T, n_mfcc)

    def delta(x, width: int = 2):
        pad = np.pad(x, ((width, width), (0, 0)), mode="edge")
        num = sum(i * (pad[width + i : len(x) + width + i] -
                       pad[width - i : len(x) + width - i]) for i in range(1, width + 1))
        den = 2 * sum(i * i for i in range(1, width + 1))
        return num / den

    d1 = delta(mfcc)
    d2 = delta(d1)
    return np.concatenate([mfcc, d1, d2], axis=-1).astype(np.float32)


# --------------------------------------------------- model feature dumping
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


# ------------------------------------------------------------- k-means
@dataclass
class KmeansModel:
    centroids: np.ndarray  # (K, D) fp32

    def save(self, path: str) -> None:
        np.save(path, self.centroids)

    @classmethod
    def load(cls, path: str) -> "KmeansModel":
        return cls(np.load(path))


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row: argmax of 2 x.c - |c|^2 (|x|^2 is constant
    per row)."""
    c2 = (centroids * centroids).sum(-1)
    return torch.argmax(2.0 * (x @ centroids.t()) - c2[None, :], dim=-1)


def _kmeanspp_init(
    x: np.ndarray, k: int, rng: np.random.Generator, subsample: int = 100_000
) -> np.ndarray:
    """k-means++ seeding: the first centre uniform, then each proportional
    to the squared distance to the nearest chosen centre."""
    if len(x) > subsample:
        x = x[rng.choice(len(x), subsample, replace=False)]
    if len(x) < k:
        x = np.concatenate([x] * (k // len(x) + 1), axis=0)
    centers = np.empty((k, x.shape[1]), np.float32)
    centers[0] = x[rng.integers(len(x))]
    d2 = np.sum((x - centers[0]) ** 2, -1)
    for i in range(1, k):
        p = d2 / max(d2.sum(), 1e-12)
        centers[i] = x[rng.choice(len(x), p=p)]
        d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, -1))
    return centers


def learn_kmeans(
    feature_batches: Iterable[np.ndarray],  # (n_i, D) batches, one pass per epoch
    n_clusters: int,
    seed: int = 0,
    epochs: int = 1,
    init_batch: Optional[np.ndarray] = None,
    device="cuda",
) -> KmeansModel:
    """Mini-batch k-means: per batch, each centre moves toward the mean of
    its assigned rows by (batch count) / (running count)."""
    device = device_or_raise(device)
    rng = np.random.default_rng(seed)
    batches = list(feature_batches)
    if not batches:
        raise ValueError("no features")
    if init_batch is None:
        init_batch = np.concatenate(batches[: max(1, len(batches) // 4)], axis=0)
    centroids = torch.from_numpy(
        _kmeanspp_init(init_batch.astype(np.float32), n_clusters, rng)).to(device)
    counts = torch.ones((n_clusters,), dtype=torch.float32, device=device)
    for _ in range(epochs):
        for bi in rng.permutation(len(batches)):
            x = torch.from_numpy(np.asarray(batches[bi], np.float32)).to(device)
            onehot = F.one_hot(_assign(x, centroids), n_clusters).float()  # (n, K)
            batch_counts = onehot.sum(0)
            batch_sums = onehot.t() @ x  # (K, D)
            counts = counts + batch_counts
            lr = batch_counts / torch.clamp(counts, min=1.0)
            batch_means = batch_sums / torch.clamp(batch_counts[:, None], min=1.0)
            centroids = centroids + lr[:, None] * (batch_means - centroids)
    return KmeansModel(centroids.cpu().numpy())


def apply_kmeans(model: KmeansModel, features: np.ndarray, device="cuda") -> np.ndarray:
    """Frame labels (T,): the nearest centroid of each row of (T, D)."""
    device = device_or_raise(device)
    x = torch.tensor(np.asarray(features, np.float32), device=device)
    centroids = torch.tensor(np.asarray(model.centroids, np.float32), device=device)
    return _assign(x, centroids).cpu().numpy()


def write_label_file(path: str, label_seqs: Iterable[np.ndarray]) -> None:
    """One space-separated line per utterance (the .km format)."""
    with open(path, "w", encoding="utf-8") as f:
        for labs in label_seqs:
            f.write(" ".join(str(int(x)) for x in labs) + "\n")
