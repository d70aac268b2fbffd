"""Feature frontends: log-mel / fbank / MFCC datasets.

Counterpart of the JAX package's ``data/feats.py`` (host numpy, the same
features and batches): for models that consume precomputed features
(mfcc, logmel, fbank, optionally with per-utterance CMVN) instead of raw
waveforms, batched into fixed-shape (B, T, F) buckets like the raw-audio
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from unispeech_tpu_torch.data.manifest import Manifest, load_audio
from unispeech_tpu_torch.tools.kmeans import mfcc_39


def logmel_spectrogram(
    wav: np.ndarray,
    sample_rate: int = 16_000,
    n_fft: int = 2048,
    n_mels: int = 80,
    hop_length: int = 160,
    win_length: int = 400,
    fmin: float = 50.0,
    top_db: float = 80.0,
    preemph: float = 0.97,
) -> np.ndarray:
    """(T, n_mels) log-mel in [~0, 1]: peak-normalize, pre-emphasis,
    amplitude mel, dB clamped at top_db below the peak, scaled /top_db + 1."""
    wav = wav / (np.abs(wav).max() + 1e-9) * 0.999
    wav = np.concatenate([wav[:1], wav[1:] - preemph * wav[:-1]])
    if len(wav) < win_length:
        wav = np.pad(wav, (0, win_length - len(wav)))
    n_frames = 1 + (len(wav) - win_length) // hop_length
    idx = (
        np.arange(win_length)[None, :]
        + hop_length * np.arange(n_frames)[:, None]
    )
    frames = wav[idx] * np.hanning(win_length)[None, :]
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=-1))  # amplitude (power=1)

    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = mel2hz(
        np.linspace(hz2mel(fmin), hz2mel(sample_rate / 2), n_mels + 2)
    )
    bins = np.floor((n_fft + 1) * mel_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(1, n_mels + 1):
        l, c, r = bins[m - 1], bins[m], bins[m + 1]
        if c > l:
            fb[m - 1, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[m - 1, c:r] = (r - np.arange(c, r)) / (r - c)
    mel = spec @ fb.T
    db = 20.0 * np.log10(np.maximum(mel, 1e-10))
    db = np.maximum(db, db.max() - top_db)
    return (db / top_db + 1.0).astype(np.float32)


def fbank(
    wav: np.ndarray,
    sample_rate: int = 16_000,
    n_bins: int = 80,
    normalize: bool = True,
) -> np.ndarray:
    """(T, n_bins) log-mel filterbank at 10 ms hop with optional
    per-utterance CMVN."""
    feats = logmel_spectrogram(
        wav, sample_rate, n_fft=512, n_mels=n_bins,
        hop_length=sample_rate // 100, win_length=sample_rate // 40,
        fmin=20.0, top_db=200.0, preemph=0.97,
    )
    if normalize:
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
    return feats.astype(np.float32)


def mfcc(wav: np.ndarray, sample_rate: int = 16_000,
         normalize: bool = True) -> np.ndarray:
    """(T, 39) MFCC+deltas with optional utterance CMVN."""
    feats = mfcc_39(wav, sample_rate)
    if normalize:
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
    return feats.astype(np.float32)


_FEATURE_FNS = {"mfcc": mfcc, "fbank": fbank, "logmel": logmel_spectrogram}


@dataclass
class FeatsConfig:
    feature_type: str = "fbank"  # mfcc | fbank | logmel
    sample_rate: int = 16_000
    max_frames: int = 3000
    min_frames: int = 10
    batch_size: int = 16
    num_buckets: int = 8
    shuffle: bool = True


class FeatsIterator:
    """Fixed-shape (B, T, F) feature batches from an audio manifest.

    Yields {"features": (B, T, F) f32, "lengths": (B,) i32}; T is one of
    num_buckets fixed lengths, rows are zero-padded.
    """

    def __init__(self, manifest: Manifest, cfg: FeatsConfig, seed: int = 1):
        if cfg.feature_type not in _FEATURE_FNS:
            raise ValueError(f"unknown feature_type {cfg.feature_type}")
        self.manifest = manifest
        self.cfg = cfg
        self.seed = seed
        self.epoch = 1
        self.batch_offset = 0
        # frame counts at 10 ms hop (logmel uses its own hop; bucket bound
        # is still proportional so bucketing stays valid)
        self._frames = np.minimum(
            manifest.sizes // (cfg.sample_rate // 100) + 1, cfg.max_frames
        )
        self._keep = np.flatnonzero(self._frames >= cfg.min_frames)
        hi = int(self._frames[self._keep].max()) if len(self._keep) else 1
        lo = int(self._frames[self._keep].min()) if len(self._keep) else 1
        edges = np.unique(
            np.linspace(lo, hi, cfg.num_buckets + 1).astype(int)[1:]
        )
        self._buckets = edges

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch_offset": self.batch_offset}

    def load_state_dict(self, d: Dict) -> None:
        self.epoch = int(d["epoch"])
        self.batch_offset = int(d["batch_offset"])

    def _plan(self, epoch: int) -> List[np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        order = self._keep[
            np.lexsort((rng.permutation(len(self._keep)),
                        self._frames[self._keep]))
        ] if self.cfg.shuffle else self._keep[
            np.argsort(self._frames[self._keep], kind="mergesort")
        ]
        batches = [
            order[i : i + self.cfg.batch_size]
            for i in range(0, len(order), self.cfg.batch_size)
        ]
        if self.cfg.shuffle:
            rng.shuffle(batches)
        return batches

    def _collate(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        fn = _FEATURE_FNS[self.cfg.feature_type]
        feats = []
        for r in rows:
            wav = load_audio(self.manifest.abspath(int(r)),
                             self.cfg.sample_rate)
            feats.append(fn(wav)[: self.cfg.max_frames])
        F = feats[0].shape[1]
        longest = max(f.shape[0] for f in feats)
        tb = int(self._buckets[np.searchsorted(self._buckets, longest)])
        out = np.zeros((len(rows), tb, F), np.float32)
        lengths = np.zeros((len(rows),), np.int32)
        for i, f in enumerate(feats):
            out[i, : len(f)] = f
            lengths[i] = len(f)
        return {"features": out, "lengths": lengths}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            plan = self._plan(self.epoch)
            for bi in range(self.batch_offset, len(plan)):
                self.batch_offset = bi + 1
                yield self._collate(plan[bi])
            self.epoch += 1
            self.batch_offset = 0
