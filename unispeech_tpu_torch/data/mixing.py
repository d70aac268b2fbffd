"""Utterance and noise mixing (WavLM denoising pretraining), host numpy.

Counterpart of the JAX package's ``data/mixing.py`` (``mix_batch_host``):
with probability ``mixing_prob`` per utterance, overlay ``mixing_num`` clips,
each another utterance of the batch (uniform over B, itself included, SNR ~
U(source_snr_low, source_snr_high) dB) or, with probability
``mixing_noise_prob``, a noise clip (SNR ~ U(noise_snr_low,
noise_snr_high) dB). The clip length is U{0..max_overlap(T)}, clip and
target positions are uniform, the scale is sqrt(ref_pow / (src_pow *
10^(snr/10))) over full-utterance mean powers, and a mixed row is
layer-normalised afterwards with ``normalize_after``. The RNG calls come in
the JAX package's order, so the same generator state gives the same batch.
The JAX package's in-step device mixer (``mix_batch_device``) is not ported
yet.

Noise store: a JSON list of {"loc": "h5path\\tkey\\tstart\\tend"} entries over
h5py files holding one int16 "wav" dataset, or a TSV manifest of audio files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class MixingConfig:
    mixing_prob: float = 0.2
    mixing_num: int = 1  # overlays per chosen utterance
    # < 0: overlaps up to T // 2, else up to T // mixing_max_len
    mixing_max_len: int = -1
    source_snr_low: float = -5.0  # utterance-mix SNR range (dB)
    source_snr_high: float = 5.0
    noise_snr_low: float = -5.0  # noise-mix SNR range (dB)
    noise_snr_high: float = 20.0
    mixing_noise_prob: float = 0.0  # probability a mix uses noise
    mixing_noise_num: int = 1
    normalize_after: bool = False  # layer-norm mixed rows

    def max_overlap(self, T: int) -> int:
        m = T // 2 if self.mixing_max_len < 0 else T // self.mixing_max_len
        return min(m, T)


class NoiseStore:
    """Noise clips for denoising pretraining, loaded lazily; h5py files
    (only for the JSON format) stay open in a handle cache."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = {}
        if path.endswith(".json"):
            with open(path) as f:
                self.entries = json.load(f)
            self.kind = "h5"
        else:
            from unispeech_tpu_torch.data.manifest import Manifest

            self.manifest = Manifest.load(path)
            self.entries = list(range(len(self.manifest)))
            self.kind = "tsv"

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, i: int) -> np.ndarray:
        if self.kind == "h5":
            import h5py  # optional, only for the JSON-of-h5py format

            path, key, start, end = self.entries[i]["loc"].split("\t")
            if path not in self._h5:
                self._h5[path] = h5py.File(path, "r")["wav"]
            clip = self._h5[path][int(start) : int(end)]
            return clip.astype(np.float32) / np.iinfo(np.int16).max
        from unispeech_tpu_torch.data.manifest import load_audio

        return load_audio(self.manifest.abspath(i))

    def sample(self, rng: np.random.Generator, n: int) -> List[np.ndarray]:
        return [self.get(int(rng.integers(0, len(self)))) for _ in range(n)]


def _layer_norm_1d(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / np.sqrt(x.var() + 1e-5)


def mix_batch_host(
    rng: np.random.Generator,
    audio: np.ndarray,  # (B, T) float32
    lengths: Optional[np.ndarray],  # unused: the mix spans the padded row
    cfg: MixingConfig,
    noise: Optional[NoiseStore] = None,
    noise_clips: Optional[Sequence[np.ndarray]] = None,
) -> np.ndarray:
    """The mixed copy of ``audio``."""
    B, T = audio.shape
    out = audio.copy()
    max_len = cfg.max_overlap(T)

    def overlay(i: int, src: np.ndarray) -> None:
        src_T = len(src)
        c_len = min(int(rng.integers(0, max_len + 1)), src_T)
        c_end = int(rng.integers(c_len, src_T + 1))
        c_start = c_end - c_len
        s_end = int(rng.integers(c_len, T + 1))
        s_start = s_end - c_len
        out[i, s_start:s_end] += src[c_start:c_end]

    def scale(ref: np.ndarray, src: np.ndarray, snr_low: float, snr_high: float) -> float:
        ref_pow = float(np.mean(ref ** 2))
        src_pow = float(np.mean(src ** 2))
        if src_pow == 0:
            return 0.0
        snr = rng.uniform(snr_low, snr_high)
        return (ref_pow / (src_pow * 10 ** (snr / 10))) ** 0.5

    for i in range(B):
        if rng.random() >= cfg.mixing_prob:
            continue
        use_noise = ((noise is not None or noise_clips is not None)
                     and rng.random() < cfg.mixing_noise_prob)
        if use_noise:
            if noise_clips is not None:
                picks = [noise_clips[int(rng.integers(0, len(noise_clips)))]
                         for _ in range(cfg.mixing_noise_num)]
            else:
                picks = noise.sample(rng, cfg.mixing_noise_num)
            for clip in picks:
                overlay(i, clip * scale(out[i], clip, cfg.noise_snr_low, cfg.noise_snr_high))
        else:
            for c in rng.integers(0, B, size=cfg.mixing_num):  # itself included
                overlay(i, audio[c] * scale(out[i], audio[c], cfg.source_snr_low,
                                            cfg.source_snr_high))
        if cfg.normalize_after:
            out[i] = _layer_norm_1d(out[i])
    return out
