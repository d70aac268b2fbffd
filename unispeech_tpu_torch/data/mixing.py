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

``mix_batch_device`` is the in-step mixer of a batch on its device (one
overlay per row, noise clips pre-cut to the row length by
``NoiseStore.precut``): its draws come from a host ``torch.Generator``
(``mixing_draws``) and move to the batch's device, where
``mix_with_draws``, the math as a function of its draws, runs.

Noise store: a JSON list of {"loc": "h5path\\tkey\\tstart\\tend"} entries over
h5py files holding one int16 "wav" dataset, or a TSV manifest of audio files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


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

    def precut(self, rng: np.random.Generator, n: int, length: int) -> np.ndarray:
        """(n, length) clips for the device mixer: a random window of each
        longer clip, a shorter one zero-padded."""
        out = np.zeros((n, length), np.float32)
        for r in range(n):
            clip = self.get(int(rng.integers(0, len(self))))
            if len(clip) >= length:
                s = int(rng.integers(0, len(clip) - length + 1))
                out[r] = clip[s : s + length]
            else:
                out[r, : len(clip)] = clip
        return out


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


def mixing_draws(generator: torch.Generator, B: int, T: int, cfg: MixingConfig,
                 n_noise: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """The draws of ``mix_batch_device`` for a (B, T) batch, from a host
    generator, moved to ``device``: per row the mix choice ``u_sel``, the
    noise choice ``u_noise`` and noise clip ``nidx`` (with ``n_noise``
    clips), the partner row ``part``, the overlap length ``c_len``, the
    clip and target positions ``u_c``, ``u_s`` and the SNR ``snr_u``."""
    draws = {"u_sel": torch.rand(B, generator=generator)}
    if n_noise:
        draws["u_noise"] = torch.rand(B, generator=generator)
    draws["part"] = torch.randint(0, B, (B,), generator=generator)
    if n_noise:
        draws["nidx"] = torch.randint(0, n_noise, (B,), generator=generator)
    draws["c_len"] = torch.randint(0, cfg.max_overlap(T) + 1, (B,), generator=generator)
    for k in ("u_c", "u_s", "snr_u"):
        draws[k] = torch.rand(B, generator=generator)
    return {k: v.to(device, non_blocking=True) for k, v in draws.items()}


def mix_with_draws(audio: torch.Tensor, draws: Dict[str, torch.Tensor], cfg: MixingConfig,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The device mixer's math on its draws: row b, when ``u_sel`` < the
    mixing probability, gets its partner row (or, when ``u_noise`` < the
    noise probability, noise clip ``nidx``) at the SNR of ``snr_u`` over
    ``c_len`` samples, the clip from position ``u_c`` placed at ``u_s``;
    scales from full-row mean powers."""
    B, T = audio.shape
    do_mix = draws["u_sel"] < cfg.mixing_prob
    src = audio[draws["part"]]
    use_noise = torch.zeros(B, dtype=torch.bool, device=audio.device)
    if noise is not None:
        use_noise = draws["u_noise"] < cfg.mixing_noise_prob
        src = torch.where(use_noise[:, None], noise[draws["nidx"]], src)
    c_len = draws["c_len"]
    c_start = (draws["u_c"] * (T - c_len + 1)).to(torch.int64)
    s_start = (draws["u_s"] * (T - c_len + 1)).to(torch.int64)
    snr_u = draws["snr_u"]
    snr = torch.where(use_noise,
                      cfg.noise_snr_low + snr_u * (cfg.noise_snr_high - cfg.noise_snr_low),
                      cfg.source_snr_low + snr_u * (cfg.source_snr_high - cfg.source_snr_low))
    ref_pow = (audio * audio).mean(-1)
    src_pow = (src * src).mean(-1)
    scale = torch.where(src_pow > 0, torch.sqrt(ref_pow / torch.clamp(
        src_pow * torch.pow(10.0, snr / 10), min=1e-10)), torch.zeros_like(src_pow))
    # src moved so that its sample c_start lands at s_start
    t = torch.arange(T, device=audio.device)[None, :]
    region = (t >= s_start[:, None]) & (t < (s_start + c_len)[:, None])
    shifted = torch.gather(src, 1, (t - (s_start - c_start)[:, None]) % T)
    mixed = audio + torch.where(region, shifted, torch.zeros((), dtype=audio.dtype,
                                                            device=audio.device)) * scale[:, None]
    if cfg.normalize_after:
        mean = mixed.mean(-1, keepdim=True)
        var = mixed.var(-1, keepdim=True, unbiased=False)
        mixed = (mixed - mean) * torch.rsqrt(var + 1e-5)
    return torch.where(do_mix[:, None], mixed, audio)


def mix_batch_device(generator: torch.Generator, audio: torch.Tensor,
                     lengths: Optional[torch.Tensor], cfg: MixingConfig,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mix a (B, T) batch on its device (``lengths`` unused: the mix spans
    the padded row, as the host mixer's): one overlay per row, noise clips
    (N, T) pre-cut by ``NoiseStore.precut``."""
    del lengths
    B, T = audio.shape
    draws = mixing_draws(generator, B, T, cfg, 0 if noise is None else noise.shape[0],
                         device=audio.device)
    return mix_with_draws(audio, draws, cfg, noise)
