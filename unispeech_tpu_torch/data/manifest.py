"""TSV audio manifests + audio IO (host numpy).

Manifest format: first line the root dir, then "relpath\\tnum_samples" rows.
A path is a plain audio file or a "archive.zip:offset:length" byte slice of a
stored (uncompressed) zip member. Audio is read with soundfile when it is
installed, else with the stdlib ``wave`` module (16-bit PCM WAV).
"""

from __future__ import annotations

import io
import os
import wave
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

AUDIO_EXTS = (".wav", ".flac", ".ogg")


@dataclass
class Manifest:
    root: str
    paths: List[str]
    sizes: np.ndarray  # (N,) int64 sample counts

    def __len__(self) -> int:
        return len(self.paths)

    def abspath(self, i: int) -> str:
        return os.path.join(self.root, self.paths[i])

    @classmethod
    def load(cls, tsv_path: str) -> "Manifest":
        paths, sizes = [], []
        with open(tsv_path, "r", encoding="utf-8") as f:
            root = f.readline().strip()
            for line in f:
                line = line.strip()
                if not line:
                    continue
                items = line.split("\t")
                paths.append(items[0])
                sizes.append(int(items[1]))
        return cls(root=root, paths=paths, sizes=np.asarray(sizes, dtype=np.int64))


def parse_path(path: str) -> Tuple[str, Optional[Tuple[int, int]]]:
    """Split a manifest path into (file, byte slice or None)."""
    if path.endswith(AUDIO_EXTS):
        return path, None
    parts = path.split(":")
    if len(parts) == 3:
        return parts[0], (int(parts[1]), int(parts[2]))
    return path, None


def read_stored_slice(file_path: str, offset: int, length: int) -> bytes:
    """Byte slice of a stored-zip member."""
    with open(file_path, "rb") as f:
        f.seek(offset)
        return f.read(length)


def _soundfile():
    try:
        import soundfile as sf
    except ImportError:
        return None
    return sf


def _read_wave(src) -> Tuple[np.ndarray, int]:
    with wave.open(src, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("the wave reader takes 16-bit PCM only")
        sr = w.getframerate()
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=-1)
    return raw.astype(np.float32) / 32768.0, sr


def load_audio(path: str, expected_rate: Optional[int] = 16000,
               return_rate: bool = False):
    """Load a mono fp32 waveform in [-1, 1] from a plain path or a
    "zip:offset:length" slice. With return_rate=True returns (wav, rate)
    and skips the rate check."""
    file_path, slc = parse_path(path)
    src = io.BytesIO(read_stored_slice(file_path, *slc)) if slc is not None else file_path
    sf = _soundfile()
    if sf is None:
        wav, sr = _read_wave(src)
    else:
        wav, sr = sf.read(src, dtype="float32")
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    if return_rate:
        return wav, sr
    if expected_rate is not None and sr != expected_rate:
        raise ValueError(f"{path}: sample rate {sr} != expected {expected_rate}")
    return wav
