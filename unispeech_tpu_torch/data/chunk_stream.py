"""Streaming chunked-audio pipeline for corpora too large to index.

Counterpart of the JAX package's ``data/chunk_stream.py`` (host numpy, the
same batches): shards are zip archives of audio files (the stored-zip
format of the sliced manifests); each epoch visits the shards in a seeded
order, fills a shuffle buffer, length-sorts it, and emits fixed-shape
bucketed batches (B, Tb), with no global index in memory.
"""

from __future__ import annotations

import zipfile
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence

import numpy as np


@dataclass
class ChunkStreamConfig:
    max_sample_size: int = 250_000
    min_sample_size: int = 32_000
    max_tokens: int = 1_400_000  # frame criterion (samples per batch)
    max_sentences: int = 0  # utterance criterion (0 = frames criterion)
    buffer_utterances: int = 512  # shuffle-window size
    num_buckets: int = 8
    sample_rate: int = 16_000
    normalize: bool = False
    random_crop: bool = True
    audio_exts: Sequence[str] = (".wav", ".flac", ".ogg")


class StreamingChunkIterator:
    """Iterate {"source": (B, Tb) f32, "lengths": (B,) i32} batches from zip
    shards without a global index.

    Checkpointable at shard granularity: state = (epoch, shards_done); a
    resumed walk re-enters after the last fully consumed shard. With
    ``num_shards`` > 1 this iterator walks every num_shards-th shard of the
    epoch's order from ``shard_id`` (a data rank's share).
    """

    def __init__(
        self,
        shard_paths: Sequence[str],
        cfg: ChunkStreamConfig,
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        if not shard_paths:
            raise ValueError("no shards")
        self.shards = list(shard_paths)
        self.cfg = cfg
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 1
        self.shards_done = 0
        hi = cfg.max_sample_size
        lo = min(cfg.min_sample_size, hi)
        edges = np.unique(np.linspace(lo, hi, cfg.num_buckets + 1).astype(int)[1:])
        self._buckets = edges

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "shards_done": self.shards_done}

    def load_state_dict(self, d: Dict) -> None:
        self.epoch = int(d["epoch"])
        self.shards_done = int(d["shards_done"])

    # ---------------------------------------------------------------- walk
    def _shard_entries(self, path: str) -> Iterator[np.ndarray]:
        with zipfile.ZipFile(path) as z:
            for info in z.infolist():
                if not info.filename.endswith(tuple(self.cfg.audio_exts)):
                    continue
                data = z.read(info)
                try:
                    wav = _decode(data, self.cfg.sample_rate)
                except Exception:
                    continue
                if len(wav) < self.cfg.min_sample_size:
                    continue
                yield wav

    def _emit(self, buf: List[np.ndarray], rng) -> Iterator[Dict[str, np.ndarray]]:
        """Length-sort the buffer and emit fixed-shape batches."""
        cfg = self.cfg
        sizes = np.asarray([min(len(w), cfg.max_sample_size) for w in buf])
        order = np.lexsort((rng.permutation(len(buf)), sizes))
        cur: List[int] = []
        cur_bucket = -1

        def batch(rows):
            tb = int(self._buckets[np.searchsorted(self._buckets,
                                                   max(sizes[r] for r in rows))])
            out = np.zeros((len(rows), tb), np.float32)
            lengths = np.zeros((len(rows),), np.int32)
            for i, r in enumerate(rows):
                wav = buf[r]
                n = min(len(wav), tb)
                if len(wav) > tb and cfg.random_crop:
                    s = rng.integers(0, len(wav) - tb + 1)
                    wav = wav[s : s + tb]
                w = wav[:tb]
                if cfg.normalize:
                    w = (w - w.mean()) / (w.std() + 1e-8)
                out[i, : len(w)] = w
                lengths[i] = len(w)
            return {"source": out, "lengths": lengths}

        for r in order:
            b = int(self._buckets[np.searchsorted(self._buckets, sizes[r])])
            n_rows = (
                cfg.max_sentences
                or max(int(cfg.max_tokens // max(b, 1)), 1)
            )
            if cur and (b != cur_bucket or len(cur) >= n_rows):
                yield batch(cur)
                cur = []
            cur_bucket = b
            cur.append(int(r))
        if cur:
            yield batch(cur)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        while True:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])
            )
            order = rng.permutation(len(self.shards))
            mine = [int(i) for i in order[self.shard_id :: self.num_shards]]
            buf: List[np.ndarray] = []
            for si in range(self.shards_done, len(mine)):
                for wav in self._shard_entries(self.shards[mine[si]]):
                    buf.append(wav)
                    if len(buf) >= cfg.buffer_utterances:
                        yield from self._emit(buf, rng)
                        buf = []
                self.shards_done = si + 1
            if buf:
                yield from self._emit(buf, rng)
            self.epoch += 1
            self.shards_done = 0


def _decode(data: bytes, expected_rate: int) -> np.ndarray:
    import io

    try:
        import soundfile as sf

        wav, sr = sf.read(io.BytesIO(data), dtype="float32")
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
    except ImportError:
        import wave

        with wave.open(io.BytesIO(data), "rb") as w:
            assert w.getsampwidth() == 2
            sr = w.getframerate()
            raw = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
            if w.getnchannels() > 1:
                raw = raw.reshape(-1, w.getnchannels()).mean(axis=-1)
            wav = raw.astype(np.float32) / 32768.0
    if sr != expected_rate:
        raise ValueError(f"rate {sr} != {expected_rate}")
    return np.ascontiguousarray(wav, np.float32)
