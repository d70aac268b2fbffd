"""Speech-to-text TSV dataset (id / audio / n_frames / tgt_text columns).

Counterpart of the JAX package's ``data/s2t.py`` (host numpy, the same
batches): column-formatted TSV manifests whose ``audio`` is a plain file, a
"zip:offset:length" stored slice, or a precomputed-feature ``.npy``, and
whose ``tgt_text`` is the (optionally pre-tokenized) transcript. Batches
are fixed-shape buckets ({source, lengths, targets, target_lengths}) like
the rest of the data layer.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.manifest import load_audio, parse_path, read_stored_slice


@dataclasses.dataclass
class S2TEntry:
    utt_id: str
    audio: str  # path | zip-slice | .npy
    n_frames: int
    tgt_text: Optional[str] = None
    speaker: str = ""
    src_lang: str = ""
    tgt_lang: str = ""


def load_s2t_tsv(path: str, root: Optional[str] = None) -> List[S2TEntry]:
    """Parse a column TSV (id, audio and n_frames columns mandatory); a
    relative audio path is under ``root`` (default: the TSV's directory)."""
    root = root if root is not None else os.path.dirname(os.path.abspath(path))
    out: List[S2TEntry] = []
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(
            f, delimiter="\t", quoting=csv.QUOTE_NONE, doublequote=False,
            lineterminator="\n", quotechar=None,
        )
        for row in reader:
            audio = row["audio"]
            file_part, slc = parse_path(audio)
            if not os.path.isabs(file_part):
                audio = os.path.join(root, audio)
            out.append(
                S2TEntry(
                    utt_id=row["id"],
                    audio=audio,
                    n_frames=int(row["n_frames"]),
                    tgt_text=row.get("tgt_text"),
                    speaker=row.get("speaker", ""),
                    src_lang=row.get("src_lang", ""),
                    tgt_lang=row.get("tgt_lang", ""),
                )
            )
    return out


def load_s2t_source(entry: S2TEntry, sample_rate: int = 16_000) -> np.ndarray:
    """Waveform (n,) or precomputed features (T, F) of one entry."""
    file_part, slc = parse_path(entry.audio)
    if file_part.endswith(".npy"):
        if slc is None:
            return np.load(file_part).astype(np.float32)
        import io

        data = read_stored_slice(file_part, *slc)
        return np.load(io.BytesIO(data)).astype(np.float32)
    return load_audio(entry.audio, sample_rate)


class S2TIterator:
    """Fixed-shape bucketed batches over an S2T TSV.

    Yields {"source": (B, T[, F]), "lengths": (B,), and with a dictionary
    "targets": (B, S) eos-terminated pad-filled ids, "target_lengths"}.
    """

    def __init__(
        self,
        entries: Sequence[S2TEntry],
        tgt_dict: Optional[Dictionary] = None,
        batch_size: int = 8,
        max_frames: int = 480_000,
        num_buckets: int = 8,
        max_target_len: int = 256,
        sample_rate: int = 16_000,
        shuffle: bool = True,
        seed: int = 1,
    ):
        self.entries = list(entries)
        self.tgt_dict = tgt_dict
        self.batch_size = batch_size
        self.max_frames = max_frames
        self.max_target_len = max_target_len
        self.sample_rate = sample_rate
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 1
        self.batch_offset = 0
        sizes = np.asarray(
            [min(e.n_frames, max_frames) for e in self.entries], np.int64
        )
        self._sizes = sizes
        lo, hi = (int(sizes.min()), int(sizes.max())) if len(sizes) else (1, 1)
        self._buckets = np.unique(
            np.linspace(lo, hi, num_buckets + 1).astype(np.int64)[1:]
        )

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch_offset": self.batch_offset}

    def load_state_dict(self, d: Dict) -> None:
        self.epoch = int(d["epoch"])
        self.batch_offset = int(d["batch_offset"])

    def _plan(self, epoch: int) -> List[np.ndarray]:
        n = len(self.entries)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        if self.shuffle:
            order = np.lexsort((rng.permutation(n), self._sizes))
        else:
            order = np.argsort(self._sizes, kind="mergesort")
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _encode_target(self, text: str) -> np.ndarray:
        # truncate before appending eos, so a long transcript keeps its terminator
        ids = np.asarray(self.tgt_dict.encode_line(text), np.int32)
        ids = ids[: self.max_target_len - 1]
        return np.concatenate(
            [ids, np.asarray([self.tgt_dict.eos()], np.int32)]
        )

    def _collate(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        sources = [
            load_s2t_source(self.entries[int(r)], self.sample_rate)
            for r in rows
        ]
        feat_dim = sources[0].shape[1] if sources[0].ndim == 2 else 0
        lengths = np.asarray(
            [min(len(s), self.max_frames) for s in sources], np.int32
        )
        tb = int(self._buckets[np.searchsorted(self._buckets,
                                               int(lengths.max()))])
        shape = (len(rows), tb, feat_dim) if feat_dim else (len(rows), tb)
        src = np.zeros(shape, np.float32)
        for i, s in enumerate(sources):
            s = s[: tb]
            src[i, : len(s)] = s
            lengths[i] = len(s)
        batch = {"source": src, "lengths": lengths}
        if self.tgt_dict is not None:
            tgts = [
                self._encode_target(self.entries[int(r)].tgt_text or "")
                for r in rows
            ]
            # a fixed target width, the same in every batch
            S = self.max_target_len
            out = np.full((len(rows), S), self.tgt_dict.pad(), np.int32)
            tl = np.zeros((len(rows),), np.int32)
            for i, t in enumerate(tgts):
                out[i, : len(t)] = t
                tl[i] = len(t)
            batch["targets"] = out
            batch["target_lengths"] = tl
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            plan = self._plan(self.epoch)
            for bi in range(self.batch_offset, len(plan)):
                self.batch_offset = bi + 1
                yield self._collate(plan[bi])
            self.epoch += 1
            self.batch_offset = 0
