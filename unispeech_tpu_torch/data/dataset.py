"""Epoch-checkpointable pretraining batches over an audio manifest.

Counterpart of the JAX package's ``data/dataset.py`` (``DataConfig``,
``PretrainIterator``): numpy batches of a fixed set of bucket shapes, made
deterministically from (seed, epoch, batch index), so (epoch, batch_offset)
is the whole resumable state. The same manifest, label files, transcripts
and seed give the JAX package's batches bit for bit. ``FinetuneIterator``
adds the CTC transcripts. The multilingual resampling (``lang_groups``)
and ``Seq2SeqIterator`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from unispeech_tpu_torch.data.batching import (
    batch_by_size,
    bucket_for,
    chunk_shuffled_indices,
    length_buckets,
    ordered_indices,
    shard_batches,
)
from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.data.labels import LabelFile, align_labels_to_frames, crop_labels
from unispeech_tpu_torch.data.manifest import Manifest, load_audio
from unispeech_tpu_torch.data.mixing import MixingConfig, NoiseStore, mix_batch_host
from unispeech_tpu_torch.data.prefetch import parallel_map_io


@dataclass
class DataConfig:
    """Dataset and task knobs, the JAX package's fields and defaults."""

    max_sample_size: int = 250_000  # crop bound (~15.6 s)
    min_sample_size: int = 32_000
    max_tokens: int = 1_400_000  # token budget per batch (samples)
    max_sentences: int = 0
    sample_rate: int = 16_000
    label_rate: float = 50.0
    normalize: bool = False  # host-side per-utterance normalize
    num_buckets: int = 8
    random_crop: bool = True
    shuffle: bool = True
    required_batch_size_multiple: int = 8
    num_workers: int = 8  # audio-read threads per batch
    # every batch of bucket length Tb has exactly fixed_bsz(Tb) rows (a short
    # batch is padded with zero rows of length 0), so a run sees at most
    # num_buckets batch shapes
    fixed_shapes: bool = True


class PretrainIterator:
    """Audio (and optional frame-label) batches for pretraining.

    Yields dicts: source (B, Tb) f32, lengths (B,) i32 and, with label
    files, targets (B, Tf, num_sets) i32 and target_valid (B, Tf, num_sets)
    f32. Tb is one of a fixed set of bucket lengths and Tf its frame count.
    Frames no label covers get target 0 and target_valid 0 (the clamp keeps
    every target a valid class index; the loss does not read target_valid).
    """

    def __init__(
        self,
        manifest: Manifest,
        cfg: DataConfig,
        label_files: Sequence[LabelFile] = (),
        frame_hop: int = 320,
        frames_fn=None,  # num_samples -> num_frames (EncoderConfig.num_frames)
        mixing: Optional[MixingConfig] = None,
        noise: Optional[NoiseStore] = None,
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        self.manifest = manifest
        self.cfg = cfg
        self.labels = list(label_files)
        self.frame_hop = frame_hop
        self.frames_fn = frames_fn or (lambda n: max((n - 400) // frame_hop + 1, 0))
        self.mixing = mixing
        self.noise = noise
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 1
        self.batch_offset = 0
        sizes = np.minimum(manifest.sizes, cfg.max_sample_size)
        self._keep = np.flatnonzero(manifest.sizes >= cfg.min_sample_size)
        self._sizes = sizes
        # zip-sharded manifests keep archive locality when shuffled
        self._chunk_ids = manifest.chunk_ids()
        kept = sizes[self._keep]
        self._buckets = length_buckets(
            int(kept.max()) if len(kept) else cfg.max_sample_size,
            min_size=min(cfg.min_sample_size, int(kept.min()) if len(kept)
                         else cfg.min_sample_size),
            num_buckets=cfg.num_buckets,
            multiple=frame_hop,
        )

    # -- resumable state -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch_offset": self.batch_offset}

    def load_state_dict(self, d: Dict) -> None:
        self.epoch = int(d["epoch"])
        self.batch_offset = int(d["batch_offset"])

    # -- epoch plan --------------------------------------------------------
    def fixed_bsz(self, bucket_len: int) -> int:
        """Rows per batch at bucket length Tb, a function of the bucket
        alone, so (B, Tb) is fixed per bucket."""
        cfg = self.cfg
        nb = max(int(cfg.max_tokens // bucket_len), 1) if cfg.max_tokens else 1
        m = cfg.required_batch_size_multiple
        if m > 1 and nb >= m:
            nb = nb // m * m
        if cfg.max_sentences:
            nb = min(nb, cfg.max_sentences)
        return max(nb, 1)

    def _plan(self, epoch: int) -> List[np.ndarray]:
        pool = self._keep
        if self._chunk_ids is not None and self.cfg.shuffle:
            idx = pool[chunk_shuffled_indices(
                self._sizes[pool], self._chunk_ids[pool], self.seed, epoch,
                self.cfg.max_sample_size)]
        else:
            idx = pool[ordered_indices(self._sizes[pool], self.seed, epoch,
                                       shuffle=self.cfg.shuffle)]
        if self.cfg.fixed_shapes:
            # exact-size batches per bucket; idx is length-sorted, so rows
            # arrive bucket by bucket
            bl = bucket_for(self._sizes[idx], self._buckets)
            batches = []
            buf: List[int] = []
            cur = -1
            for row, b in zip(idx, bl):
                if buf and (b != cur or len(buf) == self.fixed_bsz(cur)):
                    batches.append(np.asarray(buf))
                    buf = []
                cur = int(b)
                buf.append(int(row))
            if buf:
                batches.append(np.asarray(buf))
        else:
            batches = batch_by_size(
                idx, self._sizes[idx], max_tokens=self.cfg.max_tokens,
                max_sentences=self.cfg.max_sentences,
                bsz_mult=self.cfg.required_batch_size_multiple)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, 7919]))
        perm = rng.permutation(len(batches))
        batches = [batches[i] for i in perm]
        return shard_batches(batches, self.num_shards, self.shard_id)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            plan = self._plan(self.epoch)
            for bi in range(self.batch_offset, len(plan)):
                self.batch_offset = bi + 1
                yield self._collate(plan[bi], self.epoch, bi)
            self.epoch += 1
            self.batch_offset = 0

    def epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for bi, batch in enumerate(self._plan(epoch)):
            yield self._collate(batch, epoch, bi)

    # -- collation ---------------------------------------------------------
    def _collate(self, idx: np.ndarray, epoch: int, bi: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, bi, 104729]))
        # reads fan out over threads; the crop draws stay in row order below
        wavs = parallel_map_io(
            lambda i: load_audio(self.manifest.abspath(int(i)), cfg.sample_rate),
            list(idx), workers=cfg.num_workers)
        crops: List[np.ndarray] = []
        starts: List[int] = []
        for wav in wavs:
            if cfg.normalize:
                wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
            n = len(wav)
            target = min(n, cfg.max_sample_size)
            start = (int(rng.integers(0, n - target + 1))
                     if (cfg.random_crop and n > target) else 0)
            crops.append(wav[start : start + target])
            starts.append(start)

        lengths = np.asarray([len(c) for c in crops], dtype=np.int32)
        Tb = int(bucket_for(np.asarray([lengths.max()]), self._buckets)[0])
        B = len(crops)
        source = np.zeros((B, Tb), dtype=np.float32)
        for r, c in enumerate(crops):
            source[r, : len(c)] = c

        if self.mixing is not None:
            source = mix_batch_host(rng, source, lengths, self.mixing, noise=self.noise)

        batch: Dict[str, np.ndarray] = {"source": source, "lengths": lengths}
        if self.labels:
            Tf = self.frames_fn(Tb)
            feat2tar = cfg.label_rate * self.frame_hop / cfg.sample_rate
            targets = np.full((B, Tf, len(self.labels)), -1, dtype=np.int32)
            for si, lf in enumerate(self.labels):
                for r, i in enumerate(idx):
                    lab = crop_labels(lf.get(int(i)), starts[r], int(lengths[r]),
                                      cfg.sample_rate, lf.label_rate)
                    targets[r, :, si], _ = align_labels_to_frames(lab, Tf, feat2tar, pad_id=-1)
            batch["targets"] = np.maximum(targets, 0)
            batch["target_valid"] = (targets >= 0).astype(np.float32)
        if self.cfg.fixed_shapes:
            batch = _pad_rows(batch, self.fixed_bsz(Tb))
        return batch


def _pad_rows(batch: Dict[str, np.ndarray], B_target: int) -> Dict[str, np.ndarray]:
    """Zero-row pad every array of the batch to B_target rows. Padded rows
    have length 0, so the mask sampler and the loss give them no weight."""
    B = batch["source"].shape[0]
    if B >= B_target:
        return batch
    pad = B_target - B
    return {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)], axis=0)
            for k, v in batch.items()}


class FinetuneIterator(PretrainIterator):
    """Audio and transcript batches for CTC fine-tuning.

    ``transcripts``: one text line per manifest row (letter format, e.g.
    "H E L L O | W O R L D |"), encoded with ``dictionary``. Batches gain
    labels (B, S) i32 filled with ``dictionary.pad()`` and label_lengths
    (B,) i32; a zero-length padding row has label length 0. Under
    ``fixed_shapes`` S is one length for the whole dataset (the longest
    transcript, in multiples of 8), so a batch's shape varies only with its
    audio bucket. A crop of audio longer than ``max_sample_size`` keeps the
    utterance's whole transcript, as in the JAX package.
    """

    def __init__(self, manifest: Manifest, cfg: DataConfig, transcripts: Sequence[str],
                 dictionary: Dictionary, **kw):
        super().__init__(manifest, cfg, label_files=(), **kw)
        if len(transcripts) != len(manifest):
            raise ValueError(f"{len(transcripts)} transcripts for {len(manifest)} "
                             "manifest rows")
        self.dictionary = dictionary
        self.enc = [dictionary.encode_line(t) for t in transcripts]
        self._S_fixed = int(np.ceil(max((len(e) for e in self.enc), default=1) / 8) * 8) or 8

    def _collate(self, idx, epoch, bi):
        batch = super()._collate(idx, epoch, bi)
        labs = [self.enc[int(i)] for i in idx]
        if self.cfg.fixed_shapes:
            S = self._S_fixed
        else:
            S = int(np.ceil(max(max(len(l) for l in labs), 1) / 8) * 8)
        B = batch["source"].shape[0]  # the zero-length padding rows included
        labels = np.full((B, S), self.dictionary.pad(), dtype=np.int32)
        lab_len = np.zeros((B,), dtype=np.int32)
        for r, l in enumerate(labs):
            labels[r, :len(l)] = l
            lab_len[r] = len(l)
        batch["labels"] = labels
        batch["label_lengths"] = lab_len
        return batch
