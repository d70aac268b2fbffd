"""Language-modeling data: token-block batches over tokenized text.

A copy of the JAX package's ``data/lm_dataset.py`` (host numpy; the
reference's ``language_modeling`` task over ``TokenBlockDataset``): the
corpus becomes one flat int32 id array with </s> after each line, sliced
into contiguous blocks, batched into fixed-shape (B, block) windows in an
order drawn from (seed, epoch), so (epoch, batch_offset) is the whole
resumable state. The same corpus and seed give the JAX package's batches
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from unispeech_tpu_torch.data.dictionary import Dictionary


def tokenize_corpus(path: str, dictionary: Dictionary) -> np.ndarray:
    """A whitespace-tokenized text file as a flat id array, eos after each
    non-empty line."""
    ids: List[int] = []
    eos = dictionary.eos()
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids.extend(dictionary.index(tok) for tok in line.split())
            ids.append(eos)
    return np.asarray(ids, np.int32)


@dataclasses.dataclass
class TokenBlockDataset:
    """Contiguous blocks of ``block_size`` inputs and the one target after
    them (fairseq's "none" break mode)."""

    tokens: np.ndarray  # flat (N,)
    block_size: int

    def __len__(self) -> int:
        return max((len(self.tokens) - 1) // self.block_size, 0)

    def __getitem__(self, i: int) -> np.ndarray:
        s = i * self.block_size
        return self.tokens[s:s + self.block_size + 1]  # (block + 1,)


class LMIterator:
    """Endless fixed-shape batches ``{"tokens": (B, block) inputs,
    "targets": (B, block) next tokens}``; a short block is padded with
    ``padding_idx``, which the loss masks. With ``num_shards`` > 1 this
    iterator yields every num_shards-th batch of each epoch from
    ``shard_id`` (the data ranks' shares, the tail that does not fill a
    round dropped), ``batch_offset`` counting this shard's batches."""

    def __init__(self, dataset: TokenBlockDataset, batch_size: int, padding_idx: int,
                 seed: int = 1, epoch: int = 0, batch_offset: int = 0, num_shards: int = 1,
                 shard_id: int = 0):
        self.dataset = dataset
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.batch_size = batch_size
        self.padding_idx = padding_idx
        self.seed = seed
        self.epoch = epoch
        self.batch_offset = batch_offset

    def state_dict(self):
        return {"epoch": self.epoch, "batch_offset": self.batch_offset}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])
        self.batch_offset = int(state["batch_offset"])

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        block = self.dataset.block_size
        if n // self.batch_size < self.num_shards:
            raise ValueError(
                f"corpus too small: {n} blocks of {block} tokens cannot fill one batch of "
                f"{self.batch_size} for each of {self.num_shards} data rank(s); reduce "
                "--batch-size/--block-size or add data")
        while True:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])).permutation(n)
            for bi in range(self.batch_offset, n // self.batch_size // self.num_shards):
                gi = bi * self.num_shards + self.shard_id
                idx = order[gi * self.batch_size:(gi + 1) * self.batch_size]
                buf = np.full((self.batch_size, block + 1), self.padding_idx, np.int32)
                for r, i in enumerate(idx):
                    chunk = self.dataset[int(i)]
                    buf[r, :len(chunk)] = chunk
                self.batch_offset = bi + 1
                yield {"tokens": buf[:, :-1], "targets": buf[:, 1:]}
            self.epoch += 1
            self.batch_offset = 0
