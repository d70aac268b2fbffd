"""Memory-mapped binarized token datasets.

A copy of the JAX package's ``data/indexed_dataset.py`` (the reference's
MMapIndexedDataset and binarizer, in a numpy-native format): ``<stem>.bin``
is the flat little-endian int32 token stream, ``<stem>.idx.npz`` holds
``dtype`` and ``sizes`` (each sentence's token count, eos included). Files
either package writes are byte-identical and read by the other.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from unispeech_tpu_torch.data.dictionary import Dictionary


class MMapIndexedDataset:
    """Zero-copy views into the mmap'd token stream."""

    def __init__(self, stem: str):
        idx = np.load(stem + ".idx.npz")
        self.sizes = idx["sizes"].astype(np.int64)
        self.tokens = np.memmap(stem + ".bin", dtype=np.dtype(str(idx["dtype"])), mode="r")
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        if self.offsets[-1] != len(self.tokens):
            raise ValueError(f"index/bin mismatch: {self.offsets[-1]} vs {len(self.tokens)}")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.tokens[self.offsets[i]:self.offsets[i + 1]]

    @property
    def flat(self) -> np.ndarray:
        """The whole stream as one mmap'd array (the LM's token blocks)."""
        return self.tokens


def binarize_text(corpus: str, dictionary: Dictionary, stem: str, append_eos: bool = True,
                  add_if_not_exist: bool = False,
                  encode: Optional[Callable[[str], str]] = None) -> int:
    """Tokenize a text file line by line into ``<stem>.bin`` /
    ``<stem>.idx.npz``, streaming (whitespace tokens through
    ``Dictionary.encode_line``, eos after each line; ``encode`` rewrites each
    line first, e.g. a text encoder). Returns the sentence count."""
    os.makedirs(os.path.dirname(os.path.abspath(stem)), exist_ok=True)
    sizes = []
    with open(stem + ".bin", "wb") as out, open(corpus, encoding="utf-8") as f:
        for line in f:
            if encode is not None:
                line = encode(line.rstrip("\n"))
            line = line.strip()
            if not line:
                continue
            ids = dictionary.encode_line(line, append_eos=append_eos,
                                         add_if_not_exist=add_if_not_exist)
            out.write(np.asarray(ids).astype("<i4").tobytes())
            sizes.append(len(ids))
    np.savez(stem + ".idx", dtype=np.str_("int32"), sizes=np.asarray(sizes, np.int32))
    return len(sizes)
