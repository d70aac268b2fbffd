"""Edit distance and WER/UER scoring.

Counterpart of the JAX package's ``decode/wer.py``: Levenshtein distances
from the native kernel (``native/packer.cpp``), with the numpy row DP
``edit_distance_plain`` as its plain version, and fairseq's
``post_process`` detokenization.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two sequences of hashables."""
    from unispeech_tpu_torch.native import edit_distance_native

    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    vocab: dict = {}
    return edit_distance_native([vocab.setdefault(x, len(vocab)) for x in a],
                                [vocab.setdefault(x, len(vocab)) for x in b])


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """The numpy row DP of ``edit_distance``: its plain version."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    vocab: dict = {}
    ai = [vocab.setdefault(x, len(vocab)) for x in a]
    bb = np.asarray([vocab.setdefault(x, len(vocab)) for x in b])
    j_idx = np.arange(len(b) + 1)
    prev = j_idx.copy()
    for i, x in enumerate(ai, 1):
        # t[j] = min(prev[j] + 1 [deletion], prev[j-1] + cost [substitution]);
        # insertions give cur[j] = min_{k<=j} t[k] + (j - k), a running
        # minimum (t[0] = i is the row boundary)
        t = np.empty(len(b) + 1, dtype=np.int64)
        t[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + (bb != x), out=t[1:])
        prev = np.minimum.accumulate(t - j_idx) + j_idx
    return int(prev[-1])


def post_process(sentence: str, symbol: str) -> str:
    """Detokenize a unit string (fairseq's ``data_utils.post_process``);
    byte and char route through the matching text encoders."""
    if symbol == "sentencepiece":
        return sentence.replace(" ", "").replace("▁", " ").strip()
    if symbol == "wordpiece":
        return sentence.replace(" ", "").replace("_", " ").strip()
    if symbol == "letter":
        return sentence.replace(" ", "").replace("|", " ").strip()
    if symbol == "silence":
        return re.sub(" +", " ", sentence.replace("<SIL>", "")).strip()
    if symbol == "_EOW":
        return sentence.replace(" ", "").replace("_EOW", " ").strip()
    if symbol in ("subword_nmt", "bpe", "@@ ", "@@"):
        return (sentence + " ").replace("@@ ", "").rstrip()
    if symbol == "byte":
        from unispeech_tpu_torch.data.text_encoders import ByteEncoder

        return ByteEncoder().decode(sentence)
    if symbol in ("char", "characters"):
        from unispeech_tpu_torch.data.text_encoders import CharEncoder

        return CharEncoder().decode(sentence)
    if symbol == "none" or symbol is None:
        return sentence
    raise ValueError(f"unknown post_process symbol: {symbol}")


class WerScorer:
    """Accumulating WER/UER meter (word and character error sums)."""

    def __init__(self):
        self.w_errs = 0
        self.w_len = 0
        self.c_errs = 0
        self.c_len = 0

    def add(self, hyp: str, ref: str) -> None:
        hyp_words, ref_words = hyp.split(), ref.split()
        self.w_errs += edit_distance(hyp_words, ref_words)
        self.w_len += len(ref_words)
        self.c_errs += edit_distance(list(hyp), list(ref))
        self.c_len += len(ref)

    @property
    def wer(self) -> float:
        return 100.0 * self.w_errs / max(self.w_len, 1)

    @property
    def uer(self) -> float:
        return 100.0 * self.c_errs / max(self.c_len, 1)
