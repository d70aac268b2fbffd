"""A pure-Python ARPA n-gram language model with Katz backoff.

A copy of the JAX package's ``decode/arpa.py``. The beam decoder needs only
``start()`` and ``score(state, word)``, so a text ``.arpa`` file is served
without the kenlm package (``KenLMWrapper`` in ``decode/beam.py`` prefers
kenlm when it is installed; binary ``.bin`` models need it).

Scoring follows the ARPA contract: P(w | h) is the stored probability of
the longest matching n-gram (h, w); when it is absent, the backoff weights
of the receding histories add up:
  logP(w | h) = b(h) + logP(w | h[1:]).
All scores are natural logs (ARPA stores log10; converted at load).
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Tuple

_LN10 = math.log(10.0)


class ArpaLM:
    def __init__(self, path: str):
        # ngram tuple -> (ln prob, ln backoff)
        self.ngrams: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self.order = 0
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            section = 0  # current n in the \n-grams: block; 0 = header
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if line.startswith("\\"):  # \data\ or \end\
                    section = 0
                    continue
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    prob, words = parts[0], parts[1 : 1 + section]
                    rest = parts[1 + section :]
                    backoff = rest[0] if rest else None
                else:
                    prob = parts[0]
                    words = parts[1].split()
                    backoff = parts[2] if len(parts) > 2 else None
                self.ngrams[tuple(words)] = (
                    float(prob) * _LN10,
                    float(backoff) * _LN10 if backoff is not None else 0.0,
                )
        if not self.ngrams:
            raise ValueError(f"no n-grams parsed from {path}")

    # -- KenLMWrapper-compatible surface ------------------------------------
    def start(self) -> Tuple[str, ...]:
        return ("<s>",)

    def score(
        self, state: Tuple[str, ...], word: str
    ) -> Tuple[Tuple[str, ...], float]:
        if (word,) not in self.ngrams and word != "</s>":
            word = "<unk>"
        logp = self._logp(state, word)
        new_state = (state + (word,))[-(self.order - 1) :] if self.order > 1 else ()
        # recede the state until it is a known history (kenlm does the same
        # internally; keeps backoff lookups O(order))
        while new_state and new_state not in self.ngrams:
            new_state = new_state[1:]
        return new_state, logp

    def finish(self, state: Tuple[str, ...]) -> float:
        """ln P(</s> | state) — sentence-end term the reference adds at the
        end of each hypothesis."""
        return self._logp(state, "</s>")

    def _logp(self, history: Tuple[str, ...], word: str) -> float:
        hist: List[str] = list(history[-(self.order - 1) :]) if self.order > 1 else []
        backoff_sum = 0.0
        while True:
            entry = self.ngrams.get(tuple(hist) + (word,))
            if entry is not None:
                return backoff_sum + entry[0]
            if not hist:
                # completely unknown word with no <unk> entry: hard floor
                return backoff_sum - 20.0 * _LN10
            b = self.ngrams.get(tuple(hist))
            if b is not None:
                backoff_sum += b[1]
            hist = hist[1:]
