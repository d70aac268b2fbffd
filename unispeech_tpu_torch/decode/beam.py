"""CTC decoders: best path (Viterbi) and a lexicon/LM prefix beam search.

A copy of the JAX package's ``decode/beam.py`` (host-side numpy and
Python, as fairseq's flashlight decoders run on the host too):
  * ``best_path_decode``: the greedy collapse, the same output as a
    Viterbi path over CTC emissions without a transition matrix.
  * ``CtcBeamDecoder``: a prefix beam search with an optional lexicon trie
    and an optional word-level LM (kenlm if installed, else ``ArpaLM`` for
    ``.arpa`` files).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -math.inf


def logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def best_path_decode(
    log_probs: np.ndarray,  # (T, V)
    length: Optional[int] = None,
    blank_id: int = 0,
) -> List[int]:
    """Best-path (greedy) CTC decode for one utterance."""
    if length is not None:
        log_probs = log_probs[:length]
    ids = log_probs.argmax(-1)
    out, prev = [], -1
    for t in ids:
        t = int(t)
        if t != blank_id and t != prev:
            out.append(t)
        prev = t
    return out


class LexiconTrie:
    """Unit-sequence trie over lexicon words
    (fairseq builds the same as a flashlight Trie)."""

    def __init__(self):
        self.children: Dict[int, "LexiconTrie"] = {}
        self.words: List[str] = []  # complete words ending at this node

    def insert(self, units: Sequence[int], word: str):
        node = self
        for u in units:
            node = node.children.setdefault(u, LexiconTrie())
        node.words.append(word)

    @staticmethod
    def from_lexicon(lexicon: Dict[str, Sequence[Sequence[int]]]) -> "LexiconTrie":
        trie = LexiconTrie()
        for word, spellings in lexicon.items():
            for units in spellings:
                trie.insert(units, word)
        return trie


@dataclass
class _Prefix:
    units: Tuple[int, ...]
    p_b: float = NEG_INF  # log prob ending in blank
    p_nb: float = NEG_INF  # log prob ending in non-blank
    trie: Optional[LexiconTrie] = None  # current position in lexicon trie
    words: Tuple[str, ...] = ()
    lm_state: object = None
    lm_score: float = 0.0

    @property
    def total(self) -> float:
        return logsumexp2(self.p_b, self.p_nb)


class CtcBeamDecoder:
    """Prefix beam search with optional lexicon + word LM.

    Scoring follows the reference KenLM decoder: am + lm_weight * lm +
    word_score per emitted word (w2l_decoder.py:214-224).
    """

    def __init__(
        self,
        beam: int = 50,
        blank_id: int = 0,
        silence_id: Optional[int] = None,  # word-boundary unit, e.g. '|'
        lexicon: Optional[Dict[str, Sequence[Sequence[int]]]] = None,
        lm=None,  # object with .score(state, word) -> (new_state, logprob)
        lm_weight: float = 2.0,
        word_score: float = -1.0,
        beam_threshold: float = 25.0,
    ):
        self.beam = beam
        self.blank_id = blank_id
        self.silence_id = silence_id
        self.trie = LexiconTrie.from_lexicon(lexicon) if lexicon else None
        self.lm = lm
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.beam_threshold = beam_threshold

    def decode(
        self, log_probs: np.ndarray, length: Optional[int] = None
    ) -> List[Tuple[List[int], List[str], float]]:
        """Return n-best [(units, words, score)] sorted best-first."""
        if length is not None:
            log_probs = log_probs[:length]
        T, V = log_probs.shape
        root = self.trie
        init_state = self.lm.start() if self.lm is not None else None
        beams: Dict[tuple, _Prefix] = {
            (): _Prefix(units=(), p_b=0.0, trie=root, lm_state=init_state)
        }
        for t in range(T):
            lp = log_probs[t]
            # prune vocab: only tokens within threshold of the frame max
            cand = np.flatnonzero(lp >= lp.max() - self.beam_threshold)
            nxt: Dict[tuple, _Prefix] = {}

            def get(key, proto: _Prefix) -> _Prefix:
                p = nxt.get(key)
                if p is None:
                    p = _Prefix(
                        units=proto.units,
                        trie=proto.trie,
                        words=proto.words,
                        lm_state=proto.lm_state,
                        lm_score=proto.lm_score,
                    )
                    nxt[key] = p
                return p

            for key, pre in beams.items():
                tot = pre.total
                for v in cand:
                    v = int(v)
                    p_v = float(lp[v])
                    if v == self.blank_id:
                        q = get(key, pre)
                        q.p_b = logsumexp2(q.p_b, tot + p_v)
                        continue
                    last = pre.units[-1] if pre.units else -1
                    if v == last:
                        # repeat without blank: extends p_nb only
                        q = get(key, pre)
                        q.p_nb = logsumexp2(q.p_nb, pre.p_nb + p_v)
                        # with preceding blank: new unit
                        src = pre.p_b
                    else:
                        src = tot
                    if src == NEG_INF:
                        continue
                    ext = self._extend(pre, v)
                    if ext is None:  # lexicon dead-end
                        continue
                    q = get(ext.units, ext)
                    q.p_nb = logsumexp2(q.p_nb, src + p_v)

            scored = sorted(
                nxt.values(), key=lambda p: p.total + self.lm_weight * p.lm_score,
                reverse=True,
            )[: self.beam]
            beams = {p.units: p for p in scored}

        out = []
        for p in beams.values():
            words = list(p.words)
            score = p.total + self.lm_weight * p.lm_score
            out.append((list(p.units), words, score))
        out.sort(key=lambda x: x[2], reverse=True)
        return out

    def _extend(self, pre: _Prefix, v: int) -> Optional[_Prefix]:
        """Extend a prefix by unit v, walking the lexicon trie / LM."""
        units = pre.units + (v,)
        trie = pre.trie
        words = pre.words
        lm_state = pre.lm_state
        lm_score = pre.lm_score
        if self.trie is not None:
            if v == self.silence_id:
                # word boundary: current trie node must complete a word
                if trie is None or not trie.words:
                    return None
                word = trie.words[0]
                words = words + (word,)
                lm_score += self.word_score
                if self.lm is not None:
                    lm_state, s = self.lm.score(lm_state, word)
                    lm_score += s
                trie = self.trie  # reset to root
            else:
                trie = trie.children.get(v) if trie is not None else None
                if trie is None:
                    return None
        return _Prefix(
            units=units, trie=trie, words=words, lm_state=lm_state,
            lm_score=lm_score,
        )


class KenLMWrapper:
    """Word n-gram LM via kenlm when installed (reference requires it,
    w2l_decoder.py:176-183); text .arpa models fall back to the in-tree
    pure-python ArpaLM (decode/arpa.py) so KenLM-style decoding works
    without the C++ package. Binary .bin models still need kenlm."""

    def __new__(cls, path: str):
        try:
            import kenlm  # noqa: gated import
        except ImportError:
            if path.endswith(".bin"):
                raise ImportError(
                    "binary KenLM models need the kenlm package; "
                    "text .arpa works without it"
                )
            from unispeech_tpu_torch.decode.arpa import ArpaLM

            return ArpaLM(path)
        return super().__new__(cls)

    def __init__(self, path: str):
        import kenlm

        self.model = kenlm.Model(path)

    def start(self):
        import kenlm

        state = kenlm.State()
        self.model.BeginSentenceWrite(state)
        return state

    def score(self, state, word: str):
        import kenlm

        out = kenlm.State()
        s = self.model.BaseScore(state, word, out)
        return out, s * math.log(10.0)  # kenlm scores are log10
