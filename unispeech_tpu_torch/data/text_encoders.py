"""Text encoders: byte, character, subword-nmt BPE, moses, sentencepiece.

A copy of the JAX package's ``data/text_encoders.py`` (pure Python): one
``encode(str) -> str`` / ``decode(str) -> str`` pair per scheme, in
fairseq's conventions (``data/encoders/``), so dictionaries and label
streams interoperate:
  * byte:   UTF-8 bytes mapped to printable "byte-chars" (non-printable
            bytes shifted by +256), space escaped to U+2581, one token per
            byte-char.
  * char:   one token per character, space escaped to U+2581.
  * bpe:    a subword-nmt codes file; the continuation marker "@@" on every
            non-final piece of a word (``post_process`` reverses it).
  * moses:  a gate over ``sacremoses`` when it is installed.
  * sentencepiece: a gate over the ``sentencepiece`` package (its U+2581
            word marker is reversed by ``post_process("sentencepiece")``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

SPACE = " "
SPACE_ESCAPE = "▁"
_WS = re.compile(r"\s+")

# UTF-8 byte <-> printable "byte-char" map (byte_utils.py:12-19): bytes in
# the printable Latin ranges stay themselves, everything else is shifted
# into the U+0100..U+01FF private band so every byte is a single visible
# character that survives text files and dict.txt round trips.
_PRINTABLE = frozenset(
    list(range(0x20, 0x7F)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
)
_B2C = {b: (chr(b) if b in _PRINTABLE else chr(0x100 + b)) for b in range(256)}
_C2B = {c: b for b, c in _B2C.items()}


def byte_encode(text: str) -> str:
    """UTF-8 encode to byte-chars (whitespace runs collapse to one space)."""
    norm = _WS.sub(SPACE, text)
    return "".join(_B2C[b] for b in norm.encode("utf-8"))


def byte_decode(text: str) -> str:
    """Strict inverse of byte_encode; '' when the byte string is invalid."""
    try:
        return bytes(_C2B[c] for c in text).decode("utf-8")
    except (KeyError, ValueError):
        return ""


def smart_byte_decode(text: str) -> str:
    """Decode a possibly-corrupt byte-char string, recovering the maximum
    number of valid characters (model output can split multi-byte
    codepoints; reference byte_utils.py:34-52 does the same DP)."""
    out = byte_decode(text)
    if out or not text:
        return out
    n = len(text)
    # best[i] = (#chars decodable from text[:i], split point)
    best: List[Tuple[int, int]] = [(0, 0)]
    for i in range(1, n + 1):
        cand = (best[i - 1][0], i - 1)  # drop byte i-1
        for w in range(1, min(4, i) + 1):  # UTF-8 chars are 1..4 bytes
            if byte_decode(text[i - w : i]):
                prev = best[i - w][0] + 1
                if prev > cand[0]:
                    cand = (prev, i - w)
        best.append(cand)
    pieces: List[str] = []
    i = n
    while i > 0:
        j = best[i][1]
        seg = byte_decode(text[j:i])
        if seg and best[i][0] == best[j][0] + 1:
            pieces.append(seg)
        i = j
    return "".join(reversed(pieces))


class ByteEncoder:
    """Space-separated byte-char tokens (reference bytes.py)."""

    name = "byte"

    def encode(self, text: str) -> str:
        return SPACE.join(byte_encode(text).replace(SPACE, SPACE_ESCAPE))

    def decode(self, tokens: str) -> str:
        joined = tokens.replace(SPACE, "").replace(SPACE_ESCAPE, SPACE)
        return smart_byte_decode(joined)


class CharEncoder:
    """Space-separated character tokens (reference characters.py)."""

    name = "char"

    def encode(self, text: str) -> str:
        return SPACE.join(_WS.sub(SPACE, text).replace(SPACE, SPACE_ESCAPE))

    def decode(self, tokens: str) -> str:
        return tokens.replace(SPACE, "").replace(SPACE_ESCAPE, SPACE)


_EOW = "</w>"


class SubwordNMTBPE:
    """Apply a subword-nmt codes file (the format `subword-nmt learn-bpe`
    writes: one "left right" merge per line, priority = line order; an
    optional "#version:" header). Replaces the reference's external
    subword_nmt/fastBPE dependency (hub_utils + gpt2-style recipes) with an
    in-tree greedy merge: every word becomes (c0, .., ck-1, ck + '</w>'),
    the lowest-priority-index adjacent pair is merged until none match, and
    non-final pieces carry the reference's "@@" continuation marker that
    post_process strips (data_utils.py:383-386)."""

    name = "bpe"

    def __init__(self, codes_path: str):
        self.merges: Dict[Tuple[str, str], int] = {}
        with open(codes_path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#version:"):
                    continue
                parts = line.split()
                if len(parts) != 2:
                    continue
                pair = (parts[0], parts[1])
                if pair not in self.merges:
                    self.merges[pair] = len(self.merges)
        self._cache: Dict[str, List[str]] = {}

    def _apply_word(self, word: str) -> List[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if not word:
            return []
        symbols = list(word[:-1]) + [word[-1] + _EOW]
        while len(symbols) > 1:
            pairs = list(zip(symbols, symbols[1:]))
            target = min(
                (p for p in pairs if p in self.merges),
                key=self.merges.__getitem__,
                default=None,
            )
            if target is None:
                break
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i + 1 < len(symbols)
                    and (symbols[i], symbols[i + 1]) == target
                ):
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        # strip the word-end marker; continuation marker on non-final pieces
        out = []
        for i, s in enumerate(symbols):
            if s.endswith(_EOW):
                s = s[: -len(_EOW)]
            if i + 1 < len(symbols):
                s = s + "@@"
            if s:
                out.append(s)
        if len(self._cache) < 65536:
            self._cache[word] = out
        return out

    def encode(self, text: str) -> str:
        pieces: List[str] = []
        for word in text.split():
            pieces.extend(self._apply_word(word))
        return SPACE.join(pieces)

    def decode(self, tokens: str) -> str:
        return (tokens + SPACE).replace("@@ ", "").rstrip()


class MosesTokenizer:
    """Gate over sacremoses (reference moses_tokenizer.py); raises with the
    same install hint when the package is absent."""

    name = "moses"

    def __init__(self, lang: str = "en"):
        try:
            from sacremoses import MosesDetokenizer as _D, MosesTokenizer as _T
        except ImportError as e:
            raise ImportError(
                "moses tokenization needs sacremoses (pip install sacremoses)"
            ) from e
        self._tok = _T(lang)
        self._detok = _D(lang)

    def encode(self, text: str) -> str:
        return self._tok.tokenize(text, return_str=True)

    def decode(self, tokens: str) -> str:
        return self._detok.detokenize(tokens.split())


class SentencePieceEncoder:
    """Gate over the sentencepiece package (reference sentencepiece_bpe.py);
    decode is also reachable dep-free via post_process('sentencepiece')."""

    name = "sentencepiece"

    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "sentencepiece encoding needs the sentencepiece package"
            ) from e
        self._sp = spm.SentencePieceProcessor(model_file=model_path)

    def encode(self, text: str) -> str:
        return SPACE.join(self._sp.encode(text, out_type=str))

    def decode(self, tokens: str) -> str:
        return (
            tokens.replace(SPACE, "").replace(SPACE_ESCAPE, SPACE).strip()
        )


def get_text_encoder(
    name: str,
    bpe_codes: Optional[str] = None,
    spm_model: Optional[str] = None,
    lang: str = "en",
):
    """Factory over the encoder family (reference encoder registry)."""
    if name in (None, "none"):
        return None
    if name == "byte":
        return ByteEncoder()
    if name in ("char", "characters"):
        return CharEncoder()
    if name in ("bpe", "subword_nmt"):
        if not bpe_codes:
            raise ValueError("bpe encoder needs a codes file (--bpe-codes)")
        return SubwordNMTBPE(bpe_codes)
    if name == "moses":
        return MosesTokenizer(lang)
    if name == "sentencepiece":
        if not spm_model:
            raise ValueError("sentencepiece encoder needs --spm-model")
        return SentencePieceEncoder(spm_model)
    raise ValueError(f"unknown text encoder: {name}")
