"""Symbol dictionary for CTC labels and text targets.

A copy of the JAX package's ``data/dictionary.py`` (pure Python). It keeps
fairseq's Dictionary conventions: the special symbols ``<s> <pad> </s>
<unk>`` take indices 0-3 (bos doubles as the CTC blank, as in fairseq's
``criterions/ctc.py``), ``dict.txt`` lines are "symbol count", and a json
vocab ({"symbol": index}) loads too. A sentencepiece processor is optional
and needs the ``sentencepiece`` package.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPACE_NORMALIZER = re.compile(r"\s+")


class Dictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        extra_special_symbols: Optional[Iterable[str]] = None,
    ):
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices: Dict[str, int] = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        for s in extra_special_symbols or []:
            self.add_symbol(s)
        self.nspecial = len(self.symbols)
        self.processor = None  # optional sentencepiece tokenizer

    def load_spm(self, spm_model: str) -> None:
        """Attach a sentencepiece processor: ``encode_line`` then splits raw
        text into pieces before the lookup. Needs ``sentencepiece``."""
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                "sentencepiece is required for spm_model dictionaries; "
                "install it or use letter/word dictionaries") from e
        self.processor = spm.SentencePieceProcessor()
        self.processor.load(spm_model)

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def blank(self) -> int:
        """The CTC blank: bos."""
        return self.bos_index

    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def encode_line(self, line: str, append_eos: bool = False,
                    add_if_not_exist: bool = False) -> np.ndarray:
        """Whitespace-split encoding; with a sentencepiece processor, raw
        text is split into pieces first."""
        if self.processor is not None:
            words = self.processor.encode_as_pieces(line)
        else:
            words = SPACE_NORMALIZER.sub(" ", line).strip().split()
        ids = [self.add_symbol(w) if add_if_not_exist else self.index(w) for w in words]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(self, ids: Sequence[int], ignore: Sequence[int] = ()) -> str:
        skip = set(ignore) | {self.pad_index}
        return " ".join(self[int(i)] for i in ids if int(i) not in skip)

    @classmethod
    def load(cls, path: str, spm_model: Optional[str] = None) -> "Dictionary":
        """Load a dict.txt ("symbol count" lines) or a json vocab
        ({"symbol": index}); ``spm_model`` attaches a sentencepiece
        tokenizer for ``encode_line``."""
        d = cls()
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        if path.endswith(".json") or text.lstrip().startswith("{"):
            vocab = json.loads(text)
            for sym, _ in sorted(vocab.items(), key=lambda kv: kv[1]):
                if sym not in d.indices:
                    d.add_symbol(sym)
        else:
            for line in text.splitlines():
                line = line.rstrip()
                if not line:
                    continue
                parts = line.rsplit(" ", 1)
                n = (int(parts[1]) if len(parts) == 2 and parts[1].lstrip("-").isdigit()
                     else 1)
                d.add_symbol(parts[0], n=n)
        if spm_model:
            d.load_spm(spm_model)
        return d

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for sym, n in zip(self.symbols[self.nspecial:], self.count[self.nspecial:]):
                f.write(f"{sym} {n}\n")

    @classmethod
    def letters(cls) -> "Dictionary":
        """The LibriSpeech letter dictionary (``|`` is the word boundary)."""
        d = cls()
        for ch in "| E T A O N I H S R D L U M W C F G Y P B V K ' X J Q Z".split():
            d.add_symbol(ch)
        return d
