"""Neural-LM shallow fusion for the CTC prefix beam decoder.

Counterpart of the JAX package's ``decode/lm_fusion.py`` (the reference's
``W2lFairseqLMDecoder``): a word-level TransformerLM scores each completed
word of the lexicon beam search, with the KenLM wrapper's contract
(``start`` / ``score`` / ``finish``), so ``CtcBeamDecoder`` takes either.
Each distinct prefix's next-word log-softmax is one forward of the prefix
right-padded to the scoring window, on the model's device under
``torch.no_grad()``, computed once and cached per state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from unispeech_tpu_torch.data.dictionary import Dictionary
from unispeech_tpu_torch.models.lm import TransformerLM, TransformerLMConfig


class NeuralLMScorer:
    """Word-level LM scorer. A state is the tuple of word ids consumed so
    far, starting with </s> (fairseq LMs condition on it as bos); ``score``
    returns (new state, log p(word | state)) in natural log. Unknown words
    score as <unk>."""

    def __init__(self, model: TransformerLM, word_dict: Dictionary, window: int = 128):
        self.model = model.eval()
        self.dict = word_dict
        self.window = window
        self._pad = model.cfg.padding_idx
        self._device = next(model.parameters()).device
        self._cache: Dict[Tuple[int, ...], np.ndarray] = {}

    def start(self):
        return (self.dict.eos(),)

    @torch.no_grad()
    def _next_logprobs(self, state: Tuple[int, ...]) -> np.ndarray:
        got = self._cache.get(state)
        if got is not None:
            return got
        ctx = state[-self.window:]
        toks = torch.full((1, self.window), self._pad, dtype=torch.long)
        toks[0, :len(ctx)] = torch.tensor(ctx)
        logits = self.model(toks.to(self._device))
        # the next-token distribution after the prefix
        out = torch.log_softmax(logits[0, len(ctx) - 1], dim=-1).cpu().numpy()
        self._cache[state] = out
        return out

    def score(self, state, word: str):
        wid = self.dict.index(word)
        lp = self._next_logprobs(tuple(state))
        return tuple(state) + (wid,), float(lp[wid])

    def finish(self, state) -> float:
        """log p(</s> | state), the sentence-end score."""
        return float(self._next_logprobs(tuple(state))[self.dict.eos()])


def load_neural_lm(checkpoint: str, dict_path: str, window: int = 128,
                   device="cuda") -> NeuralLMScorer:
    """A TransformerLM that ``train train-lm --export-params`` wrote (a
    params .npz in the JAX package's layout), fp32 on ``device``. Its config
    is ``<stem>.json`` beside the checkpoint or, failing that,
    ``lm_config.json`` in its directory."""
    from unispeech_tpu_torch.convert.from_jax import load_params_npz, lm_state_dict_from_jax

    cfg_path = os.path.splitext(checkpoint)[0] + ".json"
    if not os.path.exists(cfg_path):
        alt = os.path.join(os.path.dirname(checkpoint) or ".", "lm_config.json")
        if os.path.exists(alt):
            cfg_path = alt
    with open(cfg_path) as f:
        cfg = TransformerLMConfig(**json.load(f))
    model = TransformerLM(cfg)
    model.load_state_dict(lm_state_dict_from_jax(load_params_npz(checkpoint)), strict=True)
    return NeuralLMScorer(model.to(device), Dictionary.load(dict_path), window=window)
