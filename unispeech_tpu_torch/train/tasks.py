"""Task glue: a loss function binding model and criterion.

Counterpart of the JAX package's ``train/tasks.py`` (``make_hubert_loss_fn``,
``make_wav2vec2_loss_fn``, ``make_ctc_finetune_loss_fn``,
``make_ctc_valid_decode_fn``):
``loss_fn(batch, generator, step)`` returns (loss sum, sample_size,
metrics) of the model it binds (JAX passes the params; here the model holds
them).
"""

from __future__ import annotations

import torch

from unispeech_tpu_torch.models.ctc import CtcFinetuneModel
from unispeech_tpu_torch.models.hubert import HubertPretrainModel
from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
from unispeech_tpu_torch.ops.ctc import ctc_loss
from unispeech_tpu_torch.train.losses import (
    HubertCriterionConfig,
    hubert_loss,
    wav2vec2_contrastive_loss,
)


def make_hubert_loss_fn(model: HubertPretrainModel, crit: HubertCriterionConfig):
    """Masked-prediction pretraining objective (HuBERT / WavLM / ILS / SAT).

    batch: {"source": (B, n), "targets": (B, T, num_sets), optional
    "lengths": (B,), optional "boundary_mask": (B, T) precomputed mask that
    replaces the span sampler}. The step sets the SAT quantizer's
    temperature. ``metrics`` gains ``layers_dropped``, the layers layerdrop
    skipped (a host int)."""

    def loss_fn(batch, generator, step):
        out = model(batch["source"], batch["targets"], batch.get("lengths"), mask=True,
                    deterministic=False, generator=generator,
                    boundary_mask=batch.get("boundary_mask"), num_updates=step)
        loss, sample_size, metrics = hubert_loss(out, crit)
        metrics["layers_dropped"] = out.layers_dropped
        return loss, sample_size, metrics

    return loss_fn


def make_wav2vec2_loss_fn(model: Wav2Vec2PretrainModel, features_pen_weight: float = 0.0,
                          prob_ppl_weight: float = 0.1, mtlalpha: float = 0.0):
    """wav2vec 2.0 InfoNCE; with ``mtlalpha > 0`` the UniSpeech multitask
    mtlalpha * CTC + (1 - mtlalpha) * InfoNCE, the CTC term the summed
    phonetic CTC loss of ``ops/ctc.py`` (zero-infinity).

    batch: {"source", optional "lengths", optional "boundary_mask", for CTC
    "labels" (B, S) and "label_lengths" (B,)}. The step sets the
    quantizer's temperature. ``metrics`` gains ``layers_dropped``."""

    def loss_fn(batch, generator, step):
        out = model(batch["source"], batch.get("lengths"), mask=True, deterministic=False,
                    num_updates=step, generator=generator,
                    boundary_mask=batch.get("boundary_mask"))
        m = out.mask_indices.float()
        valid = torch.ones_like(m) if out.padding_mask is None else (~out.padding_mask).float()
        loss_c, sample_size, metrics = wav2vec2_contrastive_loss(
            out.contrastive_logits, m * valid, out.features_pen, out.vq_result,
            features_pen_weight=features_pen_weight, prob_ppl_weight=prob_ppl_weight)
        loss = loss_c
        if mtlalpha > 0.0:
            if out.ctc_logits is None:
                raise ValueError("mtlalpha > 0 needs the CTC head (ctc_vocab_size > 0)")
            loss_ctc, ntok = ctc_loss(out.ctc_logits, valid.sum(-1).int(), batch["labels"],
                                      batch["label_lengths"])
            metrics["loss_ctc"] = loss_ctc
            metrics["ctc_ntokens"] = ntok.float()
            loss = mtlalpha * loss_ctc + (1.0 - mtlalpha) * loss_c
        metrics["loss"] = loss
        metrics["layers_dropped"] = out.layers_dropped
        return loss, sample_size, metrics

    return loss_fn


def make_ctc_finetune_loss_fn(model: CtcFinetuneModel, deterministic: bool = False):
    """CTC fine-tuning objective, normalised by the label count.

    batch: {"source" (B, n), "lengths" (B,), "labels" (B, S) padded,
    "label_lengths" (B,)}. ``deterministic=True`` is the eval loss (no
    masks, no dropout). ``metrics`` gains ``layers_dropped`` (a host int)."""

    def loss_fn(batch, generator, step):
        out = model(batch["source"], batch.get("lengths"), deterministic=deterministic,
                    step=step, generator=generator)
        loss, ntokens = ctc_loss(out.logits, out.frame_lengths, batch["labels"],
                                 batch["label_lengths"])
        sample_size = ntokens.float()
        metrics = {"loss": loss, "ntokens": sample_size, "sample_size": sample_size,
                   "nsentences": torch.tensor(float(batch["source"].shape[0])),
                   "layers_dropped": out.layers_dropped}
        return loss, sample_size, metrics

    return loss_fn


def make_ctc_valid_decode_fn(model: CtcFinetuneModel, dictionary,
                             post_process_symbol: str = "letter", decoder: str = "greedy",
                             beam: int = 50, lexicon=None, lm_path=None,
                             lm_weight: float = 2.0, word_score: float = -1.0):
    """Valid-time CTC decode and WER/UER scoring, as fairseq's CTC criterion
    scores its dev set. ``decoder`` "greedy" is the argmax path; "beam" and
    "kenlm" run the offline ``CtcBeamDecoder`` (``lexicon``: {word: [[unit
    ids], ...]}; ``lm_path``: a KenLM .arpa/.bin).

    Returns ``(state, batch) -> {"wer_errs", "wer_len", "uer_errs",
    "uer_len"}`` of the model it binds, sums that ``run_validation`` turns
    into percentages."""
    from unispeech_tpu_torch.decode.beam import CtcBeamDecoder, KenLMWrapper
    from unispeech_tpu_torch.decode.wer import WerScorer, post_process

    blank = dictionary.blank()
    beam_decoder = None
    if decoder != "greedy":
        lm = None
        if decoder == "kenlm":
            if not lm_path:
                raise ValueError("valid decoder 'kenlm' needs an LM path")
            lm = KenLMWrapper(lm_path)
        sil = dictionary.index("|") if "|" in dictionary else None
        beam_decoder = CtcBeamDecoder(beam=beam, blank_id=blank, silence_id=sil,
                                      lexicon=lexicon, lm=lm, lm_weight=lm_weight,
                                      word_score=word_score)

    def decode_fn(state, batch):
        with torch.no_grad():
            out = model(batch["source"], batch.get("lengths"), deterministic=True)
            if beam_decoder is None:
                ids = out.logits.argmax(-1).cpu().numpy()
            else:
                lp = torch.log_softmax(out.logits, dim=-1).cpu().numpy()
        flens = out.frame_lengths.cpu().numpy()
        labels = batch["labels"].cpu().numpy()
        label_lengths = batch["label_lengths"].cpu().numpy()
        sc = WerScorer()
        for b in range(len(flens)):
            words = None
            if beam_decoder is None:
                # collapse repeats, drop blanks
                units, prev = [], -1
                for t in ids[b, :int(flens[b])].tolist():
                    if t != blank and t != prev:
                        units.append(t)
                    prev = t
            else:
                nbest = beam_decoder.decode(lp[b], int(flens[b]))
                units, words, _ = nbest[0] if nbest else ([], [], 0.0)
            hyp = (" ".join(words) if words
                   else post_process(dictionary.string(units), post_process_symbol))
            ref = post_process(dictionary.string(labels[b, :int(label_lengths[b])].tolist()),
                               post_process_symbol)
            sc.add(hyp, ref)
        return {"wer_errs": float(sc.w_errs), "wer_len": float(sc.w_len),
                "uer_errs": float(sc.c_errs), "uer_len": float(sc.c_len)}

    return decode_fn
