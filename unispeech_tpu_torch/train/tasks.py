"""Task glue: a loss function binding model and criterion.

Counterpart of the JAX package's ``train/tasks.py`` (``make_hubert_loss_fn``,
``make_wav2vec2_loss_fn``, ``make_ctc_finetune_loss_fn``,
``make_ctc_valid_decode_fn``, ``make_seq2seq_loss_fn``,
``make_seq2seq_valid_decode_fn``, ``make_lm_loss_fn``):
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


def make_seq2seq_loss_fn(model, label_smoothing: float = 0.1, deterministic: bool = False):
    """Seq2seq fine-tuning objective: label-smoothed cross-entropy summed
    over the valid targets, normalised by their count.

    batch: {"source" (B, n), "lengths" (B,), "prev_tokens" (B, S),
    "targets" (B, S), "target_mask" (B, S), optional "boundary_mask" (B, T)
    precomputed time mask}. ``metrics`` gains ``layers_dropped``."""
    from unispeech_tpu_torch.models.seq2seq import cross_entropy_loss

    def loss_fn(batch, generator, step):
        out = model(batch["source"], batch["prev_tokens"], batch.get("lengths"),
                    deterministic=deterministic, step=step, generator=generator,
                    boundary_mask=batch.get("boundary_mask"))
        loss, ntokens, metrics = cross_entropy_loss(out.logits, batch["targets"],
                                                    batch["target_mask"], label_smoothing)
        metrics["nsentences"] = torch.tensor(float(batch["source"].shape[0]))
        metrics["layers_dropped"] = out.layers_dropped
        return loss, ntokens, metrics

    return loss_fn


def make_seq2seq_valid_decode_fn(model, dictionary, max_len: int = 128,
                                 post_process_symbol: str = "letter"):
    """Valid-time greedy decode and WER/UER sums of seq2seq fine-tuning.
    Zero-length padding rows are no utterances and are not scored (the JAX
    package scores their decode against an empty reference, ROADMAP
    3.15)."""
    from unispeech_tpu_torch.decode.wer import WerScorer, post_process
    from unispeech_tpu_torch.models.seq2seq import greedy_decode, strip_eos

    eos = dictionary.eos()  # fairseq conditions on </s> as bos too

    def decode_fn(state, batch):
        lengths = batch.get("lengths")
        ids = greedy_decode(model, batch["source"], lengths, eos, eos,
                            max_len=max_len).cpu().numpy()
        tgts = batch["targets"].cpu().numpy()
        tmask = batch["target_mask"].cpu().numpy()
        rows = range(len(ids)) if lengths is None else \
            (lengths.cpu().numpy() > 0).nonzero()[0]
        sc = WerScorer()
        for b in rows:
            hyp = post_process(dictionary.string(strip_eos(ids[b].tolist(), eos)),
                               post_process_symbol)
            L = int(tmask[b].sum()) - 1  # the eos terminator
            ref = post_process(dictionary.string(tgts[b, :max(L, 0)].tolist()),
                               post_process_symbol)
            sc.add(hyp, ref)
        return {"wer_errs": float(sc.w_errs), "wer_len": float(sc.w_len),
                "uer_errs": float(sc.c_errs), "uer_len": float(sc.c_len)}

    return decode_fn


def make_lm_loss_fn(model, padding_idx: int):
    """Next-token cross-entropy of a TransformerLM, dropout on, summed over
    the non-pad targets. batch: {"tokens" (B, S), "targets" (B, S)}."""
    from unispeech_tpu_torch.models.lm import lm_loss

    def loss_fn(batch, generator, step):
        logits = model(batch["tokens"], deterministic=False, generator=generator)
        loss, n_tokens = lm_loss(logits, batch["targets"], padding_idx)
        return loss, n_tokens, {"loss": loss, "sample_size": n_tokens, "ntokens": n_tokens}

    return loss_fn
