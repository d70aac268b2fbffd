"""CLI: ``python -m unispeech_tpu_torch.decode ...``, offline inference and
WER.

Counterpart of the JAX package's decode CLI, with its flags plus
``--device`` (default cuda; the CPU only when ``--device cpu`` is given):
load a fine-tuned CTC model from a params ``.npz`` in the JAX package's
layout (``finetune-ctc --export-params``), batch a manifest by length over
the same bucket grid as the JAX CLI (so batches and output order match),
compute log-probs on the device, decode on the host (best path, or the
lexicon/KenLM prefix beam), write hypo/ref files and report WER/UER.
Several ``--checkpoint`` files decode as an ensemble: the log-probs are
averaged in probability space (logsumexp over models, less log N).
``--decoder neural`` fuses a TransformerLM (``train train-lm
--export-params``, with ``--lm-dict``) into the lexicon beam search.
``--decoder seq2seq`` beam-decodes a ``finetune-seq2seq`` export
(``--seq2seq-beam``, ``--len-penalty``, ``--no-repeat-ngram``,
``--max-decode-len``) over the same bucket grid, and writes hypo.word and
the WER report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _parse_args(argv=None):
    p = argparse.ArgumentParser("unispeech_tpu_torch.decode")
    p.add_argument("--manifest", required=True, help="eval TSV manifest")
    p.add_argument("--checkpoint", required=True, nargs="+",
                   help="fine-tuned params .npz; several decode as an ensemble")
    p.add_argument("--transcripts", default=None,
                   help="reference transcripts, one letter-format line per manifest row; "
                        "omit for hypotheses only")
    p.add_argument("--dict", default=None, help="target dictionary (letters by default)")
    p.add_argument("--arch", choices=["base", "large"], default="base")
    p.add_argument("--no-rel-pos", action="store_true")
    p.add_argument("--unroll-layers", action="store_true",
                   help="checkpoints with per-layer params (both layouts load here)")
    p.add_argument("--encoder-json", default=None,
                   help="JSON dict of EncoderConfig field overrides")
    p.add_argument("--decoder", choices=["viterbi", "beam", "kenlm", "neural", "seq2seq"],
                   default="viterbi")
    p.add_argument("--decoder-json", default=None,
                   help="(--decoder seq2seq) JSON dict of Seq2SeqDecoderConfig overrides")
    p.add_argument("--seq2seq-beam", type=int, default=5)
    p.add_argument("--max-decode-len", type=int, default=200)
    p.add_argument("--len-penalty", type=float, default=1.0)
    p.add_argument("--no-repeat-ngram", type=int, default=0)
    p.add_argument("--beam", type=int, default=50)
    p.add_argument("--beam-threshold", type=float, default=25.0)
    p.add_argument("--lexicon", default=None,
                   help="word -> space-separated units, one per line")
    p.add_argument("--lm-model", default=None,
                   help="KenLM .arpa/.bin path, or (--decoder neural) a TransformerLM "
                        "params .npz with its .json config")
    p.add_argument("--lm-dict", default=None, help="word dictionary of the neural LM")
    p.add_argument("--lm-weight", type=float, default=2.0)
    p.add_argument("--word-score", type=float, default=-1.0)
    p.add_argument("--post-process", default="letter", help="symbol collapse rule")
    p.add_argument("--max-tokens", type=int, default=1_280_000)
    p.add_argument("--batch-size", type=int, default=0,
                   help="cap sentences per batch (0 = token budget only)")
    p.add_argument("--results-path", default=None,
                   help="directory for hypo.units/hypo.word/ref files and wer_report.json")
    p.add_argument("--normalize", action="store_true",
                   help="per-utterance input normalization on the host")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_lexicon(path: str) -> Dict[str, List[List[str]]]:
    """``word units...`` lines (tab or space separated); a word may have
    several spellings."""
    lex: Dict[str, List[List[str]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").replace("\t", " ").split()
            if parts:
                lex.setdefault(parts[0], []).append(parts[1:])
    return lex


def build_decoder(args, dictionary, device="cpu"):
    """None for best path, else the prefix beam decoder the flags ask for;
    a neural LM runs on ``device``."""
    from unispeech_tpu_torch.decode.beam import CtcBeamDecoder, KenLMWrapper

    if args.decoder == "viterbi":
        return None
    lexicon = None
    if args.lexicon:
        lexicon = {w: [[dictionary.index(u) for u in sp] for sp in sps]
                   for w, sps in load_lexicon(args.lexicon).items()}
    lm = None
    if args.decoder == "kenlm":
        if not args.lm_model:
            sys.exit("--decoder kenlm requires --lm-model")
        lm = KenLMWrapper(args.lm_model)
    elif args.decoder == "neural":
        if not (args.lm_model and args.lm_dict):
            sys.exit("--decoder neural requires --lm-model and --lm-dict")
        from unispeech_tpu_torch.decode.lm_fusion import load_neural_lm

        lm = load_neural_lm(args.lm_model, args.lm_dict, device=device)
    sil = dictionary.index("|") if "|" in dictionary else None
    return CtcBeamDecoder(beam=args.beam, blank_id=dictionary.blank(), silence_id=sil,
                          lexicon=lexicon, lm=lm, lm_weight=args.lm_weight,
                          word_score=args.word_score, beam_threshold=args.beam_threshold)


def bucket_grid(sizes: np.ndarray) -> np.ndarray:
    """Batch lengths from the shortest utterance up, each 1.3x the last,
    rounded up to a multiple of 320 samples (the JAX CLI's grid)."""
    lo, hi = int(sizes.min()), int(sizes.max())
    buckets = [lo]
    while buckets[-1] < hi:
        buckets.append(int(np.ceil(buckets[-1] * 1.3 / 320) * 320))
    return np.asarray(buckets)


def plan_eval_batches(sizes: np.ndarray, max_tokens: int, max_sentences: int,
                      buckets: np.ndarray) -> List[np.ndarray]:
    """Length-sorted batches under a token budget over bucketed lengths, so
    every batch has one of a few shapes."""
    order = np.argsort(sizes, kind="stable")
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_bucket = 0
    for i in order:
        b = int(buckets[np.searchsorted(buckets, sizes[i])])
        if cur and ((len(cur) + 1) * b > max_tokens
                    or (max_sentences and len(cur) >= max_sentences) or b != cur_bucket):
            batches.append(cur)
            cur = []
        cur_bucket = b
        cur.append(int(i))
    if cur:
        batches.append(cur)
    return [np.asarray(b) for b in batches]


def encoder_config(args):
    """The encoder of ``--arch``, ``--no-rel-pos`` and ``--encoder-json``,
    without dropout."""
    from unispeech_tpu_torch.configs import base_encoder_config, large_encoder_config

    enc_fn = base_encoder_config if args.arch == "base" else large_encoder_config
    enc = enc_fn(relative_position_embedding=not args.no_rel_pos,
                 gru_rel_pos=not args.no_rel_pos, dropout=0.0, attention_dropout=0.0,
                 activation_dropout=0.0, encoder_layerdrop=0.0)
    if args.encoder_json:
        over = json.loads(args.encoder_json)
        if "conv_layers" in over:
            over["conv_layers"] = tuple(tuple(c) for c in over["conv_layers"])
        enc = dataclasses.replace(enc, **over)
    return enc


def load_models(args, vocab_size: int, device) -> list:
    """One bf16 CtcFinetuneModel per ``--checkpoint``, in eval form."""
    from unispeech_tpu_torch.convert.from_jax import ctc_state_dict_from_jax, load_params_npz
    from unispeech_tpu_torch.models.ctc import CtcFinetuneConfig, CtcFinetuneModel

    enc = encoder_config(args)
    cfg = CtcFinetuneConfig(encoder=enc, vocab_size=vocab_size, apply_mask=False)
    models = []
    for path in args.checkpoint:
        model = CtcFinetuneModel(cfg, dtype=torch.bfloat16)
        model.load_state_dict(ctc_state_dict_from_jax(load_params_npz(path), enc),
                              strict=True)
        models.append(model.to(device).eval())
    return models


@torch.no_grad()
def emissions(models, source: torch.Tensor, lengths: torch.Tensor):
    """(log-probs (B, T, V) fp32, frame lengths (B,)) of one model or of the
    ensemble's average in probability space."""
    lps = []
    for model in models:
        out = model(source, lengths, deterministic=True)
        lps.append(torch.log_softmax(out.logits, dim=-1))
    if len(lps) == 1:
        return lps[0], out.frame_lengths
    return torch.logsumexp(torch.stack(lps), dim=0) - math.log(len(lps)), out.frame_lengths


def _batch_source(man, batch_idx, buckets, normalize: bool):
    """(source (B, Tb) f32, lengths (B,) i32) of a batch's files, zero-padded
    to its bucket length."""
    from unispeech_tpu_torch.data.manifest import load_audio

    wavs = []
    for i in batch_idx:
        wav = load_audio(man.abspath(int(i)), 16_000)
        if normalize:
            wav = (wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)
        wavs.append(wav)
    lengths = np.asarray([len(w) for w in wavs], dtype=np.int32)
    source = np.zeros((len(wavs), int(buckets[np.searchsorted(buckets, lengths.max())])),
                      dtype=np.float32)
    for r, w in enumerate(wavs):
        source[r, :len(w)] = w
    return source, lengths


def _write_report(args, report: dict) -> None:
    print(json.dumps(report))
    if args.results_path:
        with open(os.path.join(args.results_path, "wer_report.json"), "w") as f:
            json.dump(report, f, indent=1)


def run_seq2seq(args, device) -> None:
    """Offline seq2seq evaluation: batched beam search of one
    ``finetune-seq2seq`` export (bf16), hypo.word and the WER report."""
    from unispeech_tpu_torch.convert.from_jax import load_params_npz, seq2seq_state_dict_from_jax
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.decode.wer import WerScorer, post_process
    from unispeech_tpu_torch.models.seq2seq import (
        Seq2SeqConfig,
        Seq2SeqDecoderConfig,
        Seq2SeqModel,
        beam_decode,
        strip_eos,
    )

    if len(args.checkpoint) > 1:
        sys.exit("--decoder seq2seq supports a single checkpoint")
    d = Dictionary.load(args.dict) if args.dict else Dictionary.letters()
    enc = encoder_config(args)
    dec = Seq2SeqDecoderConfig(vocab_size=len(d), padding_idx=d.pad())
    if args.decoder_json:
        dec = dataclasses.replace(dec, **json.loads(args.decoder_json))
    model = Seq2SeqModel(Seq2SeqConfig(encoder=enc, decoder=dec, apply_mask=False),
                         dtype=torch.bfloat16)
    model.load_state_dict(seq2seq_state_dict_from_jax(load_params_npz(args.checkpoint[0]), enc),
                          strict=True)
    model = model.to(device).eval()
    eos = d.eos()

    man = Manifest.load(args.manifest)
    sizes = np.asarray(man.sizes)
    buckets = bucket_grid(sizes)
    batches = plan_eval_batches(sizes, args.max_tokens, args.batch_size, buckets)
    refs: Optional[List[str]] = None
    if args.transcripts:
        refs = pathlib.Path(args.transcripts).read_text().splitlines()
        if len(refs) != len(man):
            raise ValueError("one transcript line per manifest row")
    scorer = WerScorer()
    hypo_f = None
    if args.results_path:
        os.makedirs(args.results_path, exist_ok=True)
        hypo_f = open(os.path.join(args.results_path, "hypo.word"), "w")
    t0 = time.perf_counter()
    total_audio = 0.0
    n_done = 0
    try:
        for batch_idx in batches:
            source, lengths = _batch_source(man, batch_idx, buckets, args.normalize)
            total_audio += float(lengths.sum()) / 16_000.0
            toks, _ = beam_decode(model, torch.from_numpy(source).to(device),
                                  torch.from_numpy(lengths).to(device), eos, eos,
                                  beam_size=args.seq2seq_beam, max_len=args.max_decode_len,
                                  len_penalty=args.len_penalty,
                                  no_repeat_ngram=args.no_repeat_ngram)
            toks = toks[:, 0].cpu().numpy()  # the best beam
            for r, i in enumerate(batch_idx):
                hyp = post_process(d.string(strip_eos(toks[r].tolist(), eos)),
                                   args.post_process)
                if hypo_f:
                    hypo_f.write(f"{hyp} ({i})\n")
                if refs is not None:
                    scorer.add(hyp, post_process(refs[int(i)], args.post_process))
                n_done += 1
    finally:
        if hypo_f:
            hypo_f.close()
    dt = time.perf_counter() - t0
    report = {"utterances": n_done, "audio_sec": round(total_audio, 1),
              "rtf_inv": round(total_audio / dt, 1)}
    if refs is not None:
        report["wer"] = round(scorer.wer, 4)
        report["uer"] = round(scorer.uer, 4)
    _write_report(args, report)


def main(argv=None) -> None:
    args = _parse_args(argv)

    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.decode.beam import best_path_decode
    from unispeech_tpu_torch.decode.wer import WerScorer, post_process
    from unispeech_tpu_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    if args.decoder == "seq2seq":
        run_seq2seq(args, device)
        return
    d = Dictionary.load(args.dict) if args.dict else Dictionary.letters()
    decoder = build_decoder(args, d, device)
    models = load_models(args, len(d), device)

    man = Manifest.load(args.manifest)
    sizes = np.asarray(man.sizes)
    buckets = bucket_grid(sizes)
    batches = plan_eval_batches(sizes, args.max_tokens, args.batch_size, buckets)
    refs: Optional[List[str]] = None
    if args.transcripts:
        refs = pathlib.Path(args.transcripts).read_text().splitlines()
        if len(refs) != len(man):
            raise ValueError("one transcript line per manifest row")

    scorer, unit_scorer = WerScorer(), WerScorer()
    files = {}
    if args.results_path:
        os.makedirs(args.results_path, exist_ok=True)
        names = ("hypo.units", "hypo.word") + (("ref.units", "ref.word") if refs else ())
        files = {n: open(os.path.join(args.results_path, n), "w") for n in names}

    t0 = time.perf_counter()
    total_audio = 0.0
    n_done = 0
    try:
        for batch_idx in batches:
            source, lengths = _batch_source(man, batch_idx, buckets, args.normalize)
            total_audio += float(lengths.sum()) / 16_000.0
            lp, flen = emissions(models, torch.from_numpy(source).to(device),
                                 torch.from_numpy(lengths).to(device))
            lp = lp.float().cpu().numpy()
            flen = flen.cpu().numpy()
            for r, i in enumerate(batch_idx):
                words = None
                if decoder is None:
                    units = best_path_decode(lp[r], int(flen[r]), blank_id=d.blank())
                else:
                    nbest = decoder.decode(lp[r], int(flen[r]))
                    units, words, _ = nbest[0] if nbest else ([], [], 0.0)
                unit_str = d.string(units)
                # a decode without a lexicon takes its words from the units
                word_str = " ".join(words) if words else post_process(unit_str,
                                                                      args.post_process)
                if files:
                    files["hypo.units"].write(f"{unit_str} ({i})\n")
                    files["hypo.word"].write(f"{word_str} ({i})\n")
                if refs is not None:
                    ref_unit_str = refs[int(i)]
                    ref_word_str = post_process(ref_unit_str, args.post_process)
                    scorer.add(word_str, ref_word_str)
                    unit_scorer.add(" ".join(unit_str.split()), " ".join(ref_unit_str.split()))
                    if files:
                        files["ref.units"].write(f"{ref_unit_str} ({i})\n")
                        files["ref.word"].write(f"{ref_word_str} ({i})\n")
                n_done += 1
    finally:
        for f in files.values():
            f.close()

    dt = time.perf_counter() - t0
    report = {"utterances": n_done, "audio_sec": round(total_audio, 1),
              "rtf_inv": round(total_audio / dt, 1)}  # audio-seconds decoded per second
    if refs is not None:
        report["wer"] = round(scorer.wer, 4)
        report["uer"] = round(unit_scorer.wer, 4)
    _write_report(args, report)


if __name__ == "__main__":
    main()
