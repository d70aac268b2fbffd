"""Training CLI: ``python -m unispeech_tpu_torch.train <subcommand>``.

  pretrain-hubert   HuBERT / WavLM masked prediction from a manifest and
                    frame-label files (.km): the data pipeline, the update
                    loop, checkpoints and resume, an optional params .npz
                    export in the JAX package's layout
  finetune-ctc      CTC fine-tuning on letter transcripts, from a
                    pretrained params .npz (``--w2v-path``), with valid-time
                    WER and checkpoint selection by ``--best-metric``

The arguments are the JAX CLI's, plus ``--device`` (default cuda; the CPU
only when ``--device cpu`` is given). Not ported yet, raising
``NotImplementedError``: the UniSpeech-SAT branch (``--sat``), tensor
parallelism and FSDP (``--n-model > 1``, ``--fsdp``), the multi-host flags,
and the subcommands pretrain-wav2vec2, finetune-seq2seq and train-lm (they
take any flags).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

NOT_PORTED = ("pretrain-wav2vec2", "finetune-seq2seq", "train-lm")
NO_EFFECT = " (an XLA compile choice of the JAX package: accepted, no effect here)"


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--manifest", required=True, help="train TSV manifest")
    p.add_argument("--valid-manifest", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--max-updates", type=int, default=400_000)
    p.add_argument("--max-tokens", type=int, default=1_400_000)
    p.add_argument("--max-sample-size", type=int, default=250_000)
    p.add_argument("--min-sample-size", type=int, default=32_000)
    p.add_argument("--num-buckets", type=int, default=8, help="distinct batch shapes")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup-steps", type=int, default=32_000)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--stacked-optimizer", action="store_true",
                   help="group same-shape leaves for the adam update" + NO_EFFECT)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--save-interval-updates", type=int, default=25_000)
    p.add_argument("--arch", choices=["base", "large"], default="base")
    p.add_argument("--encoder-json", default=None,
                   help="JSON dict of EncoderConfig overrides")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel mesh axis (only 1 is ported)")
    p.add_argument("--fsdp", action="store_true", help="ZeRO-3 param sharding (not ported)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--tensorboard-dir", default=None)
    p.add_argument("--wandb-project", default=None,
                   help="mirror progress to Weights & Biases (needs wandb)")
    p.add_argument("--azureml", action="store_true",
                   help="mirror progress to the Azure ML run context")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation (microbatches per update)")
    p.add_argument("--inner-steps", type=int, default=1,
                   help="optimizer steps per dispatch, each on its own batch")
    p.add_argument("--unroll-layers", action="store_true",
                   help="unroll the transformer layers instead of nn.scan" + NO_EFFECT)
    p.add_argument("--export-params", default=None,
                   help="write the final params as a flat .npz in the JAX package's layout")
    p.add_argument("--hang-timeout", type=float, default=0.0,
                   help="dump stacks if a step exceeds this many seconds (0 disables)")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 for multi-host runs (not ported)")
    p.add_argument("--num-processes", type=int, default=None, help="not ported")
    p.add_argument("--process-id", type=int, default=None, help="not ported")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _encoder(args, **over):
    from unispeech_tpu_torch.configs import base_encoder_config, large_encoder_config

    fn = base_encoder_config if args.arch == "base" else large_encoder_config
    enc = fn(**over)
    if args.unroll_layers:
        enc = dataclasses.replace(enc, scan_layers=False)
    if args.encoder_json:
        extra = json.loads(args.encoder_json)
        if "conv_layers" in extra:
            extra["conv_layers"] = tuple(tuple(c) for c in extra["conv_layers"])
        enc = dataclasses.replace(enc, **extra)
    return enc


def _loop_cfg(args):
    from unispeech_tpu_torch.train.loop import LoopConfig

    return LoopConfig(
        max_updates=args.max_updates,
        log_interval=args.log_interval,
        save_interval_updates=args.save_interval_updates,
        validate_interval_updates=(getattr(args, "validate_interval_updates", None)
                                   or args.save_interval_updates),
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        n_model=args.n_model,
        fsdp=args.fsdp,
        tensorboard_dir=args.tensorboard_dir,
        wandb_project=args.wandb_project,
        azureml=args.azureml,
        accum_steps=args.accum_steps,
        inner_steps=args.inner_steps,
        export_params=args.export_params,
        best_metric=getattr(args, "best_metric", None) or "loss_avg",
        hang_timeout_s=args.hang_timeout,
    )


def _data_cfg(args, **over):
    from unispeech_tpu_torch.data.dataset import DataConfig

    return DataConfig(max_sample_size=args.max_sample_size,
                      min_sample_size=args.min_sample_size, max_tokens=args.max_tokens,
                      num_buckets=args.num_buckets, **over)


def cmd_pretrain_hubert(args) -> None:
    from unispeech_tpu_torch.configs import HubertPretrainConfig, MaskConfig
    from unispeech_tpu_torch.data.dataset import PretrainIterator
    from unispeech_tpu_torch.data.labels import LabelFile
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.data.mixing import MixingConfig, NoiseStore
    from unispeech_tpu_torch.models.hubert import HubertPretrainModel
    from unispeech_tpu_torch.train.loop import run_training
    from unispeech_tpu_torch.train.losses import HubertCriterionConfig
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.tasks import make_hubert_loss_fn

    if args.sat:
        raise NotImplementedError("--sat: the UniSpeech-SAT speaker branch is not ported to "
                                  "PyTorch yet")
    loop_cfg = _loop_cfg(args)  # raises for the mesh options not ported
    enc = _encoder(args, relative_position_embedding=not args.no_rel_pos,
                   gru_rel_pos=not args.no_rel_pos, encoder_layerdrop=0.05)
    labels = [LabelFile(p, args.label_rate) for p in args.labels]
    cfg = HubertPretrainConfig(
        encoder=enc,
        time_mask=MaskConfig(mask_prob=args.mask_prob, mask_length=10),
        label_rate=args.label_rate,
        num_classes=tuple(int(n) for n in args.num_classes),
        final_dim=256 if args.arch == "base" else 768,
        predict_layers=tuple(args.predict_layers or ()),
    )
    model = HubertPretrainModel(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                                generator=torch.Generator().manual_seed(args.seed))
    mixing = (MixingConfig(mixing_prob=args.mixing_prob, mixing_num=args.mixing_num,
                           mixing_noise_prob=args.noise_prob)
              if args.mixing_prob > 0 else None)
    data = PretrainIterator(
        Manifest.load(args.manifest),
        _data_cfg(args, label_rate=args.label_rate),
        label_files=labels,
        frame_hop=enc.frame_hop,
        frames_fn=enc.num_frames,
        mixing=mixing,
        noise=NoiseStore(args.noise_path) if args.noise_path else None,
        seed=args.seed,
    )
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm,
                        stacked_update=args.stacked_optimizer)
    run_training(model, make_hubert_loss_fn(model, HubertCriterionConfig()), optim,
                 iter(data), loop_cfg, device=args.device, data_state=data)


def cmd_finetune_ctc(args) -> None:
    from unispeech_tpu_torch.configs import MaskConfig
    from unispeech_tpu_torch.data.dataset import FinetuneIterator
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.models.ctc import (
        CtcFinetuneConfig,
        CtcFinetuneModel,
        load_pretrained_into,
    )
    from unispeech_tpu_torch.train.loop import run_training
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.tasks import (
        make_ctc_finetune_loss_fn,
        make_ctc_valid_decode_fn,
    )

    loop_cfg = _loop_cfg(args)  # raises for the mesh options not ported
    d = Dictionary.load(args.dict) if args.dict else Dictionary.letters()
    enc = _encoder(args, relative_position_embedding=not args.no_rel_pos,
                   gru_rel_pos=not args.no_rel_pos)
    cfg = CtcFinetuneConfig(
        encoder=enc, vocab_size=len(d), apply_mask=True,
        time_mask=MaskConfig(mask_prob=args.mask_prob, mask_length=10),
        freeze_finetune_updates=args.freeze_finetune_updates, final_dropout=0.1)
    model = CtcFinetuneModel(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             generator=torch.Generator().manual_seed(args.seed))
    if args.w2v_path:
        # a checkpoint in --checkpoint-dir, if any, replaces these weights
        load_pretrained_into(model, args.w2v_path)
    texts = pathlib.Path(args.transcripts).read_text().splitlines()
    data = FinetuneIterator(Manifest.load(args.manifest), _data_cfg(args), texts, d,
                            seed=args.seed)

    valid_kw = {}
    if args.valid_manifest and args.valid_transcripts:
        vman = Manifest.load(args.valid_manifest)
        vtexts = pathlib.Path(args.valid_transcripts).read_text().splitlines()

        def valid_batches_fn():
            return FinetuneIterator(vman, _data_cfg(args), vtexts, d,
                                    seed=args.seed).epoch_batches(1)

        lexicon = None
        if args.valid_lexicon:
            from unispeech_tpu_torch.decode.__main__ import load_lexicon

            lexicon = {w: [[d.index(u) for u in sp] for sp in sps]
                       for w, sps in load_lexicon(args.valid_lexicon).items()}
        valid_kw = dict(
            valid_batches_fn=valid_batches_fn,
            eval_loss_fn=make_ctc_finetune_loss_fn(model, deterministic=True),
            valid_decode_fn=make_ctc_valid_decode_fn(
                model, d, post_process_symbol=args.post_process,
                decoder=args.valid_decoder, beam=args.valid_beam, lexicon=lexicon,
                lm_path=args.valid_lm_model, lm_weight=args.valid_lm_weight,
                word_score=args.valid_word_score))
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm,
                        stacked_update=args.stacked_optimizer, schedule="tri_stage",
                        hold_steps=args.max_updates * 4 // 10)
    run_training(model, make_ctc_finetune_loss_fn(model), optim, iter(data), loop_cfg,
                 device=args.device, data_state=data, **valid_kw)


def _not_ported(args) -> None:
    raise NotImplementedError(f"{args.cmd} is not ported to PyTorch yet")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("unispeech_tpu_torch.train")
    sub = parser.add_subparsers(dest="cmd", required=True)

    ph = sub.add_parser("pretrain-hubert")
    _common(ph)
    ph.add_argument("--labels", nargs="+", required=True, help=".km label files")
    ph.add_argument("--label-rate", type=float, default=50.0)
    ph.add_argument("--num-classes", nargs="+", default=["504"])
    ph.add_argument("--mask-prob", type=float, default=0.8)
    ph.add_argument("--predict-layers", type=int, nargs="*", default=None,
                    help="ILS: 1-based layers with prediction losses")
    ph.add_argument("--sat", action="store_true",
                    help="UniSpeech-SAT speaker contrastive branch (not ported)")
    ph.add_argument("--mixing-prob", type=float, default=0.0)
    ph.add_argument("--mixing-num", type=int, default=1)
    ph.add_argument("--noise-path", default=None,
                    help="noise store: a JSON list of h5py slices or a TSV audio manifest")
    ph.add_argument("--noise-prob", type=float, default=0.0,
                    help="probability a mix overlays noise instead of speech")
    ph.add_argument("--no-rel-pos", action="store_true")
    ph.set_defaults(fn=cmd_pretrain_hubert)

    fc = sub.add_parser("finetune-ctc")
    _common(fc)
    fc.add_argument("--transcripts", required=True,
                    help="one letter-format line per manifest row")
    fc.add_argument("--dict", default=None, help="target dictionary (letters by default)")
    fc.add_argument("--w2v-path", default=None, help="pretrained params .npz")
    fc.add_argument("--mask-prob", type=float, default=0.65)
    fc.add_argument("--freeze-finetune-updates", type=int, default=10_000)
    fc.add_argument("--no-rel-pos", action="store_true")
    fc.add_argument("--valid-transcripts", default=None,
                    help="dev transcripts; with --valid-manifest, WER/UER at each validation")
    fc.add_argument("--best-metric", default="loss_avg", choices=["loss_avg", "wer", "uer"],
                    help="the metric that picks the best checkpoint")
    fc.add_argument("--valid-decoder", default="greedy", choices=["greedy", "beam", "kenlm"],
                    help="the dev decode of the valid-time WER")
    fc.add_argument("--valid-beam", type=int, default=50)
    fc.add_argument("--valid-lexicon", default=None,
                    help="word -> units lexicon for the valid beam decode")
    fc.add_argument("--valid-lm-model", default=None,
                    help="KenLM .arpa/.bin for --valid-decoder kenlm")
    fc.add_argument("--valid-lm-weight", type=float, default=2.0)
    fc.add_argument("--valid-word-score", type=float, default=-1.0)
    fc.add_argument("--post-process", default="letter", help="hyp/ref detokenization rule")
    fc.add_argument("--validate-interval-updates", type=int, default=None)
    fc.set_defaults(fn=cmd_finetune_ctc)

    for name in NOT_PORTED:
        sub.add_parser(name).set_defaults(fn=_not_ported)

    # the subcommands not ported yet take any flags and raise
    args, rest = parser.parse_known_args(argv)
    if rest and args.fn is not _not_ported:
        parser.error("unrecognized arguments: " + " ".join(rest))
    if args.fn is not _not_ported and any(
            v is not None for v in (args.coordinator_address, args.num_processes,
                                    args.process_id)):
        raise NotImplementedError("multi-host training is not ported to PyTorch yet")
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
