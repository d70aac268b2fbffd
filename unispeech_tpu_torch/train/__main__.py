"""Training CLI: ``python -m unispeech_tpu_torch.train <subcommand>``.

  pretrain-hubert   HuBERT / WavLM / UniSpeech-SAT (``--sat``) masked
                    prediction from a manifest and frame-label files (.km):
                    the data pipeline, the update loop, checkpoints and
                    resume, an optional params .npz export in the JAX
                    package's layout
  pretrain-wav2vec2 wav2vec 2.0 contrastive pretraining, with UniSpeech's
                    phonetic CTC multitask (``--mtlalpha > 0``, ``--dict``,
                    ``--transcripts``); comma-separated per-language
                    manifests are resampled by ``--multilang-alpha``
  finetune-ctc      CTC fine-tuning on letter transcripts, from a
                    pretrained params .npz (``--w2v-path``), with valid-time
                    WER and checkpoint selection by ``--best-metric``
  finetune-seq2seq  seq2seq fine-tuning (the backbone and a Transformer
                    decoder, label-smoothed cross-entropy), from a
                    pretrained params .npz, with valid-time greedy WER
  train-lm          a Transformer LM on a text corpus or a binarized one
                    (``data binarize-text``), for ``decode --decoder
                    neural``; writes ``lm_config.json`` in the checkpoint
                    directory and ``<stem>.json`` beside ``--export-params``

The arguments are the JAX CLI's, plus ``--device`` (default cuda; the CPU
only when ``--device cpu`` is given). train-lm runs in bf16 whatever the
flags (``--bf16`` is a store_true defaulting to true, as in the JAX CLI).

Across processes: one process per card, launched by ``torchrun`` (or
SLURM's ``srun``, with ``MASTER_ADDR``/``MASTER_PORT``), or by hand with
``--coordinator-address host:port --num-processes N --process-id i`` in
each; the process group is joined before anything else
(``parallel/bootstrap.py``). ``--n-model`` ranks split each encoder layer
(tensor parallelism), the world size // n_model data ranks split the batch,
``--fsdp`` shards the parameters over them. Every iterator's shard is the
data rank, so the model ranks of one data rank read the same batches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

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
                   help="tensor-parallel mesh axis: ranks that split each encoder layer")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3 param sharding over the data ranks")
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
    _launch(p)


def _launch(p: argparse.ArgumentParser) -> None:
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 for a run of several processes")
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the run (one per card)")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _shard(args) -> dict:
    """The iterator shard of this process: its data rank among n_data."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return dict(num_shards=1, shard_id=0)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % args.n_model:
        raise ValueError(f"--n-model {args.n_model} does not divide {world} processes")
    return dict(num_shards=world // args.n_model, shard_id=rank // args.n_model)


def _encoder(args, **over):
    from unispeech_tpu_torch.configs import (
        base_encoder_config,
        large_encoder_config,
        override_encoder,
    )

    fn = base_encoder_config if args.arch == "base" else large_encoder_config
    enc = fn(**over)
    if args.unroll_layers:
        enc = dataclasses.replace(enc, scan_layers=False)
    return override_encoder(enc, args.encoder_json)


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
        wandb_project=getattr(args, "wandb_project", None),
        azureml=getattr(args, "azureml", False),
        accum_steps=args.accum_steps,
        inner_steps=getattr(args, "inner_steps", 1),
        export_params=args.export_params,
        best_metric=getattr(args, "best_metric", None) or "loss_avg",
        hang_timeout_s=getattr(args, "hang_timeout", 0.0),
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

    loop_cfg = _loop_cfg(args)
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
        utterance_contrastive_loss=args.sat,
        num_instances=1 if args.sat else 0,
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
        **_shard(args),
    )
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm,
                        stacked_update=args.stacked_optimizer)
    crit = HubertCriterionConfig(spk_loss_weight=0.1 if args.sat else 0.0)
    run_training(model, make_hubert_loss_fn(model, crit), optim, iter(data), loop_cfg,
                 device=args.device, data_state=data)


def cmd_pretrain_wav2vec2(args) -> None:
    from unispeech_tpu_torch.configs import MaskConfig, Wav2Vec2PretrainConfig
    from unispeech_tpu_torch.data.dataset import FinetuneIterator, PretrainIterator
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.data.multilingual import concat_manifests
    from unispeech_tpu_torch.models.wav2vec2 import Wav2Vec2PretrainModel
    from unispeech_tpu_torch.train.loop import run_training
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.tasks import make_wav2vec2_loss_fn

    loop_cfg = _loop_cfg(args)
    enc = _encoder(args)
    unispeech = args.mtlalpha > 0
    if unispeech and not (args.dict and args.transcripts):
        raise ValueError("--mtlalpha > 0 (the UniSpeech CTC head) needs --dict and "
                         "--transcripts")
    d = Dictionary.load(args.dict) if unispeech else None
    # final_dim and vq_dim keep the config's 256 at --arch large, as the JAX
    # CLI builds it (the reference's wav2vec 2.0 Large uses 768)
    cfg = Wav2Vec2PretrainConfig(
        encoder=enc, time_mask=MaskConfig(mask_prob=args.mask_prob, mask_length=10),
        transpose=unispeech, ctc_vocab_size=len(d) if d else 0,
        replace_prob=args.replace_prob)
    model = Wav2Vec2PretrainModel(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                                  generator=torch.Generator().manual_seed(args.seed))
    # comma-separated per-language manifests: temperature resampling
    man_paths = args.manifest.split(",")
    lang_groups = None
    if len(man_paths) > 1:
        man, lang_groups = concat_manifests([Manifest.load(p) for p in man_paths])
    else:
        man = Manifest.load(args.manifest)
    kw = dict(seed=args.seed, lang_groups=lang_groups, multilang_alpha=args.multilang_alpha,
              **_shard(args))
    if unispeech:
        texts = []
        for p in args.transcripts.split(","):
            texts.extend(pathlib.Path(p).read_text().splitlines())
        data = FinetuneIterator(man, _data_cfg(args), texts, d, **kw)
    else:
        data = PretrainIterator(man, _data_cfg(args), **kw)
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm,
                        stacked_update=args.stacked_optimizer)
    run_training(model, make_wav2vec2_loss_fn(model, mtlalpha=args.mtlalpha), optim,
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

    loop_cfg = _loop_cfg(args)
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
                            seed=args.seed, **_shard(args))

    valid_kw = {}
    if args.valid_manifest and args.valid_transcripts:
        vman = Manifest.load(args.valid_manifest)
        vtexts = pathlib.Path(args.valid_transcripts).read_text().splitlines()

        def valid_batches_fn():
            return FinetuneIterator(vman, _data_cfg(args), vtexts, d, seed=args.seed,
                                    **_shard(args)).epoch_batches(1)

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


def cmd_finetune_seq2seq(args) -> None:
    from unispeech_tpu_torch.configs import MaskConfig
    from unispeech_tpu_torch.data.dataset import Seq2SeqIterator
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.manifest import Manifest
    from unispeech_tpu_torch.models.ctc import load_pretrained_into
    from unispeech_tpu_torch.models.seq2seq import (
        Seq2SeqConfig,
        Seq2SeqDecoderConfig,
        Seq2SeqModel,
    )
    from unispeech_tpu_torch.train.loop import run_training
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.tasks import (
        make_seq2seq_loss_fn,
        make_seq2seq_valid_decode_fn,
    )

    loop_cfg = _loop_cfg(args)
    d = Dictionary.load(args.dict) if args.dict else Dictionary.letters()
    enc = _encoder(args, relative_position_embedding=not args.no_rel_pos,
                   gru_rel_pos=not args.no_rel_pos)
    dec = Seq2SeqDecoderConfig(vocab_size=len(d), embed_dim=args.decoder_embed_dim,
                               ffn_embed_dim=args.decoder_ffn_dim, layers=args.decoder_layers,
                               heads=args.decoder_heads, padding_idx=d.pad())
    if args.decoder_json:
        dec = dataclasses.replace(dec, **json.loads(args.decoder_json))
    cfg = Seq2SeqConfig(encoder=enc, decoder=dec, apply_mask=True,
                        time_mask=MaskConfig(mask_prob=args.mask_prob, mask_length=10),
                        freeze_finetune_updates=args.freeze_finetune_updates)
    model = Seq2SeqModel(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                         generator=torch.Generator().manual_seed(args.seed))
    if args.w2v_path:
        # a checkpoint in --checkpoint-dir, if any, replaces these weights
        load_pretrained_into(model, args.w2v_path)
    texts = pathlib.Path(args.transcripts).read_text().splitlines()
    data = Seq2SeqIterator(Manifest.load(args.manifest), _data_cfg(args), texts, d,
                           seed=args.seed, **_shard(args))
    valid_kw = {}
    if args.valid_manifest and args.valid_transcripts:
        vman = Manifest.load(args.valid_manifest)
        vtexts = pathlib.Path(args.valid_transcripts).read_text().splitlines()

        def valid_batches_fn():
            return Seq2SeqIterator(vman, _data_cfg(args), vtexts, d, seed=args.seed,
                                   **_shard(args)).epoch_batches(1)

        valid_kw = dict(
            valid_batches_fn=valid_batches_fn,
            eval_loss_fn=make_seq2seq_loss_fn(model, label_smoothing=args.label_smoothing,
                                              deterministic=True),
            valid_decode_fn=make_seq2seq_valid_decode_fn(
                model, d, max_len=args.valid_decode_max_len,
                post_process_symbol=args.post_process))
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm,
                        stacked_update=args.stacked_optimizer, schedule="tri_stage",
                        hold_steps=args.max_updates * 4 // 10)
    run_training(model, make_seq2seq_loss_fn(model, label_smoothing=args.label_smoothing),
                 optim, iter(data), loop_cfg, device=args.device, data_state=data, **valid_kw)


LM_CONFIG_KEYS = ("vocab_size", "embed_dim", "ffn_dim", "layers", "heads", "dropout",
                  "padding_idx", "max_positions", "learned_pos", "normalize_before",
                  "share_input_output_embed")


def cmd_train_lm(args) -> None:
    import os

    import torch.distributed as dist

    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.lm_dataset import (
        LMIterator,
        TokenBlockDataset,
        tokenize_corpus,
    )
    from unispeech_tpu_torch.models.lm import TransformerLM, TransformerLMConfig
    from unispeech_tpu_torch.train.loop import run_training
    from unispeech_tpu_torch.train.optim import OptimConfig
    from unispeech_tpu_torch.train.tasks import make_lm_loss_fn

    loop_cfg = _loop_cfg(args)
    d = Dictionary.load(args.dict)
    cfg = TransformerLMConfig(vocab_size=len(d), embed_dim=args.embed_dim, ffn_dim=args.ffn_dim,
                              layers=args.layers, heads=args.heads, padding_idx=d.pad(),
                              max_positions=max(args.block_size * 2, 2048))
    model = TransformerLM(cfg, dtype=torch.bfloat16 if args.bf16 else torch.float32,
                          generator=torch.Generator().manual_seed(args.seed))
    if args.corpus.endswith(".bin") or os.path.exists(args.corpus + ".idx.npz"):
        from unispeech_tpu_torch.data.indexed_dataset import MMapIndexedDataset

        stem = args.corpus[:-4] if args.corpus.endswith(".bin") else args.corpus
        tokens = MMapIndexedDataset(stem).flat
    else:
        tokens = tokenize_corpus(args.corpus, d)
    data = LMIterator(TokenBlockDataset(tokens, args.block_size),
                      batch_size=args.batch_size or 32, padding_idx=d.pad(), seed=args.seed,
                      **_shard(args))
    # decode --decoder neural reads the config from <stem>.json beside the
    # export, or from lm_config.json in the checkpoint directory
    cfg_json = {k: getattr(cfg, k) for k in LM_CONFIG_KEYS}
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        pathlib.Path(args.checkpoint_dir, "lm_config.json").write_text(json.dumps(cfg_json))
        if args.export_params:
            pathlib.Path(os.path.splitext(args.export_params)[0] + ".json").write_text(
                json.dumps(cfg_json))
    optim = OptimConfig(lr=args.lr, warmup_steps=args.warmup_steps,
                        total_steps=args.max_updates, clip_norm=args.clip_norm)
    run_training(model, make_lm_loss_fn(model, d.pad()), optim, iter(data), loop_cfg,
                 device=args.device, data_state=data)


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
                    help="UniSpeech-SAT speaker contrastive branch")
    ph.add_argument("--mixing-prob", type=float, default=0.0)
    ph.add_argument("--mixing-num", type=int, default=1)
    ph.add_argument("--noise-path", default=None,
                    help="noise store: a JSON list of h5py slices or a TSV audio manifest")
    ph.add_argument("--noise-prob", type=float, default=0.0,
                    help="probability a mix overlays noise instead of speech")
    ph.add_argument("--no-rel-pos", action="store_true")
    ph.set_defaults(fn=cmd_pretrain_hubert)

    pw = sub.add_parser("pretrain-wav2vec2")
    _common(pw)
    pw.add_argument("--mask-prob", type=float, default=0.65)
    pw.add_argument("--mtlalpha", type=float, default=0.0,
                    help=">0 adds the UniSpeech phonetic CTC multitask")
    pw.add_argument("--replace-prob", type=float, default=0.5)
    pw.add_argument("--dict", default=None, help="phone/letter dict of the UniSpeech CTC head")
    pw.add_argument("--transcripts", default=None,
                    help="transcripts, comma-separated per language when --manifest is")
    pw.add_argument("--multilang-alpha", type=float, default=1.0,
                    help="temperature resampling alpha over comma-separated manifests")
    pw.set_defaults(fn=cmd_pretrain_wav2vec2)

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

    fs = sub.add_parser("finetune-seq2seq")
    _common(fs)
    fs.add_argument("--transcripts", required=True,
                    help="one letter-format line per manifest row")
    fs.add_argument("--dict", default=None, help="target dictionary (letters by default)")
    fs.add_argument("--w2v-path", default=None, help="pretrained params .npz")
    fs.add_argument("--mask-prob", type=float, default=0.5)
    fs.add_argument("--freeze-finetune-updates", type=int, default=10_000)
    fs.add_argument("--no-rel-pos", action="store_true")
    fs.add_argument("--label-smoothing", type=float, default=0.1)
    fs.add_argument("--decoder-embed-dim", type=int, default=768)
    fs.add_argument("--decoder-ffn-dim", type=int, default=3072)
    fs.add_argument("--decoder-layers", type=int, default=6)
    fs.add_argument("--decoder-heads", type=int, default=4)
    fs.add_argument("--decoder-json", default=None,
                    help="JSON dict of Seq2SeqDecoderConfig overrides")
    fs.add_argument("--valid-transcripts", default=None,
                    help="dev transcripts; with --valid-manifest, greedy WER/UER at each "
                         "validation")
    fs.add_argument("--valid-decode-max-len", type=int, default=128)
    fs.add_argument("--best-metric", default="loss_avg", choices=["loss_avg", "wer", "uer"])
    fs.add_argument("--post-process", default="letter")
    fs.add_argument("--validate-interval-updates", type=int, default=None)
    fs.set_defaults(fn=cmd_finetune_seq2seq)

    lm = sub.add_parser("train-lm")
    lm.add_argument("--corpus", required=True,
                    help="tokenized text file, or a binarized stem / .bin")
    lm.add_argument("--dict", required=True, help="word/subword dictionary")
    lm.add_argument("--block-size", type=int, default=128)
    lm.add_argument("--batch-size", type=int, default=32)
    lm.add_argument("--embed-dim", type=int, default=512)
    lm.add_argument("--ffn-dim", type=int, default=2048)
    lm.add_argument("--layers", type=int, default=6)
    lm.add_argument("--heads", type=int, default=8)
    lm.add_argument("--checkpoint-dir", default="checkpoints")
    lm.add_argument("--max-updates", type=int, default=50_000)
    lm.add_argument("--lr", type=float, default=5e-4)
    lm.add_argument("--warmup-steps", type=int, default=4_000)
    lm.add_argument("--clip-norm", type=float, default=0.0)
    lm.add_argument("--seed", type=int, default=1)
    lm.add_argument("--log-interval", type=int, default=100)
    lm.add_argument("--save-interval-updates", type=int, default=10_000)
    lm.add_argument("--n-model", type=int, default=1,
                    help="model ranks (the LM's layers stay whole on each)")
    lm.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3 param sharding over the data ranks")
    lm.add_argument("--bf16", action="store_true", default=True)
    lm.add_argument("--tensorboard-dir", default=None)
    lm.add_argument("--accum-steps", type=int, default=1)
    lm.add_argument("--export-params", default=None)
    _launch(lm)
    lm.set_defaults(fn=cmd_train_lm)

    args = parser.parse_args(argv)
    # before anything else, so every process sees the whole mesh
    from unispeech_tpu_torch.parallel.bootstrap import maybe_initialize_distributed

    maybe_initialize_distributed(args.coordinator_address, args.num_processes,
                                 args.process_id, device=args.device)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
