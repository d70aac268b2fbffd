"""Data-prep CLI: ``python -m unispeech_tpu_torch.data <subcommand>``.

  manifest       walk a directory of audio files into train.tsv / valid.tsv
                 (first line the root, then "relpath\\tnum_samples" rows)
  binarize-text  tokenize a text corpus into the mmap format (<out>.bin,
                 <out>.idx.npz) that train-lm reads, optionally through a
                 text encoder (--encoder byte|char|bpe|sentencepiece)

The JAX package's other data-prep subcommands (``libri-labels``,
``resample``, ``cv-manifest``) are not ported yet: they take any flags and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import sys

from unispeech_tpu_torch.data.manifest import audio_num_samples

NOT_PORTED = ("libri-labels", "resample", "cv-manifest")


def cmd_manifest(args) -> None:
    if not 0.0 <= args.valid_percent <= 1.0:
        raise ValueError(f"--valid-percent {args.valid_percent} is not in [0, 1]")
    dir_path = os.path.realpath(args.root)
    search_path = os.path.join(dir_path, "**/*." + args.ext)
    rand = random.Random(args.seed)
    os.makedirs(args.dest, exist_ok=True)
    train_p = os.path.join(args.dest, "train.tsv")
    valid_p = os.path.join(args.dest, "valid.tsv")
    with open(train_p, "w") as train_f, open(valid_p, "w") as valid_f:
        print(dir_path, file=train_f)
        print(dir_path, file=valid_f)
        n = 0
        for fname in sorted(glob.iglob(search_path, recursive=True)):
            file_path = os.path.realpath(fname)
            if args.path_must_contain and args.path_must_contain not in file_path:
                continue
            frames = audio_num_samples(fname)
            dest = train_f if rand.random() > args.valid_percent else valid_f
            print(f"{os.path.relpath(file_path, dir_path)}\t{frames}", file=dest)
            n += 1
    print(f"indexed {n} files -> {train_p} / {valid_p}", file=sys.stderr)


def cmd_binarize_text(args) -> None:
    from unispeech_tpu_torch.data.dictionary import Dictionary
    from unispeech_tpu_torch.data.indexed_dataset import binarize_text
    from unispeech_tpu_torch.data.text_encoders import get_text_encoder

    d = Dictionary.load(args.dict)
    enc = get_text_encoder(args.encoder, bpe_codes=args.bpe_codes, spm_model=args.spm_model)
    n = binarize_text(args.corpus, d, args.out, append_eos=not args.no_append_eos,
                      encode=None if enc is None else enc.encode)
    print(f"binarized {n} sentences -> {args.out}.bin", file=sys.stderr)


def _not_ported(args) -> None:
    raise NotImplementedError(f"{args.cmd} is not ported to PyTorch yet")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("unispeech_tpu_torch.data")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("manifest")
    m.add_argument("root")
    m.add_argument("--valid-percent", type=float, default=0.01)
    m.add_argument("--dest", default=".")
    m.add_argument("--ext", default="flac")
    m.add_argument("--seed", type=int, default=42)
    m.add_argument("--path-must-contain", default=None)
    m.set_defaults(fn=cmd_manifest)

    b = sub.add_parser("binarize-text")
    b.add_argument("--corpus", required=True)
    b.add_argument("--dict", required=True)
    b.add_argument("--out", required=True, help="output stem (.bin/.idx.npz)")
    b.add_argument("--no-append-eos", action="store_true")
    b.add_argument("--encoder", default="none",
                   choices=["none", "byte", "char", "bpe", "sentencepiece"],
                   help="text encoder applied to each line before binarization")
    b.add_argument("--bpe-codes", default=None, help="subword-nmt codes file (--encoder bpe)")
    b.add_argument("--spm-model", default=None,
                   help="sentencepiece model (--encoder sentencepiece)")
    b.set_defaults(fn=cmd_binarize_text)

    for name in NOT_PORTED:
        sub.add_parser(name).set_defaults(fn=_not_ported)

    # the subcommands not ported yet take any flags and raise
    args, rest = p.parse_known_args(argv)
    if rest and args.fn is not _not_ported:
        p.error("unrecognized arguments: " + " ".join(rest))
    args.fn(args)


if __name__ == "__main__":
    main()
