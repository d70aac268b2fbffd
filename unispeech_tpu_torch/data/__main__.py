"""Data-prep CLI: ``python -m unispeech_tpu_torch.data <subcommand>``.

  manifest       walk a directory of audio files into train.tsv / valid.tsv
                 (first line the root, then "relpath\\tnum_samples" rows)
  libri-labels   LibriSpeech transcripts of a manifest's rows as <name>.wrd
                 (words) and <name>.ltr (letters, "|" between words)
  resample       audio files of a list to 16-bit mono wav at --rate (scipy's
                 polyphase resample_poly), with their manifest
  cv-manifest    a CommonVoice tsv to <stem>.list (clip names) and
                 <stem>.text (clip name, tab, sentence)
  binarize-text  tokenize a text corpus into the mmap format (<out>.bin,
                 <out>.idx.npz) that train-lm reads, optionally through a
                 text encoder (--encoder byte|char|bpe|sentencepiece)

Each writes the same files as the JAX package's subcommand of that name.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import sys

from unispeech_tpu_torch.data.manifest import audio_num_samples


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


def cmd_libri_labels(args) -> None:
    """Each row's transcript from its directory's
    ``{speaker}-{chapter}.trans.txt``."""
    os.makedirs(args.output_dir, exist_ok=True)
    transcriptions = {}
    stem = os.path.join(args.output_dir, args.output_name)
    with open(args.tsv) as tsv, open(stem + ".ltr", "w") as ltr_out, \
            open(stem + ".wrd", "w") as wrd_out:
        root = next(tsv).strip()
        for line in tsv:
            line = line.strip().split("\t")[0]
            if not line:
                continue
            d = os.path.dirname(line)
            if d not in transcriptions:
                parts = d.split(os.path.sep)
                path = os.path.join(root, d, f"{parts[-2]}-{parts[-1]}.trans.txt")
                if not os.path.exists(path):
                    raise FileNotFoundError(path)
                texts = {}
                with open(path) as trans_f:
                    for tline in trans_f:
                        items = tline.strip().split()
                        texts[items[0]] = " ".join(items[1:])
                transcriptions[d] = texts
            part = os.path.basename(line).split(".")[0]
            if part not in transcriptions[d]:
                raise KeyError(f"{part} has no transcript in {d}")
            print(transcriptions[d][part], file=wrd_out)
            print(" ".join(list(transcriptions[d][part].replace(" ", "|"))) + " |",
                  file=ltr_out)


def _write_wav(path: str, samples, rate: int) -> None:
    """16-bit mono PCM wav of fp32 samples in [-1, 1]."""
    import wave

    import numpy as np

    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def cmd_resample(args) -> None:
    """Each listed file not yet converted is read, resampled to --rate when
    its rate differs, and written as ``<stem>.wav`` under --dest-path; the
    manifest lists every converted file (missing sources are skipped)."""
    from math import gcd

    import numpy as np
    from scipy.signal import resample_poly

    from unispeech_tpu_torch.data.manifest import load_audio

    os.makedirs(args.dest_path, exist_ok=True)
    with open(args.input) as f:
        names = [l.strip() for l in f if l.strip()]
    with open(args.output, "w") as wf:
        wf.write(os.path.realpath(args.dest_path) + "\n")
        for i, wav_name in enumerate(names):
            src = os.path.join(args.wav_path, wav_name)
            base = os.path.splitext(wav_name)[0] + ".wav"
            dst = os.path.join(args.dest_path, base)
            if not os.path.exists(src):
                continue
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            if not os.path.exists(dst):
                y, sr = load_audio(src, return_rate=True)
                if sr != args.rate:
                    g = gcd(args.rate, sr)
                    y = resample_poly(y, args.rate // g, sr // g)
                _write_wav(dst, np.asarray(y, np.float32), args.rate)
            wf.write(f"{base}\t{audio_num_samples(dst)}\n")
            if (i + 1) % 100 == 0:
                print(f"process {i + 1} done", file=sys.stderr)


def cmd_cv_manifest(args) -> None:
    wav_names, text = [], []
    with open(args.input) as f:
        f.readline()
        for line in f:
            items = line.strip().split("\t")
            wav_names.append(items[1])
            text.append(items[2])
    base = os.path.splitext(os.path.basename(args.input))[0]
    os.makedirs(args.dest, exist_ok=True)
    with open(os.path.join(args.dest, base + ".list"), "w") as f:
        for name in wav_names:
            f.write(name + "\n")
    with open(os.path.join(args.dest, base + ".text"), "w") as f:
        for name, t in zip(wav_names, text):
            f.write(f"{name}\t{t}\n")


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

    l = sub.add_parser("libri-labels")
    l.add_argument("tsv")
    l.add_argument("--output-dir", required=True)
    l.add_argument("--output-name", required=True)
    l.set_defaults(fn=cmd_libri_labels)

    r = sub.add_parser("resample")
    r.add_argument("--wav-path", required=True)
    r.add_argument("--dest-path", required=True)
    r.add_argument("--input", required=True, help="file list, one per line")
    r.add_argument("--output", required=True, help="output manifest TSV")
    r.add_argument("--rate", type=int, default=16_000)
    r.set_defaults(fn=cmd_resample)

    c = sub.add_parser("cv-manifest")
    c.add_argument("input")
    c.add_argument("--dest", required=True)
    c.set_defaults(fn=cmd_cv_manifest)

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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
