"""Label pipeline CLI: ``python -m unispeech_tpu_torch.tools <subcommand>``.

  dump-features --feature model   transformer-layer features of a WavLM
                                  params .npz (the JAX package's checkpoint
                                  format), sharded over (nshard, rank) workers
                                  writing {split}_{rank}_{nshard}.npy/.len;
                                  --arch base|large picks WavLM-Base(+) or
                                  WavLM-Large's config, --encoder-json
                                  overrides its fields

Runs on the card unless ``--device cpu`` is given. MFCC features,
``learn-kmeans`` and ``dump-labels`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch


def _shard_rows(n: int, nshard: int, rank: int):
    """Reference shard split: ceil(n / nshard) rows per shard."""
    shard_size = math.ceil(n / nshard)
    start, end = rank * shard_size, min((rank + 1) * shard_size, n)
    if start >= end:
        raise ValueError(f"empty shard: start={start}, end={end}, tot={n}")
    return start, end


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run on the CPU)")
    return device


def _feature_fn(args):
    if args.feature != "model":
        raise NotImplementedError(f"--feature {args.feature} is not ported to PyTorch yet")
    if args.checkpoint is None:
        raise ValueError("--feature model needs --checkpoint")
    from unispeech_tpu_torch.configs import (
        WavLMModelConfig,
        base_encoder_config,
        large_encoder_config,
    )
    from unispeech_tpu_torch.convert.from_jax import (
        load_params_npz,
        wavlm_state_dict_from_jax,
    )
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.tools.kmeans import dump_model_features

    device = _device(args.device)
    enc_fn = base_encoder_config if args.arch == "base" else large_encoder_config
    enc = enc_fn(
        relative_position_embedding=True, gru_rel_pos=True,
        dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0,
    )
    if args.encoder_json:
        over = json.loads(args.encoder_json)
        if "conv_layers" in over:
            over["conv_layers"] = tuple(tuple(c) for c in over["conv_layers"])
        enc = dataclasses.replace(enc, **over)
    model = WavLM(WavLMModelConfig(encoder=enc), dtype=torch.bfloat16)
    model.load_state_dict(
        wavlm_state_dict_from_jax(load_params_npz(args.checkpoint), enc), strict=True)
    model.to(device).eval()

    def forward(x: np.ndarray) -> np.ndarray:
        wav = torch.from_numpy(x).to(device)
        out = model.extract_features(wav, output_layer=args.layer)
        return out.x.float()[0].cpu().numpy()

    def feats(wav):
        return next(dump_model_features(forward, [wav], max_chunk=args.max_chunk))

    return feats


def cmd_dump_features(args) -> None:
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio

    man = Manifest.load(args.manifest)
    start, end = _shard_rows(len(man), args.nshard, args.rank)
    print(f"rank {args.rank} of {args.nshard}: rows {start}-{end} of {len(man)}",
          file=sys.stderr)
    fn = _feature_fn(args)
    os.makedirs(args.feat_dir, exist_ok=True)
    stem = f"{args.split}_{args.rank}_{args.nshard}"
    feats, lens = [], []
    for i in range(start, end):
        f = np.asarray(fn(load_audio(man.abspath(i), 16_000)), np.float32)
        feats.append(f)
        lens.append(len(f))
    np.save(os.path.join(args.feat_dir, stem + ".npy"), np.concatenate(feats, axis=0))
    with open(os.path.join(args.feat_dir, stem + ".len"), "w") as lf:
        lf.write("\n".join(str(n) for n in lens) + "\n")


def _not_ported(args) -> None:
    raise NotImplementedError(f"{args.cmd} is not ported to PyTorch yet")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("unispeech_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    df = sub.add_parser("dump-features")
    df.add_argument("--manifest", required=True)
    df.add_argument("--split", default="train")
    df.add_argument("--nshard", type=int, default=1)
    df.add_argument("--rank", type=int, default=0)
    df.add_argument("--feat-dir", required=True)
    df.add_argument("--feature", choices=["mfcc", "model"], default="mfcc")
    df.add_argument("--checkpoint", default=None, help="model params .npz")
    df.add_argument("--layer", type=int, default=6,
                    help="1-based transformer layer for model features")
    df.add_argument("--arch", choices=["base", "large"], default="base")
    df.add_argument("--encoder-json", default=None)
    df.add_argument("--max-chunk", type=int, default=1_600_000)
    df.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    df.set_defaults(fn=cmd_dump_features)

    for name in ("learn-kmeans", "dump-labels"):
        sub.add_parser(name).set_defaults(fn=_not_ported)

    # the subcommands not ported yet take any flags and raise
    args, rest = p.parse_known_args(argv)
    if rest and args.fn is not _not_ported:
        p.error("unrecognized arguments: " + " ".join(rest))
    args.fn(args)


if __name__ == "__main__":
    main()
