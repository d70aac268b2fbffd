"""Label pipeline CLI: ``python -m unispeech_tpu_torch.tools <subcommand>``.

Feature dumps are sharded over (nshard, rank) workers writing
{split}_{rank}_{nshard}.npy/.len, k-means learns from the dumped shards, and
label dumps write {split}_{rank}_{nshard}.km (one line per utterance;
concatenate shards with ``cat``).

  dump-features   MFCC-39 (--feature mfcc) or the transformer-layer features
                  of a WavLM params .npz in the JAX package's checkpoint
                  format (--feature model; --arch base|large picks
                  WavLM-Base(+) or WavLM-Large's config, --encoder-json
                  overrides its fields; a pretraining export, the backbone
                  under "wavlm", loads too)
  learn-kmeans    mini-batch k-means++ on the dumped shards -> centroids .npy
  dump-labels     nearest-centroid frame labels of the same features

Model features and k-means run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
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


def _feature_fn(args):
    from unispeech_tpu_torch.tools.kmeans import mfcc_39
    from unispeech_tpu_torch.utils.device import device_or_raise

    device = device_or_raise(args.device)
    if args.feature == "mfcc":
        return mfcc_39
    if args.checkpoint is None:
        raise ValueError("--feature model needs --checkpoint")
    from unispeech_tpu_torch.configs import (
        WavLMModelConfig,
        base_encoder_config,
        large_encoder_config,
        override_encoder,
    )
    from unispeech_tpu_torch.convert.from_jax import (
        load_params_npz,
        wavlm_state_dict_from_jax,
    )
    from unispeech_tpu_torch.models.wavlm import WavLM
    from unispeech_tpu_torch.tools.kmeans import dump_model_features

    enc_fn = base_encoder_config if args.arch == "base" else large_encoder_config
    enc = enc_fn(
        relative_position_embedding=True, gru_rel_pos=True,
        dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0,
    )
    enc = override_encoder(enc, args.encoder_json)
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


def cmd_learn_kmeans(args) -> None:
    from unispeech_tpu_torch.tools.kmeans import learn_kmeans

    feats = []
    rng = np.random.default_rng(args.seed)
    for rank in range(args.nshard):
        stem = f"{args.split}_{rank}_{args.nshard}"
        x = np.load(os.path.join(args.feat_dir, stem + ".npy"))
        if args.percent < 1.0:
            x = x[rng.random(len(x)) < args.percent]
        feats.append(x)
    print(f"learning k-means on {sum(len(x) for x in feats)} frames", file=sys.stderr)
    km = learn_kmeans(feats, n_clusters=args.n_clusters, seed=args.seed, epochs=args.epochs,
                      device=args.device)
    km.save(args.km_path)


def cmd_dump_labels(args) -> None:
    from unispeech_tpu_torch.data.manifest import Manifest, load_audio
    from unispeech_tpu_torch.tools.kmeans import KmeansModel, apply_kmeans, write_label_file

    man = Manifest.load(args.manifest)
    start, end = _shard_rows(len(man), args.nshard, args.rank)
    km = KmeansModel.load(args.km_path)
    fn = _feature_fn(args)
    os.makedirs(args.lab_dir, exist_ok=True)
    stem = f"{args.split}_{args.rank}_{args.nshard}"
    write_label_file(
        os.path.join(args.lab_dir, stem + ".km"),
        (apply_kmeans(km, np.asarray(fn(load_audio(man.abspath(i), 16_000)), np.float32),
                      device=args.device) for i in range(start, end)))


def _feature_args(p) -> None:
    p.add_argument("--feature", choices=["mfcc", "model"], default="mfcc")
    p.add_argument("--checkpoint", default=None, help="model params .npz")
    p.add_argument("--layer", type=int, default=6,
                   help="1-based transformer layer for model features")
    p.add_argument("--arch", choices=["base", "large"], default="base")
    p.add_argument("--encoder-json", default=None)
    p.add_argument("--max-chunk", type=int, default=1_600_000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("unispeech_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    df = sub.add_parser("dump-features")
    df.add_argument("--manifest", required=True)
    df.add_argument("--split", default="train")
    df.add_argument("--nshard", type=int, default=1)
    df.add_argument("--rank", type=int, default=0)
    df.add_argument("--feat-dir", required=True)
    _feature_args(df)
    df.set_defaults(fn=cmd_dump_features)

    lk = sub.add_parser("learn-kmeans")
    lk.add_argument("--feat-dir", required=True)
    lk.add_argument("--split", default="train")
    lk.add_argument("--nshard", type=int, default=1)
    lk.add_argument("--n-clusters", type=int, default=100)
    lk.add_argument("--percent", type=float, default=1.0,
                    help="fraction of frames to sample")
    lk.add_argument("--epochs", type=int, default=2)
    lk.add_argument("--seed", type=int, default=0)
    lk.add_argument("--km-path", required=True)
    lk.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    lk.set_defaults(fn=cmd_learn_kmeans)

    dl = sub.add_parser("dump-labels")
    dl.add_argument("--manifest", required=True)
    dl.add_argument("--split", default="train")
    dl.add_argument("--nshard", type=int, default=1)
    dl.add_argument("--rank", type=int, default=0)
    dl.add_argument("--km-path", required=True)
    dl.add_argument("--lab-dir", required=True)
    _feature_args(dl)
    dl.set_defaults(fn=cmd_dump_labels)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
